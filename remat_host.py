#!/usr/bin/env python3
"""Where the host's time goes in a round with per-block remat, on the
card: for each LM phase of `PHASES` (``chip_smoke.py``'s phases, at their
depth, clients, batch and sequence), with ``train_remat`` on and off,
the trainer's CLI (``repro_torch.launch.train.main``, remat set through
its ``cfg`` hook) runs `WARM` rounds; then, on the state it returns,

* `TIMED` rounds on the host clock after a synchronise (steady seconds);
* one round with timers on the non-reentrant checkpoint's parts
  (`HookTimers`): the forward's checkpoint calls less the blocks they
  run (frame bookkeeping), the forward's saved-tensor pack hooks, the
  recompute (its block's ops and its own pack hooks, apart) and the
  backward's unpack hooks less the recompute they start;
* one round under `torch.profiler` with CPU and CUDA activities: the
  host's ATen op calls and kernel launches, and the device's busy time.

Prints one line per run and one JSON record per phase, beside the card's
name and power limit, and writes them to ``chiprun_out/remat_host.json``.

    python3 remat_host.py [PHASE ...]

Needs one card; exits nonzero without one.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import tempfile
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
#: the host-bound phase (sLSTM's per-step loop) and the deepest stack
PHASES = ("lm_xlstm", "lm_enc")
WARM, TIMED = 2, 3


class HookTimers:
    """Seconds and calls of each part of `torch.utils.checkpoint`'s
    non-reentrant path while entered, on any thread (the backward's hooks
    run on autograd's device thread): ``checkpoint`` (the forward's
    calls, the block inside them included), ``block`` (the block's own
    function in the forward), ``pack`` (the forward's pack hooks),
    ``recompute`` (each frame's recompute, its pack hooks included),
    ``recompute_pack`` and ``unpack`` (the recompute it starts
    included)."""

    def __init__(self):
        self.s = {}
        self.n = {}
        self.lock = threading.Lock()

    def add(self, key, dt):
        with self.lock:
            self.s[key] = self.s.get(key, 0.0) + dt
            self.n[key] = self.n.get(key, 0) + 1

    def timed(self, key, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.add(key, time.perf_counter() - t0)
        return run

    def __enter__(self):
        from torch.autograd import graph
        from torch.utils import checkpoint as ck
        self.saved = (graph.saved_tensors_hooks.__init__,
                      ck._run_fn_with_dynamo_disabled, ck.checkpoint)
        init, run_fn, checkpoint = self.saved
        timers = self
        names = {ck._checkpoint_hook: ("pack", "unpack"),
                 ck._recomputation_hook: ("recompute_pack", None)}

        def hooks_init(hook_self, pack, unpack):
            pack_key, unpack_key = names.get(type(hook_self), (None, None))
            if pack_key:
                pack = timers.timed(pack_key, pack)
            if unpack_key:
                unpack = timers.timed(unpack_key, unpack)
            init(hook_self, pack, unpack)

        def timed_checkpoint(fn, *args, **kw):
            forward = [True]

            def block(*a, **k):
                if not forward[0]:
                    return fn(*a, **k)
                return timers.timed("block", fn)(*a, **k)
            try:
                return timers.timed("checkpoint", checkpoint)(block, *args,
                                                              **kw)
            finally:
                forward[0] = False
        graph.saved_tensors_hooks.__init__ = hooks_init
        ck._run_fn_with_dynamo_disabled = self.timed("recompute", run_fn)
        ck.checkpoint = timed_checkpoint
        return self

    def __exit__(self, *exc):
        from torch.autograd import graph
        from torch.utils import checkpoint as ck
        (graph.saved_tensors_hooks.__init__,
         ck._run_fn_with_dynamo_disabled, ck.checkpoint) = self.saved

    def split(self):
        """Seconds of each part, the nested ones taken out of their
        parents: frame bookkeeping, forward pack hooks, the recompute's
        ops (its block, without its pack hooks), recompute pack hooks,
        unpack hooks (without the recompute); with each part's calls."""
        s = self.s.get
        parts = {
            "frame_bookkeeping": s("checkpoint", 0.0) - s("block", 0.0),
            "forward_pack_hooks": s("pack", 0.0),
            "recompute_ops": s("recompute", 0.0) - s("recompute_pack", 0.0),
            "recompute_pack_hooks": s("recompute_pack", 0.0),
            "unpack_hooks": s("unpack", 0.0) - s("recompute", 0.0)}
        return parts, dict(self.n)


def host_profile(run):
    """``run()`` under `torch.profiler` (CPU and CUDA activities): the
    host's ATen op calls (nested ones too), kernel launch calls, the
    device's busy microseconds and the round's seconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    aten = launches = 0
    busy = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                busy += e.time_range.elapsed_us()
        elif e.name.startswith("aten::"):
            aten += 1
        elif e.name.startswith("cudaLaunchKernel"):
            launches += 1
    return {"profiled_s": wall, "aten_calls": aten,
            "kernel_launch_calls": launches, "device_busy_us": busy}


def run_phase(c, label, device, remat):
    import torch
    from repro_torch.launch import train
    arch, layers, _, _, clients, flags, _ = c.LM_PHASES[label]
    with tempfile.TemporaryDirectory(prefix=f"{label}_") as tmp:
        res = train.main(
            c.lm_argv(arch, layers, clients, Path(tmp) / "ckpt", WARM,
                      *flags),
            hooks={"cfg": lambda cfg: dataclasses.replace(
                cfg, train_remat=remat)})
    engine, state = res["engine"], res["state"]
    batches = c.lm_batches(engine.task.cfg, c.gen(device, c.SEED + 7),
                           clients, c.LM_BATCH, c.LM_SEQ, device)

    def round_():
        engine.round(state, batches, generator=c.gen(device, c.SEED + 8))
    secs = []
    for _ in range(TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        round_()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    with HookTimers() as timers:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        round_()
        torch.cuda.synchronize()
        hooked = time.perf_counter() - t0
    parts, calls = timers.split()
    rec = {"remat": remat, "steady_s": sum(secs) / len(secs),
           "rounds_s": secs, "timed_round_s": hooked, "parts_s": parts,
           "calls": calls, **host_profile(round_)}
    rec["busy_share"] = rec["device_busy_us"] / (rec["steady_s"] * 1e6)
    del res, engine, state, batches
    torch.cuda.empty_cache()
    return rec


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("remat_host: needs an NVIDIA card")
    sys.path.insert(0, str(HERE))
    import chip_smoke as c
    from repro_torch.kernels import build
    build.build_all()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = c.card_info()
    out = {"card": card, "phases": {}}
    for label in sys.argv[1:] or PHASES:
        recs = [run_phase(c, label, device, remat)
                for remat in (True, False)]
        on, off = recs
        for r in recs:
            print(f"{label} remat {'on' if r['remat'] else 'off'}: steady "
                  f"{r['steady_s']} s a round {r['rounds_s']}; round with "
                  f"hook timers {r['timed_round_s']} s, parts "
                  f"{r['parts_s']}, calls {r['calls']}; profiled round "
                  f"{r['profiled_s']} s, {r['aten_calls']} ATen calls, "
                  f"{r['kernel_launch_calls']} kernel launches, device busy "
                  f"{r['device_busy_us']} us (share {r['busy_share']}); "
                  f"{card}", flush=True)
        extra = on["steady_s"] - off["steady_s"]
        print(f"{label}: remat adds {extra} s a round; of it the "
              f"checkpoint's parts (timed round) "
              f"{ {k: v / extra for k, v in on['parts_s'].items()} }; "
              f"ATen calls {off['aten_calls']} -> {on['aten_calls']}, "
              f"device busy {off['device_busy_us']} -> "
              f"{on['device_busy_us']} us; {card}", flush=True)
        out["phases"][label] = recs
    dest = HERE / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "remat_host.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
