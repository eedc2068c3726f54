#!/usr/bin/env python3
"""Two checkouts of this repository against each other on one card, in
turns there and back (A, B, B, A): each kernel entry's host milliseconds
per call, the steady seconds per round of the MLP main path, the steady
seconds, busy share and peak of the LM phases of `LM_AB` with per-block
remat on and off (a checkout whose model has no remat runs each once,
labelled off), and repeats of one reduced LM card-against-CPU check
with the distance of its h buffer to the band; then that check again
with the CPU side on one thread and the card's deterministic algorithms
(turns B, A).

    python3 ab_rounds.py [--mlp] CHECKOUT_A [CHECKOUT_B]

CHECKOUT_B defaults to the checkout that holds this script.  Each turn is
a process of its own, started in the checkout, that imports the
checkout's own ``chip_smoke.py`` and package and builds its kernels:
``chip_smoke.time_kernels`` for the host milliseconds (its ``host ...
ms per call``), `drive` of the MLP-128 main path for `MLP_ROUNDS`
rounds and of its sequential strategy for `MLP_SEQ_ROUNDS`, each phase of `LM_AB` with `LM_ROUNDS` rounds (remat off through
the trainer's ``cfg`` hook), and `lm_small_case` of `SMALL_CASE`
`SMALL_REPEATS` times.  Every check keeps its band: a run
that falls outside it is recorded as a failure with its message, and the
run goes on.  Prints one table per measurement, the card's name and power
limit, and writes every turn's record to ``chiprun_out/ab_rounds.json``.
``--mlp`` runs the MLP-128 rounds alone, in the same four turns.  Exits
nonzero without a card or if a turn fails.
"""
from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
MLP_ROUNDS = 12
MLP_SEQ_ROUNDS = 4
LM_ROUNDS = 5
#: the LM phases timed with remat on and off: minicpm-2b x 2 (C=4) and
#: hubert-xlarge x 48 (C=2, int8), the deepest stack
LM_AB = ("lm_train", "lm_enc")
SMALL_CASE = "xlstm-1.3b parallel"
SMALL_REPEATS = 2
DET_REPEATS = 3
MARK = "AB_TURN "


def _h_margin(c, want, got, free):
    """Over the h buffer, outside the sLSTM's free coordinates: the
    largest distance to the CPU's value in units of the small band, and
    the count of coordinates past it."""
    import numpy as np
    w, g = want["h"], got["h"]
    r = np.abs(g - w) / (c.SMALL_ATOL + c.SMALL_RTOL * np.abs(w))
    if free is not None and len(free):
        r = r.reshape(w.shape[0], -1).copy()
        r[:, free] = 0.0
    return float(r.max()), int((r > 1.0).sum())


def _small_runs(c, device, repeats):
    """`SMALL_CASE` ``repeats`` times: per run and round the h margin,
    digests of the CPU's and the card's h and params, and any failure
    (of the band, or of the run's other checks: ``"run"``)."""
    import hashlib

    def digest(a):
        return hashlib.sha1(a.tobytes()).hexdigest()[:12]
    runs, orig = [], c.flip_band

    def recording(label, want, got, steps, free=None):
        h_max, h_out = _h_margin(c, want, got, free)
        rnd = {"h_band_ratio": h_max, "h_out": h_out,
               "cpu": digest(want["h"]) + "/" + digest(want["params"]),
               "card": digest(got["h"]) + "/" + digest(got["params"])}
        try:
            orig(label, want, got, steps, free)
        except SystemExit as e:
            rnd["failed"] = str(e)[:300]
        runs[-1].append(rnd)
        return {}
    c.flip_band = recording
    try:
        for _ in range(repeats):
            runs.append([])
            try:
                c.lm_small_case(device, SMALL_CASE)
            except (AssertionError, SystemExit) as e:
                runs[-1].append({"run": str(e)[:300], "failed": True})
    finally:
        c.flip_band = orig
    return runs


def _remat_modes():
    """(True, False) where the checkout's model takes ``remat``, else
    (False,): it keeps every block's activations."""
    from repro_torch.models import transformer
    if "remat" in inspect.signature(transformer.forward).parameters:
        return (True, False)
    return (False,)


def _lm_run(c, label, device, remat):
    """``c.lm_phase(label)`` with the trainer's configs at ``train_remat =
    remat``: its steady seconds per round, the profiled round's busy
    share and the first run's peak, read from its output.  A checkout
    without remat (``remat`` False only) runs the phase as it is."""
    import contextlib
    import dataclasses
    import io
    import re
    kw = ({"hooks": {"cfg": lambda cfg: dataclasses.replace(
        cfg, train_remat=remat)}}
          if "hooks" in inspect.signature(c.lm_phase).parameters else {})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        c.lm_phase(label, device, **kw)
    out = buf.getvalue()
    num = r"([0-9.e+-]+)"
    steady = re.search(rf"{label}: .*steady seconds per round \(rounds "
                       rf"[0-9-]+\) {num}; peak device memory {num}", out)
    busy = re.search(rf"busy share of the unprofiled steady round {num}",
                     out)
    return {"steady_s": float(steady[1]), "peak": int(steady[2]),
            "busy": float(busy[1])}


def turn_main(mode: str) -> None:
    """One turn, in the current directory's checkout."""
    import contextlib
    import io
    import re
    import warnings
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as c
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c.build.build_all()
    rec = {"mode": mode, "checkout": os.getcwd(), "host_ms": {}, "lm": {}}
    if mode == "det":
        torch.set_num_threads(1)
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rec["small"] = _small_runs(c, device, DET_REPEATS)
        rec["det_warnings"] = sorted({str(w.message)[:200]
                                      for w in caught})
        print(MARK + json.dumps(rec), flush=True)
        return

    if mode == "timed":
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            c.time_kernels(device)
        line = re.compile(r"^(.*?) \(([0-9, ]+)\) fp32: device kernel .*"
                          r"host ([0-9.e+-]+) ms per call")
        rec["host_ms"] = {f"{m[1]} ({m[2]})": float(m[3]) for m in
                          map(line.match, buf.getvalue().splitlines()) if m}

    data = c.make_data(device)
    mlp = c.MLPTask(hidden=c.mlp_mnist.HIDDEN)
    leafy = "sophia_update_leaves" in c.REPLACES
    for strategy, rounds, clients in (("parallel", MLP_ROUNDS, 1),
                                      ("sequential", MLP_SEQ_ROUNDS,
                                       c.CLIENTS)):
        fed = c.FedConfig(strategy=strategy, num_clients=c.CLIENTS,
                          local_iters=c.LOCAL_ITERS, tau=c.TAU,
                          lr=c.SOPHIA_LR, optimizer="fed_sophia")
        # each checkout's own Sophia entry: the leaf route where it has one
        entry = ("sophia_update_leaves" if leafy else "sophia_update_"
                 + ("batched" if strategy == "parallel" else "flat"))
        with contextlib.redirect_stdout(io.StringIO()):
            *_, secs = c.drive("mlp", mlp, fed, data, rounds, device,
                               c.expect(**{entry: rounds * clients
                                           * c.LOCAL_ITERS}))
        key = "mlp" if strategy == "parallel" else "mlp_seq"
        rec[key + "_s"] = secs
        rec[key + "_steady_s"] = sum(secs[1:]) / len(secs[1:])
    del data
    if mode == "mlp":
        print(MARK + json.dumps(rec), flush=True)
        return

    c.LM_ROUNDS = LM_ROUNDS
    rec["lm"] = {}
    for label in LM_AB:
        for remat in _remat_modes():
            rec["lm"][f"{label} remat {'on' if remat else 'off'}"] = (
                _lm_run(c, label, device, remat))
    rec["small"] = _small_runs(c, device, SMALL_REPEATS)
    print(MARK + json.dumps(rec), flush=True)


def run_turn(checkout: Path, mode: str) -> dict:
    env = dict(os.environ)
    if mode == "det":
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--turn", mode], cwd=checkout, env=env,
                          capture_output=True, text=True, timeout=1500)
    recs = [json.loads(ln[len(MARK):]) for ln in proc.stdout.splitlines()
            if ln.startswith(MARK)]
    if proc.returncode != 0 or not recs:
        raise SystemExit(f"turn {mode} in {checkout} failed "
                         f"({proc.returncode}):\n{proc.stdout[-4000:]}\n"
                         f"{proc.stderr[-4000:]}")
    return recs[0]


def main() -> None:
    import torch
    args = sys.argv[1:]
    if args[:1] == ["--turn"]:
        turn_main(args[1])
        return
    if not torch.cuda.is_available():
        raise SystemExit("ab_rounds: needs an NVIDIA card")
    mlp_only = args[:1] == ["--mlp"]
    paths = [Path(a).resolve() for a in args[mlp_only:]]
    if len(paths) == 1:
        paths.append(HERE)
    names = "AB"
    mode = "mlp" if mlp_only else "timed"
    order = [(0, mode), (1, mode), (1, mode), (0, mode)] + (
        [] if mlp_only else [(1, "det"), (0, "det")])
    turns = []
    for j, turn_mode in order:
        rec = run_turn(paths[j], turn_mode)
        rec["name"] = names[j]
        turns.append(rec)
        print(f"turn {names[j]} {turn_mode} done", flush=True)
    for name, path in zip(names, paths):
        print(f"{name} = {path}")
    timed = [t for t in turns if t["mode"] == mode]
    labels = list(dict.fromkeys(k for t in timed for k in t["host_ms"]))
    print("host ms per call | " + " | ".join(t["name"] for t in timed))
    for k in labels:
        print(f"{k} | " + " | ".join(
            str(t["host_ms"].get(k, "-")) for t in timed))
    for key in ("mlp_steady_s", "mlp_seq_steady_s"):
        print(f"{key} | " + " | ".join(f"{t['name']} {t[key]}"
                                       for t in timed))
    runs = list(dict.fromkeys(k for t in timed for k in t["lm"]))
    print("LM phase | " + " | ".join(t["name"] for t in timed)
          + " (steady s, busy share, peak bytes)")
    for k in runs:
        print(f"{k} | " + " | ".join(
            "-" if k not in t["lm"] else
            f"{t['lm'][k]['steady_s']}, {t['lm'][k]['busy']}, "
            f"{t['lm'][k]['peak']}" for t in timed))
    for t in turns:
        for i, run in enumerate(t.get("small", ())):
            print(f"{SMALL_CASE} {t['name']} {t['mode']} run {i}: "
                  + "; ".join(
                      f"run check failed: {x['run']}" if "run" in x else
                      f"round {r}: h at {x['h_band_ratio']} of the band, "
                      f"{x['h_out']} past, cpu {x['cpu']}, card {x['card']}"
                      + (" FAILED" if "failed" in x else "")
                      for r, x in enumerate(run)))
        if t.get("det_warnings"):
            print(f"{t['name']} det warnings: {t['det_warnings']}")
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab_rounds.json").write_text(json.dumps(turns, indent=1))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
