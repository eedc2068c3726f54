"""The readings the limits of ``correct`` are set from, at a cell's own
size, on the card (the benchmark's runs never run this):

* ``sound``: the program's checked rounds against the reference (the
  lower readings, a dozen seeds or more);
* ``control``: the program with its own path one precision below the
  float32 resident state the configuration states switched on:
  ``CommConfig.state_dtype="bfloat16"`` (the packed model between
  rounds and the Sophia m and h stored in bfloat16), the step that
  would tempt a change to the memory-bound optimiser passes;
* ``fp8``: the reference in the program's place with its products one
  precision below the configuration's bfloat16 (`fp8_model` of the
  arch's ``Model``), the step that would tempt a change to the GEMMs;
* ``half_batch``: the program with half of each batch left out, the
  mean taken over the rest (the loss and the GNB's loss alike).

A step that returns its state unchanged reads 1 in ``change_gap`` (and
in ``grad_gap``, ``gnb_gap``: m and h stay zero) and needs no run.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \\
        --control-seeds 1 2 3 --fp8-seeds 4 5 6 --fault-seeds 7 8 9

One JSON line a seed on standard output.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from portbench import cells, check, harness  # noqa: E402


def e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (its
    absolute maximum at 448), in ``t``'s dtype; the gradient passes as
    if unrounded."""
    s = t.detach().abs().amax().clamp(min=1e-30) / 448
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(t.dtype) * s
    return t + (q - t.detach())


def fp8_model(model: type) -> type:
    """The reference ``model`` (an arch's ``Model``, every linear product
    through its ``lin``) with each product in float8: both operands
    rounded to e4m3 (`e4m3`), the product in float32; the backward's
    products take the rounded operands."""
    return type(f"Fp8{model.__name__}", (model,),
                {"lin": staticmethod(lambda x, w: e4m3(x) @ e4m3(w))})


def half_batch(prog: harness.Program) -> None:
    """Plant the half-batch fault: the task's losses see only the first
    half of each batch (tokens, labels and the GNB's draws)."""
    task = prog.engine.task
    loss, sampled = task.loss, task.sampled_loss

    def half(batch):
        B = batch["labels"].shape[-2]
        return {k: v.narrow(-2, 0, B // 2) for k, v in batch.items()}

    task.loss = lambda p, b, rng=None: loss(p, half(b))
    task.sampled_loss = lambda p, b, g: sampled(
        p, half(b), g.narrow(-3, 0, g.shape[-3] // 2))


def bf16_state(prog: harness.Program) -> None:
    """Switch on the control: the program's resident state in bfloat16."""
    from repro_torch.core.fed import FedEngine
    eng = prog.engine
    comm = dataclasses.replace(eng.fed.comm, state_dtype="bfloat16")
    prog.engine = FedEngine(eng.task, dataclasses.replace(eng.fed, comm=comm),
                            device=eng.device)


def readings(bench: cells.Bench, name: str, seeds, control_seeds,
             fault_seeds, device, fp8_seeds=()):
    """Yield one dict of readings a seed."""
    cell = bench.workload(name)
    conf_json = bench.config(cell["config"])
    tr = bench.traffic(cell["traffic"])
    conf = bench.arch(conf_json).from_json(conf_json)
    for seed in dict.fromkeys(list(seeds) + list(control_seeds)
                              + list(fault_seeds) + list(fp8_seeds)):
        t0 = time.perf_counter()
        inputs = harness.Inputs(conf, tr, seed, device)
        out = {"seed": seed}
        progs = {}
        if seed in seeds:
            progs["sound"] = None
        if seed in control_seeds:
            progs["control"] = bf16_state
        if seed in fault_seeds:
            progs["half_batch"] = half_batch
        reads = {}
        for label, hook in progs.items():
            prog = harness.Program(conf_json, tr, device, bench)
            if hook:
                hook(prog)
            tokens, labels = inputs.pool()
            state, reads[label] = harness.checked_rounds(prog, inputs,
                                                         tokens, labels)
            del state, prog, tokens, labels
            harness.empty_cache(device)
        if seed in fp8_seeds:
            reads["fp8"] = harness.reference_readout(
                conf, tr, inputs, model=fp8_model(cells.arch_of(conf).Model),
                keep=True)
            harness.empty_cache(device)
        ref = harness.reference_readout(conf, tr, inputs,
                                        others=list(reads.values()))
        harness.empty_cache(device)
        for label, rd in reads.items():
            out[label] = check.compare(rd, ref)
            out[label + ".leaves"] = check.leaf_distances(rd, ref)
        out["seconds"] = time.perf_counter() - t0
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fp8-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs an NVIDIA card", file=sys.stderr)
        return 2
    for rd in readings(cells.Bench(ROOT), args.workload, args.seeds,
                       args.control_seeds, args.fault_seeds,
                       torch.device("cuda", 0), args.fp8_seeds):
        print(json.dumps(rd), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
