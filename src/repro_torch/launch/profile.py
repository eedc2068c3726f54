"""Dry-run profiler: trace one (arch x shape) combination on one card
(`dryrun.trace`, no card needed) and print its roofline line, the bytes
by op and the heaviest ops by bytes, each aggregated by op and input
shapes (``scale``: how many times it ran) — the hypothesis-forming view
of the JAX package's ``launch/profile.py``.

    PYTHONPATH=src python -m repro_torch.launch.profile --arch xlstm-1.3b \
        --shape prefill_32k [--reduced] [--top 25]
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import api
from repro_torch.launch.dryrun import parse_overrides, trace
from repro_torch.launch.roofline import roofline_terms


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.profile")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--optimizer", default="fed_sophia")
    ap.add_argument("--local-iters", type=int, default=10)
    ap.add_argument("--overrides", default="")
    args = ap.parse_args(argv)

    kw = {"cfg_overrides": parse_overrides(args.overrides)}
    if INPUT_SHAPES[args.shape].kind == "train":
        kw.update(optimizer=args.optimizer, local_iters=args.local_iters)
    oc = trace(api.build(args.arch, args.shape, reduced=args.reduced, **kw))
    s = oc.summary()
    terms = roofline_terms(s["flops_by_dtype"], s["bytes"])
    print(f"flops={s['flops']:.4g}  bytes={s['bytes']:.4g}  "
          f"peak={s['peak_bytes']:.4g}B  roofline_s={s['roofline_s']:.4g}  "
          f"flops by dtype {s['flops_by_dtype']}")
    print("roofline:", {k: (f"{v:.4g}" if isinstance(v, float) else v)
                        for k, v in terms.items()})
    print("launches:", {k: v for k, v in s["launches"].items() if v})
    print("\nbytes by op:")
    for k, v in s["bytes_by_opcode"].items():
        print(f"  {k:32s} {v:.4g}")
    print(f"\ntop {args.top} ops by bytes (scale = times it ran):")
    print(f"{'bytes':>12s} {'flops':>12s} {'scale':>8s} {'op':32s} shapes")
    for e in oc.top_contributors(args.top):
        print(f"{e['bytes']:12.4g} {e['flops']:12.4g} {e['scale']:8d} "
              f"{e['opcode']:32s} {e['shape'][:70]}")


if __name__ == "__main__":
    main()
