"""The benchmark of the PyTorch / CUDA port (``src/repro_torch``): one
run of one cell, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It prints its progress and, last on standard error, each number the
check compares beside its limit; the last line of standard output is
the result object.  It needs an NVIDIA card and exits non-zero, with no
result, without one, and when the run has loaded JAX, jaxlib, flax or
the JAX package ``repro`` (top-level names compared whole).
Build and kernel caches stay inside the checkout: the program builds its
kernels into ``build/repro_torch/``, and the benchmark points
``TORCH_EXTENSIONS_DIR``, ``TRITON_CACHE_DIR`` and ``CUDA_CACHE_PATH``
at fixed folders under ``build/portbench/``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    import torch
    from portbench import cells, harness

    torch.set_num_threads(1)        # one process, few threads: a steadier host
    bench = cells.Bench(ROOT)
    chips = bench.workload(args.workload).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} NVIDIA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), torch.device("cuda", 0), bench)
    # after the window and the check, in the process that prints: what
    # the port loaded, whatever the sources say
    bad = harness.loaded_forbidden()
    if bad:
        print(f"portbench: loaded in the run: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
