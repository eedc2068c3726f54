#!/usr/bin/env python3
"""Device times of the PyTorch port's kernels for two or more checkouts of
this repository on one card, in turns there and back (A, B, B, A; with
three: A, B, C, C, B, A).

    python3 tools/ab_kernel_times.py [--part time_slice4] [--harness] \
        CHECKOUT_A [CHECKOUT_B ...]

With one checkout named, the other is the checkout that holds this script.
Each turn is a process of its own, started in the checkout, that builds
the checkout's kernels and runs its own ``chip_smoke.time_kernels`` (or
the part named by ``--part``, such as ``time_slice4``: rows 3, 14 and 15)
on card 0; nothing else of ``chip_smoke.py`` runs (no checks, no rounds).
With ``--harness`` every turn runs this checkout's ``chip_smoke.py`` part
on the named checkout's package and kernels (for a timing that an older
checkout's script does not have; the part may call only what every
checkout's package has).  Every line of the form ``<label> (<shape>) fp32:
device kernel <ms> / <ms> ms`` is read back.  Per label the script prints
each turn's mean ("-" where a turn has no such line) and each checkout's
mean over A's, then the card's name and power limit.  Exits nonzero without a card or if a turn
fails.
"""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
TURN = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke as c;"
        " c.build.build_all(); c.{part}(torch.device('cuda', 0))")
#: the same with this checkout's chip_smoke.py: the checkout's package is
#: imported first, so chip_smoke's own path insert finds it loaded
HARNESS = ("import sys, torch; sys.path.insert(0, 'src'); import repro_torch;"
           f" sys.path.insert(1, {str(HERE)!r}); import chip_smoke as c;"
           " c.build.build_all(); c.{part}(torch.device('cuda', 0))")
LINE = re.compile(r"^(.*?) \(([0-9, ]+)\) fp32: device kernel "
                  r"([0-9.e+-]+) / ([0-9.e+-]+) ms")


def turn(checkout: Path, part: str, harness: bool = False) -> dict:
    """label -> mean of the two timed runs of each line, for one turn."""
    code = (HARNESS if harness else TURN).replace("{part}", part)
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=checkout, capture_output=True, text=True,
                          timeout=1200)
    if proc.returncode != 0:
        raise SystemExit(f"turn in {checkout} failed ({proc.returncode}):\n"
                         f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    out = {}
    for ln in proc.stdout.splitlines():
        m = LINE.match(ln)
        if m:
            out[f"{m[1]} ({m[2]})"] = (float(m[3]) + float(m[4])) / 2
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernel_times: needs an NVIDIA card")
    args = sys.argv[1:]
    part = "time_kernels"
    if args[:1] == ["--part"]:
        part, args = args[1], args[2:]
    harness = args[:1] == ["--harness"]
    args = args[1:] if harness else args
    paths = [Path(a).resolve() for a in args]
    if len(paths) == 1:
        paths.append(HERE)
    names = [chr(ord("A") + j) for j in range(len(paths))]
    order = list(range(len(paths))) + list(reversed(range(len(paths))))
    times = [(j, turn(paths[j], part, harness)) for j in order]
    labels = list(dict.fromkeys(k for _, t in times for k in t))
    for name, path in zip(names, paths):
        print(f"{name} = {path}")
    print("turns' lines read: "
          + ", ".join(f"{names[j]} {len(t)}" for j, t in times))
    print("kernel | " + " | ".join(f"{names[j]} ms" for j in order) + " | "
          + " | ".join(f"{n}/A" for n in names[1:]))
    for k in labels:
        mean = [sum(t[k] for j2, t in times if j2 == j) / 2
                if all(k in t for j2, t in times if j2 == j) else None
                for j in range(len(paths))]
        ratio = [f"{m / mean[0]:.4f}" if None not in (m, mean[0]) else "-"
                 for m in mean[1:]]
        print(f"{k} | " + " | ".join(f"{t[k]:.6g}" if k in t else "-"
                                     for _, t in times)
              + " | " + " | ".join(ratio))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)


if __name__ == "__main__":
    main()
