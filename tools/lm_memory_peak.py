#!/usr/bin/env python3
"""Where an LM run of the port peaks in device memory.

    python3 tools/lm_memory_peak.py [--arch gemma2-9b] [--clients 2]
        [--compressor int8] [--rounds 2]

Runs ``repro_torch.launch.train`` on the card at the arch's published
widths, cut to 2 layers (J=2, tau=2, batch 2, seq 256), under the CUDA
caching allocator's memory history, then replays the history: the peak
of allocated bytes (it equals ``torch.cuda.max_memory_allocated``) and
the blocks live at that peak, grouped by where they were allocated (the
innermost frames in ``repro_torch``), largest first.  Needs one card.
"""
from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402


def where(frames, depth=3) -> str:
    own = [f for f in frames if "repro_torch" in f["filename"]]
    fs = own[:depth] if own else frames[:2]
    return " <- ".join(f"{Path(f['filename']).name}:{f['line']} {f['name']}"
                       for f in fs)


def live_at_peak(trace):
    """(peak bytes, {addr: (size, frames)} live at the peak) of one
    device's allocator trace."""
    live, total, peak, peak_i = {}, 0, 0, -1
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], e.get("frames", []))
            total += e["size"]
            if total > peak:
                peak, peak_i = total, i
        elif e["action"] == "free_completed" and e["addr"] in live:
            total -= live.pop(e["addr"])[0]
    live = {}
    for e in trace[:peak_i + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], e.get("frames", []))
        elif e["action"] == "free_completed" and e["addr"] in live:
            live.pop(e["addr"])
    return peak, live


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--clients", default="2")
    ap.add_argument("--compressor", default="int8")
    ap.add_argument("--rounds", default="2")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lm_memory_peak: needs an NVIDIA card")
    from repro_torch.launch import train
    torch.cuda.memory._record_memory_history(max_entries=1_000_000,
                                             stacks="python")
    train.main(["--arch", args.arch, "--layers", "2", "--rounds",
                args.rounds, "--clients", args.clients, "--local-iters",
                "2", "--tau", "2", "--batch", "2", "--seq", "256",
                "--compressor", args.compressor])
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    peak, live = live_at_peak(snap["device_traces"][0])
    print(f"{args.arch} x 2 layers, {args.clients} clients, "
          f"{args.compressor}: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} bytes; peak of the "
          f"replayed history {peak} bytes; live at the peak:")
    sizes, counts = collections.Counter(), collections.Counter()
    for size, frames in live.values():
        sizes[where(frames)] += size
        counts[where(frames)] += 1
    for k, v in sizes.most_common(args.top):
        print(f"  {v / 1e9:9.3f} GB {counts[k]:4d}x  {k}")


if __name__ == "__main__":
    main()
