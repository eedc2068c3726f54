"""The share of the traced rounds' device time that the program's phase
profiler ranges account for: 100 x the device time of the activities
that start inside any phase range (each activity counted once, where
ranges of two phases overlap too) / the device time of every activity
in the window.  At most 100 by construction; what it leaves out is the
round's work outside the split."""
import bisect

PHASES = ("fed.loss_grad", "fed.gnb", "fed.pack", "fed.optimizer",
          "fed.comm", "fed.aggregate")


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    merged = []
    for lo, hi in sorted(s for p in PHASES for s in t.ranges.get(p, ())):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    if not merged:
        return None
    starts = [lo for lo, _ in merged]
    inside = total = 0.0
    for _, a, b in t.kernels:
        total += b - a
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and a < merged[i][1]:
            inside += b - a
    return 100.0 * inside / total if total > 0 else None
