"""Device milliseconds a round inside the program's MoE dispatch /
combine profiler ranges (named "moe dispatch/combine", forward and
backward)."""

SPAN = "moe dispatch/combine"


def read(run):
    t = run.trace
    if t is None:
        return None
    s = t.range_s(SPAN)
    return None if s is None else 1e3 * s / t.rounds
