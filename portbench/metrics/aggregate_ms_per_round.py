"""Device milliseconds a round inside the program's aggregate profiler
ranges (named "fed.aggregate": the cohort's mean or sum, the server
step, the scatter of rows back into the resident stacks, the loss
means)."""

SPAN = "fed.aggregate"


def read(run):
    t = run.trace
    if t is None:
        return None
    s = t.range_s(SPAN)
    return None if s is None else 1e3 * s / t.rounds
