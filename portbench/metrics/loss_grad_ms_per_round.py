"""Device milliseconds a round inside the program's loss/grad profiler
ranges (named "fed.loss_grad": each local step's loss forward and the
backward it starts, remat's recompute included)."""

SPAN = "fed.loss_grad"


def read(run):
    t = run.trace
    if t is None:
        return None
    s = t.range_s(SPAN)
    return None if s is None else 1e3 * s / t.rounds
