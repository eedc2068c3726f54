"""Device milliseconds a round inside the program's GNB profiler ranges
(named "fed.gnb": the estimate's gumbel draw, sampled forward and
backward and B g g, and the zero h_hat of the steps without a refresh)."""

SPAN = "fed.gnb"


def read(run):
    t = run.trace
    if t is None:
        return None
    s = t.range_s(SPAN)
    return None if s is None else 1e3 * s / t.rounds
