"""The device's idle share of a round: 100 x (1 - the device's busy time
a round in the traced window (the union of the device activities'
intervals) / the time of a round untraced).  The round's time is the
mean over the untraced rounds run just before the trace, three a traced
round (CUDA events): the profiler's host cost slows a round that the
host paces, and the idle share of the traced window would count it.  The
profiler also lengthens the kernels a little, so a cell whose device is
never idle reads about 0, a tenth of a percent either side."""


def read(run):
    t = run.trace
    if t is None or not t.kernels or run.plain_round_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.rounds / run.plain_round_s)
