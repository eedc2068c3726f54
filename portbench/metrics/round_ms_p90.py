"""The 90th percentile of the window's round times: each the interval
between consecutive end-of-round CUDA events (the first from an event
recorded before the first round), `statistics.quantiles(n=10)`'s last
cut.  The sample count is printed on standard error."""
import statistics


def read(run):
    if run.trace is not None or not run.round_ms or len(run.round_ms) < 10:
        return None
    return statistics.quantiles(run.round_ms, n=10)[-1]
