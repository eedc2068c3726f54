"""Device milliseconds a round inside the program's comm profiler ranges
(named "fed.comm": participation, the downlink broadcast, the uplink
encode, the hessian round trip and server_combine)."""

SPAN = "fed.comm"


def read(run):
    t = run.trace
    if t is None:
        return None
    s = t.range_s(SPAN)
    return None if s is None else 1e3 * s / t.rounds
