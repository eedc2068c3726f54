"""Device milliseconds a round inside the program's pack profiler ranges
(named "fed.pack": unpack of theta into leaves, pack of the grads and of
h_hat, theta's fp32 cast, the clients' working copies of the start
model)."""

SPAN = "fed.pack"


def read(run):
    t = run.trace
    if t is None:
        return None
    s = t.range_s(SPAN)
    return None if s is None else 1e3 * s / t.rounds
