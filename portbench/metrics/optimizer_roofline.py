"""The local optimiser update's share of its roofline: the least time
the Sophia update's bytes take at the HBM rate (`cost.sophia_bytes`:
theta, m, h, g, h_hat read once, theta, m, h written once, fp32, per
client and local step; 3.35e12 B/s) over the device time inside the
program's optimiser profiler ranges (named "fed.optimizer"), in the
traced rounds: the same work whatever kernel, or kernel name, does it."""
from portbench import cost

SPAN = "fed.optimizer"


def read(run):
    t = run.trace
    if t is None:
        return None
    busy = t.range_s(SPAN)
    if not busy:
        return None
    bound = cost.sophia_bytes(run.conf, run.traffic) * t.rounds \
        / cost.HBM_BYTES_PER_S
    return 100.0 * bound / busy
