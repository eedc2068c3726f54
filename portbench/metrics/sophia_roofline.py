"""The Sophia update kernel's share of its roofline: the least time its
bytes take at the HBM rate (`cost.sophia_bytes`: theta, m, h, g, h_hat
read once, theta, m, h written once, fp32, per client and local step;
3.35e12 B/s) over the device time of the activities whose name holds
"sophia", in the traced rounds."""
from portbench import cost


def read(run):
    t = run.trace
    if t is None:
        return None
    busy = t.named_s("sophia")
    if busy <= 0:
        return None
    bound = cost.sophia_bytes(run.conf, run.traffic) * t.rounds \
        / cost.HBM_BYTES_PER_S
    return 100.0 * bound / busy
