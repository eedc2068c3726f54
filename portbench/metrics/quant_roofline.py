"""The int8 uplink round-trip kernel's share of its roofline: the least
time its bytes take at the HBM rate (`cost.quant_bytes`: per client the
delta and its noise and the row scales read once, the reconstruction
written once, fp32; 3.35e12 B/s) over the device time of the activities
whose name holds "quant_roundtrip", in the traced rounds."""
from portbench import cost


def read(run):
    t = run.trace
    if t is None or run.traffic["compressor"] not in ("int8",):
        return None
    busy = t.named_s("quant_roundtrip")
    if busy <= 0:
        return None
    bound = cost.quant_bytes(run.conf, run.traffic) * t.rounds \
        / cost.HBM_BYTES_PER_S
    return 100.0 * bound / busy
