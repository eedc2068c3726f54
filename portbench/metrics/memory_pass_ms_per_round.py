"""Device milliseconds a round of the elementwise, copy / cast and
reduction activities (`portbench.cost.ACTIVITY_CLASSES`, by name): the
memory-bound passes of the loss/grad boundary, the GNB and the packing."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    s = sum(t.class_s(c) for c in ("elementwise", "copy", "reduction"))
    return 1e3 * s / t.rounds
