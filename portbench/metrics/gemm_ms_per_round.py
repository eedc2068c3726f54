"""Device milliseconds a round of the GEMM activities
(`portbench.cost.ACTIVITY_CLASSES`, by name)."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    return 1e3 * t.class_s("gemm") / t.rounds
