"""Device activities (kernels, copies, fills) in the traced window over
the rounds traced: the host's dispatch load a round."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    return len(t.kernels) / t.rounds
