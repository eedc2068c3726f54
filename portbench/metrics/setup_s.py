"""Seconds from the process's start to the first timed round: start-up,
weights and batches from the seed, the kernels' build (the first run of
a checkout only), the checked rounds and one warm round."""


def read(run):
    return run.setup_s
