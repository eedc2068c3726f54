"""The window's peak of device memory allocated by the process
(`torch.cuda.max_memory_allocated`, reset when set-up ends), in GiB."""


def read(run):
    if run.trace is not None or not run.peak_bytes:
        return None
    return run.peak_bytes / 2 ** 30
