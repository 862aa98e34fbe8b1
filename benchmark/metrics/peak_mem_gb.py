"""Peak device memory over the traced window, ``max_memory_allocated`` in
units of 1e9 bytes."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
