"""The allocator's peak over the window, in GiB (peak statistics reset at
the window's start)."""


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2**30
