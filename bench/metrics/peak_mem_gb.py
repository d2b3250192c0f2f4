"""The allocator's peak over the window (``max_memory_allocated`` after a
reset at its start) on the fullest of the cell's cards, in GB."""


def read(ctx):
    if not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 1e9
