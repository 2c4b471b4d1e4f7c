"""peak_gib: torch.cuda.max_memory_allocated() over the run, GiB."""


def read(ctx):
    b = getattr(ctx, "peak_bytes", None)
    return b / 2**30 if b else None
