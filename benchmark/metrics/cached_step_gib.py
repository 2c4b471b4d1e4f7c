"""cached_step_gib: the bytes of the one cached step (checkpoints, tapes,
physics linearization; debug.cache_bytes), GiB."""


def read(ctx):
    b = getattr(ctx, "cached_step_bytes", None)
    return b / 2**30 if b else None
