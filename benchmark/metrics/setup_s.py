"""setup_s: process start to the first measured pair (host clock)."""


def read(ctx):
    return getattr(ctx, "setup_s", None)
