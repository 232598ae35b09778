"""build_s: the index build in set-up, from the start of ``fit`` to the
index ready, synchronised (host clock)."""


def read(run):
    return run.build_s
