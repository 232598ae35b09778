"""qps: every query answered in the window over the window's seconds
(host clock, the first call to the last answer in hand)."""


def read(run):
    return run.queries / run.window_s
