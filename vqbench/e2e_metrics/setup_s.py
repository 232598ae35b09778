"""setup_s: from the start of the process's Python code to the start of
the window: imports, the card's start, the corpus and pool, the exact
ground truth, the build (with the kernels' compile in a checkout's first
run) and the warm-up."""


def read(run):
    return run.setup_s
