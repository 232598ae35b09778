"""search.launches: device kernels a batch launches (copies and fills not
counted), from the profiler's trace of the traced stretch."""


def read(ctx):
    if not ctx.trace["batches"]:
        return None
    return ctx.trace["kernels"] / ctx.trace["batches"]
