"""Device operations (kernels, copies, memsets) per call in the trace."""


def read(ctx):
    return len(ctx.trace.device) / ctx.calls
