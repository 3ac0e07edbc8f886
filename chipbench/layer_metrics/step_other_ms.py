"""Device ms per calibration step outside the forward and backward render
kernels: the loss, the prologue and its backward, the update."""


def read(ctx):
    skip = [ctx.kernels[k].KERNEL for k in ("render_fwd", "render_bwd")]
    return ctx.device_ms_per_call(lambda n: not any(k in n for k in skip))
