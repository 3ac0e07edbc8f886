"""Device ms per call of every op other than the port's named kernels and
the device-to-host copies: the prologue's small kernels and uploads."""


def read(ctx):
    return ctx.device_ms_per_call(
        lambda n: not ctx.is_named(n) and "DtoH" not in n)
