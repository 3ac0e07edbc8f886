"""Share of the traced window in which no device op ran, in percent."""


def read(ctx):
    return ctx.idle_pct()
