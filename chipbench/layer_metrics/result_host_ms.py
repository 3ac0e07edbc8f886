"""Host ms per call from its last device op (the device-to-host copy) to
its return: the wait for the copy and the unpack into complex numpy."""

from chipbench.harness.readers import mean_ms


def read(ctx):
    return mean_ms(ctx.trace.after_last_device_us())
