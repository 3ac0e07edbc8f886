"""Host ms per call from the call's span to its first runtime call that
enqueues device work: validation, to_config, the dataset's cached inputs."""

from chipbench.harness.readers import mean_ms


def read(ctx):
    return mean_ms(ctx.trace.first_enqueue_us())
