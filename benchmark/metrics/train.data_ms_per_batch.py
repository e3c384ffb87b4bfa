"""Host milliseconds of ``RoIDataLayer.forward`` (a batch made from the roidb:
read, flip, resize, pad, the ground truth) per batch of the traced window,
in the prefetch thread, timed by the benchmark's wrapper around that
attribute."""

from benchmark.harness.readers import span_ms


def read(ctx):
    return span_ms(ctx, "forward")
