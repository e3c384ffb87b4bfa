"""Host milliseconds of ``frcnn_tpu_torch.engine.serve.prep_image`` (resize and
pad) per image of the traced window, timed by the benchmark's wrapper around
that module attribute."""

from benchmark.harness.readers import span_ms


def read(ctx):
    return span_ms(ctx, "prep_image")
