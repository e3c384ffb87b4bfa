"""The arithmetic of the per-layer metrics: each file under
``benchmark/metrics/`` names one of these as its ``read``.  A reader that
finds nothing to read returns None, and the harness leaves the metric out
of the line; no device number is read from a run without a card."""

from __future__ import annotations

from benchmark.harness.roofline import BF16_TENSOR_FLOPS, k3_bound_s, k3_launches


def idle_share(ctx):
    """The device's idle share of the traced window, in %: 1 - the union of
    its kernel, copy and memset intervals / the window's wall time."""
    if ctx.platform != "gpu" or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mfu(ctx):
    """The step's share of the chip's bf16 dense peak over the traced window,
    in %: the reference's dense FLOPs an image (``FlopCounterMode`` on the
    meta device at the batch's bucket; forward, and for training backward)
    x the window's images / its seconds / 989 TFLOP/s."""
    if ctx.platform != "gpu" or not ctx.batches:
        return None
    return 100.0 * ctx.flops() / ctx.trace.window_s / BF16_TENSOR_FLOPS


def k3_roofline(ctx):
    """K3 (the fused stride-1 bottleneck, ``fused_bottleneck_kernel``): its
    least time at the chip's peaks over all its launches of the traced
    window / the device time of its kernels, in %.  The launches are the six
    of a ResNet trunk pass (layer1's three blocks, layer2's blocks 1-3) for
    every batch; where the trace holds another count (the kernel gone or
    moved), there is nothing to read."""
    if ctx.platform != "gpu":
        return None
    seconds, launches = ctx.trace.device_seconds(lambda name: "fused_bottleneck" in name)
    expected = [x for b, (h, w) in ctx.batches for x in k3_launches(h, w, b)]
    if seconds <= 0 or launches != len(expected):
        return None
    return 100.0 * k3_bound_s(expected) / seconds


def span_ms(ctx, name: str):
    """Host milliseconds a call of the span ``name`` that the traced window's
    wrapper recorded at a layer boundary."""
    calls = ctx.spans.calls.get(name, 0)
    if calls == 0:
        return None
    return 1e3 * ctx.spans.seconds[name] / calls
