"""Device milliseconds a request of the BN epilogue (``bn_epilogue_kernel``,
``frcnn_tpu_torch/csrc/bn_epilogue.cu``: frozen BN, the residual and the
relu of every bottleneck outside K3) in the traced serve window: its
kernels' device time summed / the requests (``frcnn.serve.detect_blobs``
spans).  None off the card, or where the trace holds no request or no
launch of the kernel (a program without it)."""

from benchmark.harness.spans import REQUEST

KERNEL = "bn_epilogue_kernel"


def read(ctx):
    if ctx.platform != "gpu":
        return None
    requests = sum(1 for name, *_ in ctx.trace.host if name == REQUEST)
    seconds, launches = ctx.trace.device_seconds(lambda name: KERNEL in name)
    if requests == 0 or launches == 0:
        return None
    return 1e3 * seconds / requests
