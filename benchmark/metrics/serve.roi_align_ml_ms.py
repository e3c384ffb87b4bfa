"""Device milliseconds a request of K6 (``roi_align_ml_fwd_kernel``,
``frcnn_tpu_torch/csrc/roi_align_kernel.cu``: the FPN's RoIAlign over
P2-P5, one launch a batch) in the traced serve window: its kernels' device
time summed / the requests (``frcnn.serve.detect_blobs`` spans).  None off
the card, or where the trace holds no request or no launch of the kernel."""

from benchmark.harness.k6_roofline import KERNEL
from benchmark.harness.spans import REQUEST


def read(ctx):
    if ctx.platform != "gpu":
        return None
    requests = sum(1 for name, *_ in ctx.trace.host if name == REQUEST)
    seconds, launches = ctx.trace.device_seconds(lambda name: KERNEL in name)
    if requests == 0 or launches == 0:
        return None
    return 1e3 * seconds / requests
