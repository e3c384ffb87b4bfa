"""The chip's published peaks and the least time a kernel's launches could
take on it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W):
989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM.  A roofline
share is bound / measured time, the bound per launch the larger of bytes
over the memory rate and operations over the compute rate, each input byte
read once and each output byte written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12


def bound_s(n_bytes: float, ops: float, peak: float = BF16_TENSOR_FLOPS) -> float:
    """The least seconds one launch could take."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / peak)


def k3_launches(h: int, w: int, batch: int):
    """The fused stride-1 bottleneck (K3) launches of one ResNet trunk pass
    over a (h, w) batch of ``batch`` images: layer1's three blocks at
    stride 4 (the first with its projection from 64 channels) and layer2's
    blocks 1-3 at stride 8 → [(B, H, W, cin, mid, projection)]."""
    h4, w4 = -(-h // 4), -(-w // 4)
    h8, w8 = -(-h4 // 2), -(-w4 // 2)
    return ([(batch, h4, w4, 64, 64, True)] + [(batch, h4, w4, 256, 64, False)] * 2
            + [(batch, h8, w8, 512, 128, False)] * 3)


def k3_bound_s(launches) -> float:
    """Σ over launches of the bound: bf16 input, weights, biases and output
    once; 2 x MACs of the 1x1, 3x3, 1x1 (and projection) convolutions."""
    total = 0.0
    for b, h, w, cin, mid, proj in launches:
        cout = 4 * mid
        weights = cin * mid + 9 * mid * mid + mid * cout + (cin * cout if proj else 0)
        biases = 2 * mid + cout + (cout if proj else 0)
        n_bytes = 2 * (b * h * w * (cin + cout) + weights + biases)
        total += bound_s(n_bytes, 2.0 * b * h * w * weights)
    return total
