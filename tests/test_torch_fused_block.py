"""K3's plain twin (``frcnn_tpu_torch/ops/cuda/fused_block.py``) against the
JAX package's ``bottleneck_reference`` and the Pallas ``fused_bottleneck``
in interpret mode, f32, on the CPU; and the port's Bottleneck module, whose
fused path folds frozen BN into the weights, against its plain conv path."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frcnn_tpu.ops.pallas.fused_block import bottleneck_reference as jax_reference
from frcnn_tpu.ops.pallas.fused_block import fused_bottleneck as jax_fused
from frcnn_tpu_torch.models.backbones import Bottleneck
from frcnn_tpu_torch.ops.cuda import build
from frcnn_tpu_torch.ops.cuda.fused_block import bottleneck_reference, fused_bottleneck


def _close(got, want):
    """Within 1e-4 relative to the output's scale (f32 summation order)."""
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(np.asarray(got) - want).max() / scale < 1e-4


@pytest.mark.parametrize("cin,proj", [(32, False), (24, True)])
def test_twin_matches_jax_reference_and_pallas(rng, cin, proj):
    b, h, w, mid, cout = 2, 48, 16, 8, 32

    def t(*s):
        return rng.randn(*s).astype(np.float32) * 0.3

    x = t(b, h, w, cin)
    args = [t(cin, mid), t(mid), t(3, 3, mid, mid), t(mid), t(mid, cout), t(cout)]
    ds = [t(cin, cout), t(cout)] if proj else [None, None]
    want = jax_reference(jnp.asarray(x), *[jnp.asarray(a) for a in args],
                         *[None if a is None else jnp.asarray(a) for a in ds])
    tt = [None if a is None else torch.from_numpy(a) for a in [x] + args + ds]
    got = bottleneck_reference(*tt).numpy()
    _close(got, want)

    w2cat = [args[0], args[1], args[2].reshape(9 * mid, mid), *args[3:]]
    pallas = jax_fused(jnp.asarray(x), *[jnp.asarray(a) for a in w2cat],
                       *[None if a is None else jnp.asarray(a) for a in ds], interpret=True)
    build.reset_launch_counts()
    wrapped = fused_bottleneck(tt[0], *[torch.from_numpy(a) for a in w2cat], *tt[7:])
    assert build.LAUNCH_COUNTS["fused_block"] == 0  # CPU tensors run the twin
    _close(wrapped.numpy(), pallas)


@pytest.mark.parametrize("cin", [64, 256])
def test_bottleneck_fused_fold_matches_conv_path(rng, cin):
    """The fused path's BN folding (w * mul, add) gives the plain path's
    block output; on a CPU tensor the gate keeps the plain path."""
    g = torch.Generator().manual_seed(int(rng.randint(1 << 30)))
    block = Bottleneck(cin, 64, 1, fused=True)
    with torch.no_grad():
        for name, buf in block.named_buffers():
            if name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
            else:
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.3)
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * (2.0 / p[0].numel()) ** 0.5)
    x = torch.relu(torch.randn(2, cin, 12, 20, generator=g))
    x = x.contiguous(memory_format=torch.channels_last)
    assert not block._use_fused(x)
    with torch.no_grad():
        plain = block(x)
        fused = block._fused_forward(x)
    _close(fused.numpy(), plain.numpy())
