"""Gate and launch geometry of the elementwise epilogue kernels
(``bn_epilogue``, ``fpn_epilogue``).  ``gate`` is the one rule of where a
call site may take either kernel; the geometry is a fixed rule of the shape,
no tuning, no state.  Both kernels stream a bf16 channels-last tensor in
vectors of 8 channels with a 512-thread block and ``__launch_bounds__(512,
1)``.  On the H100, 2 to 8 blocks an SM timed within 0.6% of one over the 13
FPN epilogue launches of an FPN serving batch, 16 blocks 2.6% slower."""

from __future__ import annotations

import math

import torch

from frcnn_tpu_torch.ops.cuda.card import SMS

THREADS = 512          # the kernels' block (csrc/*_epilogue.cu, kThreads)
UNROLL = 4             # vectors of 8 channels a thread has at least, where the tensor allows
BLOCKS_PER_SM = 1      # the kernels' __launch_bounds__(512, 1)


def gate(x) -> bool:
    """Whether the elementwise passes after a convolution of ``x`` may run
    as an epilogue kernel: bf16 on the card with autograd off (the kernels
    have no backward), which is serving and also the validation losses
    (``SolverWrapper.val_losses`` runs ``train_forward`` under no_grad).
    Training steps, the CPU and f32 keep the module-by-module path."""
    return x.is_cuda and x.dtype == torch.bfloat16 and not torch.is_grad_enabled()


def epilogue_plan(numel: int, c: int) -> dict:
    """Launch geometry for ``numel`` bf16 values of ``c`` channels: THREADS
    a block; enough blocks that each thread has UNROLL vectors of 8 where
    the tensor allows, at most BLOCKS_PER_SM a streaming multiprocessor
    (one wave), rounded up so that blocks x THREADS is a whole number of
    pixels (c / 8 vectors): a thread's channels then stay the same in every
    step of its grid-stride loop."""
    if c % 8 or numel % c:
        raise ValueError(f"epilogue_plan: {numel} values of {c} channels (need c % 8 == 0)")
    vecs = c // 8
    multiple = vecs // math.gcd(vecs, THREADS)
    blocks = min(-(-numel // (8 * THREADS * UNROLL)), SMS * BLOCKS_PER_SM)
    blocks = -(-max(blocks, 1) // multiple) * multiple
    return {"threads": THREADS, "blocks": blocks}
