"""K1: batched exact greedy NMS — CUDA kernel wrapper and its plain twin.

Replaces the TPU kernel ``frcnn_tpu/ops/pallas/nms_kernel.py``
(``nms_mask_pallas_batched`` / ``_nms_kernel_b``).  The kernel is
``frcnn_tpu_torch/csrc/nms_kernel.cu``: one launch, a thread-block cluster
a problem, the walk in chunks of 64 candidates.  Each chunk is tested
against the boxes kept so far (at most ``max_keep``, held in the cluster's
shared memory, dealt round-robin over its blocks), the blocks exchange one
64-bit word through distributed shared memory, and one warp resolves the
chunk's own greedy order with bit operations.  No IoU bit reaches device
memory, and no pair is compared that the capped walk does not need.  Bound
on the H100: operations (64 x kept-so-far a chunk, at most N x cap), then
latency: four block barriers and one cluster barrier a chunk (the cluster
barrier is split, the chunk's triangle is built while it completes).
``nms_plan`` is the launch geometry: blocks a problem, threads a block, kept
slots a block.

``nms_mask_reference`` is the plain PyTorch twin: the blocked greedy
algorithm of ``frcnn_tpu/ops/nms.py::nms_mask``, batched.  Both use the
division form of ``bbox_overlaps`` in the same operation order, so keep
masks are bit-equal.
"""

from __future__ import annotations

import torch

from frcnn_tpu_torch.ops.boxes import bbox_overlaps
from frcnn_tpu_torch.ops.constants import device_constant
from frcnn_tpu_torch.ops.cuda import build
from frcnn_tpu_torch.ops.cuda.card import MAX_CLUSTER, SMS as SM_COUNT


_TILE = 128  # boxes resolved sequentially per step of the twin

CHUNK = 64                    # candidates a step of the kernel
MAX_THREADS = 1024
SLOT_BYTES = 20               # a kept box (4 floats) and its area
MAX_LIST_BYTES = 200 * 1024   # dynamic shared memory a block gives its kept list
STATIC_SMEM_BYTES = 64 * 16 + 64 * 4 + 64 * 8 + 16 + 2 * 16 * 8 + 8   # the kernel's own arrays
SINGLE_BLOCK_PAIRS = 1 << 18  # N x cap up to which one block walks a problem


def nms_mask_reference(boxes, thresh, valid=None):
    """Exact greedy NMS keep mask.  boxes (B, N, 4) sorted by descending
    score, valid (B, N) → keep (B, N) bool.  Invalid boxes are never kept and
    never suppress.  Sequential only inside 128-box tiles: a tile resolves
    its own greedy order, then its kept boxes suppress every later box."""
    b, n = boxes.shape[:2]
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=boxes.device)
    thr = device_constant(float(thresh), torch.float32, boxes.device)
    boxes = boxes.float()
    suppressed = ~valid
    t_idx = torch.arange(_TILE, device=boxes.device)
    later = t_idx[None, :] > t_idx[:, None]
    for start in range(0, n, _TILE):
        stop = min(start + _TILE, n)
        tb = boxes[:, start:stop]
        t = stop - start
        iou_tt = (bbox_overlaps(tb, tb) > thr) & later[:t, :t]
        sup_t = suppressed[:, start:stop].clone()
        for i in range(t):
            sup_t |= (~sup_t[:, i])[:, None] & iou_tt[:, i]
        suppressed[:, start:stop] = sup_t
        if stop < n:
            hit = (bbox_overlaps(tb, boxes[:, stop:]) > thr) & (~sup_t)[:, :, None]
            suppressed[:, stop:] |= hit.any(dim=1)
    return ~suppressed & valid


def nms_plan(b: int, n: int, cap: int | None = None, cluster: int | None = None,
             threads: int | None = None) -> dict:
    """Launch geometry for ``b`` problems of ``n`` boxes capped at ``cap``
    kept boxes: ``cluster`` blocks a problem (a power of two), ``threads`` a
    block (a power of two, at least 64), ``slots`` kept boxes a block, ``smem_bytes`` of
    dynamic shared memory a block.  A problem whose N x cap is small walks on
    one block; a larger one gets as many blocks as keep B x cluster within the
    card's SMs, and in any case enough that the kept list fits.  ``cluster``
    and ``threads`` override the choice (probes and tests)."""
    keep_cap = n if cap is None else max(0, min(int(cap), n))
    if cluster is None:
        cluster = 1
        if n * keep_cap > SINGLE_BLOCK_PAIRS:
            while cluster < 8 and 2 * cluster * b <= SM_COUNT:
                cluster *= 2
    while cluster < MAX_CLUSTER and -(-keep_cap // cluster) * SLOT_BYTES > MAX_LIST_BYTES:
        cluster *= 2
    slots = max(1, -(-keep_cap // cluster))
    if cluster & (cluster - 1) or not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"nms_plan: cluster {cluster} is not a power of two up to {MAX_CLUSTER}")
    if slots * SLOT_BYTES > MAX_LIST_BYTES:
        raise ValueError(f"nms_plan: {keep_cap} kept boxes do not fit the shared memory of "
                         f"{cluster} blocks")
    if threads is None:
        # a step compares 64 candidates with the block's share of the list and
        # with each other (2016 pairs): many threads, unless many small
        # problems share an SM
        threads = 512 if cluster == 1 and slots <= 128 else 1024
    if threads & (threads - 1) or not CHUNK <= threads <= MAX_THREADS:
        raise ValueError(f"nms_plan: {threads} threads is not a power of two from {CHUNK} to "
                         f"{MAX_THREADS}")
    return {"cluster": cluster, "threads": threads, "slots": slots,
            "smem_bytes": slots * SLOT_BYTES}


def nms_mask_batched(boxes, thresh, valid=None, max_keep: int | None = None,
                     plan: dict | None = None):
    """Keep mask of B greedy NMS problems: boxes (B, N, 4) score-sorted,
    valid (B, N) → keep (B, N) bool.  With ``max_keep`` the first max_keep
    kept boxes of each problem are exact and later keep bits are zero.

    CPU tensors run the plain twin (which ignores the cap); CUDA tensors
    launch the kernel, once, with the geometry of ``nms_plan`` (or ``plan``)."""
    b, n = boxes.shape[:2]
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=boxes.device)
    if not boxes.is_cuda:
        return nms_mask_reference(boxes, thresh, valid)
    boxes = boxes.float().contiguous()
    valid = valid.to(torch.bool).contiguous()
    build.check_cuda("nms boxes", boxes, torch.float32, (b, n, 4))
    build.check_cuda("nms valid", valid, torch.bool, (b, n))
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    cap = n if max_keep is None else int(max_keep)
    if plan is None:
        plan = nms_plan(b, n, cap)
    build.launch("frcnn_nms_batched", boxes.data_ptr(), valid.data_ptr(), b, n,
                 float(thresh), cap, plan["cluster"], plan["threads"], plan["slots"],
                 keep.data_ptr())
    build.LAUNCH_COUNTS["nms"] += 1
    return keep
