"""K5: exact top-k set by threshold (radix select) — CUDA kernel wrapper and
its plain twin.

Replaces the TPU kernel ``frcnn_tpu/ops/pallas/select_kernel.py``
(``topk_threshold`` / ``_thresh_kernel``).  Contract: for scores (B, S) f32
and 1 <= k <= S, ``lax.top_k``'s set of each row — the lowest index wins a
tie at the cut, NaN counts as the largest value — in INDEX-ASCENDING order.
Callers that need descending order re-rank the k winners with a small
stable sort.

The kernel (``frcnn_tpu_torch/csrc/select_kernel.cu``) gives each row one
1024-thread block: a radix select over the bytes of the sortable keys finds
the k-th largest key with integer histograms, then block-wide prefix scans
compact the selected indices in order.  Bound on the H100: latency (a row is
a few tens of KB and stays in cache; B blocks run).

``topk_threshold_reference`` is the plain twin (``topk_threshold_ref`` of
the JAX module): a stable descending sort of the same keys, the first k
re-sorted ascending.

``THRESHOLD_SELECT_MIN_S`` / ``THRESHOLD_SELECT_MIN_RATIO`` are the JAX
package's gate (a row of at least MIN_S, at least MIN_RATIO times k).  They
were tuned on a TPU v5e against XLA's TopK and are kept as they are;
re-deriving them against ``torch.sort`` on the H100 is open work.
"""

from __future__ import annotations

import torch

from frcnn_tpu_torch.ops.cuda import build

THRESHOLD_SELECT_MIN_S = 16384
THRESHOLD_SELECT_MIN_RATIO = 24


def sortable_keys(scores):
    """Order-preserving f32 → int32 map of ``_sortable_keys``: negative
    floats have their value bits flipped (-0.0 sorts below +0.0), and NaN
    maps to one key above +inf."""
    s = scores.float()
    u = s.view(torch.int32)
    keys = torch.where(u < 0, u ^ 0x7FFFFFFF, u)
    return torch.where(torch.isnan(s), torch.full_like(keys, 0x7FC00000), keys)


def topk_threshold_reference(scores, k: int):
    """(values (B, k), indices (B, k) int32): the top-k set, index-ascending."""
    order = torch.sort(sortable_keys(scores), dim=-1, descending=True, stable=True).indices
    idx = torch.sort(order[..., :k], dim=-1).values
    return torch.take_along_dim(scores, idx, dim=-1), idx.to(torch.int32)


def use_threshold_select(n: int, k: int) -> bool:
    """The gate of the JAX call sites: the kernel pays off on long rows."""
    return n >= THRESHOLD_SELECT_MIN_S and n >= THRESHOLD_SELECT_MIN_RATIO * k


def topk_threshold(scores, k: int):
    """Exact top-k of each row of ``scores`` (B, S) f32 in index-ascending
    order → (values (B, k) f32, indices (B, k) int32).  CPU tensors run the
    plain twin; CUDA tensors launch the kernel (one launch for the batch)."""
    b, s = scores.shape
    if not 1 <= k <= s:
        raise ValueError(f"k={k} out of range for row length {s}")
    if not scores.is_cuda:
        return topk_threshold_reference(scores, k)
    scores = scores.contiguous()
    build.check_cuda("topk_threshold scores", scores, torch.float32, (b, s))
    vals = torch.empty((b, k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((b, k), dtype=torch.int32, device=scores.device)
    build.launch("frcnn_topk_threshold", scores.data_ptr(), b, s, int(k), vals.data_ptr(),
                 idx.data_ptr())
    build.LAUNCH_COUNTS["select"] += 1
    return vals, idx
