"""K5: exact top-k set by threshold (radix select) — CUDA kernel wrapper and
its plain twin.

Replaces the TPU kernel ``frcnn_tpu/ops/pallas/select_kernel.py``
(``topk_threshold`` / ``_thresh_kernel``).  Contract: for scores (B, S) f32
and 1 <= k <= S, ``lax.top_k``'s set of each row — the lowest index wins a
tie at the cut, NaN counts as the largest value — in INDEX-ASCENDING order.
Callers that need descending order re-rank the k winners with a small
stable sort.

The kernel (``frcnn_tpu_torch/csrc/select_kernel.cu``) gives each row a
thread-block cluster: block j reads the j-th contiguous segment of the row
once into its shared memory, a radix select over the bytes of the sortable
keys finds the k-th largest key with integer histograms summed across the
cluster through distributed shared memory, and scans of the blocks' and
warps' counts place the selected indices in order.  Bound on the H100:
bytes by the count (the row read once), latency in fact (six cluster
barriers and the passes over shared memory).  ``select_plan`` is the launch
geometry: blocks a row, segment length, floats of shared memory a block.

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

CLUSTER_BLOCKS = 8            # blocks a row: the portable cluster size
MAX_SMEM_FLOATS = 56320       # 220 KB of dynamic shared memory a block
STATIC_SMEM_BYTES = 4 * 256 * 4 + 256   # the kernel's histograms and scan scratch


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


def threshold_route(scores) -> bool:
    """Whether a top-k call site takes the K5 route: on the card, where the
    JAX call sites ask for the TPU.  The row-length gate is
    ``use_threshold_select``'s."""
    return scores.is_cuda


def topk_descending(scores, k: int, use_threshold: bool = False):
    """``lax.top_k`` of each row of ``scores`` (B, S): (values (B, k),
    indices (B, k) int64) in descending order, the lowest index first on a
    tie.  With ``use_threshold`` and a row that passes the gate, the set
    comes from ``topk_threshold`` (index-ascending) and a stable descending
    sort of the k winners restores that order, bit for bit; else a stable
    sort of the whole row."""
    if use_threshold and use_threshold_select(scores.shape[1], k):
        tv, ti = topk_threshold(scores, k)
        vals, pos = torch.sort(tv, dim=1, descending=True, stable=True)
        return vals, torch.take_along_dim(ti.long(), pos, dim=1)
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def select_plan(s: int, cluster: int = CLUSTER_BLOCKS) -> dict:
    """Launch geometry for rows of length ``s``: ``cluster`` blocks a row,
    block j owning ``[j * segment, (j + 1) * segment)`` (a multiple of 4, so
    that every segment of a 16-byte aligned row starts 16-byte aligned), the
    first ``smem_floats`` of it in shared memory and the rest, if any, left
    in device memory."""
    segment = (-(-s // cluster) + 3) // 4 * 4
    return {"cluster": cluster, "segment": segment,
            "smem_floats": min(segment, MAX_SMEM_FLOATS)}


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
    plan = select_plan(s)
    build.launch("frcnn_topk_threshold", scores.data_ptr(), b, s, int(k), plan["cluster"],
                 plan["segment"], plan["smem_floats"], vals.data_ptr(), idx.data_ptr())
    build.LAUNCH_COUNTS["select"] += 1
    return vals, idx
