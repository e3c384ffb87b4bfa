"""The parts of the redesigned K5 and K3 kernels that a CPU can hold.

  * K5 (``csrc/select_kernel.cu``) splits each row over the blocks of a
    thread-block cluster.  ``emulate_cluster_select`` below repeats that
    decomposition in plain PyTorch: contiguous segments, one 256-bin
    histogram a segment and pass, merged across segments, a suffix scan that
    picks the digit, then exclusive scans of the segments' tie and selection
    counts.  It is held equal to the port's twin and to the JAX package's
    ``topk_threshold`` (Pallas, interpret mode) on rows whose ties straddle
    every segment boundary, with NaN of both signs, +-inf, -0.0, k = 1,
    k = S, S not a multiple of 4 and S below the cluster size.
  * The launch geometry the wrappers compute in Python (``select_plan``,
    ``fused_plan``) covers every main-path shape exactly and stays within
    the 232,448 bytes of shared memory a block may take.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frcnn_tpu.ops.pallas.select_kernel import topk_threshold as jax_topk_threshold
from frcnn_tpu_torch.ops.cuda import fused_block, select_kernel
from frcnn_tpu_torch.ops.cuda.select_kernel import (select_plan, sortable_keys,
                                                    topk_threshold_reference)

MAX_BLOCK_SMEM = 232448


def emulate_cluster_select(scores, k, cluster):
    """K5's decomposition, one row at a time → (values, indices int32)."""
    plan = select_plan(scores.shape[1], cluster)
    seg = plan["segment"]
    out_v, out_i = [], []
    for row in scores:
        s = row.shape[0]
        keys = (sortable_keys(row).to(torch.int64) & 0xFFFFFFFF) ^ 0x80000000   # unsigned order
        bounds = [(min(s, j * seg), min(s, (j + 1) * seg)) for j in range(cluster)]
        assert bounds[0][0] == 0 and bounds[-1][1] == s
        prefix, mask, need = 0, 0, k
        for shift in (24, 16, 8, 0):
            total = torch.zeros(256, dtype=torch.int64)
            for lo, hi in bounds:                       # a histogram a block, summed
                part = keys[lo:hi]
                digits = (part[(part & mask) == prefix] >> shift) & 0xFF
                total += torch.bincount(digits, minlength=256)
            incl = torch.flip(torch.cumsum(torch.flip(total, [0]), 0), [0])   # digit >= d
            excl = incl - total
            digit = int(torch.nonzero((excl < need) & (need <= incl)).item())
            need -= int(excl[digit])
            prefix |= digit << shift
            mask |= 0xFF << shift
        thr, r = prefix, need
        tie_run = slot_run = 0
        idx = torch.full((k,), -1, dtype=torch.int64)
        for lo, hi in bounds:                           # exclusive scans in block order
            part = keys[lo:hi]
            eq = part == thr
            rank = tie_run + torch.cumsum(eq.to(torch.int64), 0) - eq.to(torch.int64)
            sel = (part > thr) | (eq & (rank < r))
            where = torch.nonzero(sel).flatten() + lo
            idx[slot_run:slot_run + where.numel()] = where
            slot_run += int(where.numel())
            tie_run += int(eq.sum())
        assert slot_run == k
        out_i.append(idx)
        out_v.append(row[idx])
    return torch.stack(out_v), torch.stack(out_i).to(torch.int32)


def _neg_nan():
    return np.frombuffer(np.uint32(0xFFC00000).tobytes(), np.float32)[0]


@functools.lru_cache(maxsize=None)
def _select_case(case):
    """(rows (B, S) f32, k): S = 4099 is no multiple of 4, and no segment
    boundary of 1, 3, 8 or 16 blocks falls outside the long run of ties."""
    rng = np.random.RandomState(11)
    s = 4099
    if case == "run_across_segments":      # 2s, a run of 1s over every boundary, 0s
        x = np.ones((2, s), np.float32)
        x[:, :100], x[:, -100:] = 2.0, 0.0
        x[1] = x[1, ::-1]
        return x, 100 + (s - 200) // 2
    if case == "three_values":             # ties at the cut in every segment
        return rng.randint(0, 3, (3, s)).astype(np.float32), s // 2
    if case == "nan_inf_zero":
        x = rng.randint(-2, 3, (3, s)).astype(np.float32)
        x[0, ::97], x[0, 5] = np.nan, _neg_nan()
        x[1, ::13], x[1, 1::13] = np.inf, -np.inf
        x[2, ::2] = -0.0                   # -0.0 sorts below +0.0
        return x, 1500
    if case == "k_is_1":
        x = rng.randn(2, s).astype(np.float32)
        x[1] = 3.0                         # one repeated value: index 0 wins
        return x, 1
    if case == "k_is_s":
        return np.floor(rng.rand(2, s) * 4).astype(np.float32), s
    if case == "shorter_than_cluster":     # some blocks own nothing
        return np.array([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, -0.0, np.nan, 0.0, -1.0]], np.float32), 2
    raise KeyError(case)


@functools.lru_cache(maxsize=None)
def _jax_select(case):
    x, k = _select_case(case)
    vals, idx = jax_topk_threshold(jnp.asarray(x), k, interpret=True)
    return np.asarray(vals), np.asarray(idx)


SELECT_CASES = ("run_across_segments", "three_values", "nan_inf_zero", "k_is_1", "k_is_s",
                "shorter_than_cluster")


@pytest.mark.parametrize("cluster", [1, 3, 8, 16])
@pytest.mark.parametrize("case", SELECT_CASES)
def test_cluster_select_emulation_matches_twin_and_jax(case, cluster):
    x, k = _select_case(case)
    scores = torch.from_numpy(x.copy())
    vals, idx = emulate_cluster_select(scores, k, cluster)
    tv, ti = topk_threshold_reference(scores, k)
    assert torch.equal(idx, ti)
    assert torch.equal(vals.view(torch.int32), tv.view(torch.int32))   # value bits, NaN too
    jv, ji = _jax_select(case)
    np.testing.assert_array_equal(idx.numpy(), ji)
    np.testing.assert_array_equal(vals.numpy(), jv)                    # NaN == NaN here


def test_run_of_ties_crosses_every_segment_boundary():
    x, k = _select_case("run_across_segments")
    for cluster in (3, 8, 16):
        seg = select_plan(x.shape[1], cluster)["segment"]
        for j in range(1, cluster):
            assert x[0, j * seg - 1] == x[0, j * seg] == 1.0


# the seven (S, k) of K5's main-path launches: C4 train, FPN serving, FPN train
K5_MAIN_PATH = ((21888, 128), (21888, 256), (182400, 1000), (45600, 1000), (155520, 128),
                (155520, 256), (116736, 2000))


@pytest.mark.parametrize("s,k", K5_MAIN_PATH + ((50, 7), (4001, 4001), (16385, 1), (2000003, 9)))
def test_select_plan_covers_the_row(s, k):
    plan = select_plan(s)
    cluster, seg = plan["cluster"], plan["segment"]
    assert cluster == select_kernel.CLUSTER_BLOCKS <= 8            # the portable cluster size
    assert seg % 4 == 0 and seg * cluster >= s > (seg - 4) * cluster
    covered = sum(min(s, (j + 1) * seg) - min(s, j * seg) for j in range(cluster))
    assert covered == s
    assert plan["smem_floats"] == min(seg, select_kernel.MAX_SMEM_FLOATS)
    assert plan["smem_floats"] * 4 + select_kernel.STATIC_SMEM_BYTES <= MAX_BLOCK_SMEM
    if (s, k) in K5_MAIN_PATH:                                     # read from device memory once
        assert plan["smem_floats"] == seg


# (H, W, Cin, mid, projection) of K3's launches at the 800x1216 serving
# bucket and the 608x1024 train bucket
K3_MAIN_PATH = ((200, 304, 64, 64, True), (200, 304, 256, 64, False), (100, 152, 512, 128, False),
                (100, 152, 256, 128, True), (152, 256, 64, 64, True), (152, 256, 256, 64, False),
                (76, 128, 512, 128, False))


@pytest.mark.parametrize("h,w,cin,mid,proj", K3_MAIN_PATH + ((21, 37, 256, 64, False),
                                                             (1, 1, 512, 128, False)))
def test_fused_plan_covers_the_map(h, w, cin, mid, proj):
    plan = fused_block.fused_plan(h, w, mid, 4 * mid)
    th, tw = fused_block.TILE_H, fused_block.TILE_W
    assert (plan["tiles_y"] - 1) * th < h <= plan["tiles_y"] * th
    assert (plan["tiles_x"] - 1) * tw < w <= plan["tiles_x"] * tw
    # the flattened rows: whole 64-row wgmma tiles, the taps stay inside y1
    assert fused_block.PITCH == tw + 2
    assert fused_block.HALO_ROWS % 64 == 0 and fused_block.OUT_ROWS % 64 == 0
    assert fused_block.Y1_ROWS > fused_block.OUT_ROWS - 1 + 2 * fused_block.PITCH + 2 - 1
    assert fused_block.WARPGROUPS * 64 == fused_block.OUT_ROWS     # one output tile each
    assert plan["smem_bytes"] <= MAX_BLOCK_SMEM
