"""The redesigned RoIAlign backward kernels K2b / K6b
(``csrc/roi_align_kernel.cu``, ``roi_align_bwd_tile_kernel``) as far as a
CPU can hold them.

``emulate_backward`` repeats a block's work for every tile of the plan's
size: the roi list the tile keeps (``may_touch``, the kernel's division-free
test, in roi order, only the rois of the tile's level), the rounds of at
most ``batch`` rois whose staged bin rectangles fit ``stage_bins``, per tile
row and bin row the weight Ay (the bin row's samples whose low or high index
is the row, summed low before high in sample order) and the same Ax per
column, the adds ``acc + Ay * (row + Ax * dOut)`` in the order roi, bin row,
bin column, and one scaling by 1 / sr^2 and rounding at the end.  It is held

  (a) within 1e-5 of max|reference| of the plain twin and of ``jax.vjp`` of
      the Pallas kernel in interpret mode and of the plain ``roi_align`` (one
      bf16 ulp of max|twin| in bf16); the multilevel case against
      ``roi_align_multilevel``'s vjp;
  (b) so that every live sample corner of every roi lands in a tile that
      keeps the roi: counted over all tiles, each is added exactly once;
  (c) so that on one level the multilevel emulation equals the single-level
      one bit for bit, and no plan changes a bit;
  (d) on a roi wholly outside the map, a zero-size roi, padding rois, a
      level outside [0, L), C not a multiple of 8 and ragged edge tiles (38
      and 19 rows);

and (e) ``roi_bwd_plan`` fits a block's shared memory.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from frcnn_tpu.ops.pallas.roi_align_kernel import roi_align_pallas
from frcnn_tpu.ops.roi_align import roi_align as jax_roi_align
from frcnn_tpu.ops.roi_align import roi_align_multilevel as jax_roi_align_multilevel
from frcnn_tpu_torch.ops.cuda import roi_align_kernel as rk
from frcnn_tpu_torch.ops.cuda.roi_align_kernel import (roi_align_backward_reference,
                                                       roi_align_multilevel_backward_reference,
                                                       roi_bwd_plan, roi_bwd_smem_bytes)

P, SR = 7, 2
HWS = ((38, 20), (19, 12))          # ragged: 38 and 19 rows are no multiple of 8
STRIDES = (8, 16)


def may_touch(edge_lo, edge_hi, scale, size, lo_b, hi_b):
    """``roi_axis_may_touch``: whether the samples of one axis may touch an
    index in [lo_b, hi_b], in f32 and without a division."""
    f = np.float32
    lo, hi = f(edge_lo) * f(scale), f(edge_hi) * f(scale)
    end = lo + max(hi - lo, f(1.0))
    if not (end >= -2.0 and lo <= size + 1.0):
        return False
    a, e = min(max(lo, f(-1.0)), f(size)), min(max(end, f(-1.0)), f(size))
    return int(np.floor(a)) - 1 <= hi_b and int(np.floor(e)) + 2 >= lo_b


def axis_weights(low, high, w_lo, w_hi, at):
    """(len(at), P) f32: for each index in ``at`` and bin, the sum of the
    weights of the bin's samples whose low or high index is that index, in
    sample order, low before high (the kernel adds only where they match;
    adding 0.0 instead leaves a non-negative sum's bits as they are)."""
    a = torch.zeros((len(at), P), dtype=torch.float32)
    at = torch.as_tensor(at)[:, None]
    for iy in range(SR):
        s = torch.arange(P) * SR + iy
        a = a + torch.where(low[s][None] == at, w_lo[s][None], 0.0)
        a = a + torch.where(high[s][None] == at, w_hi[s][None], 0.0)
    return a


def bin_rect(ay, ax):
    """The rectangle of bins a roi stages for a tile: (rows, columns) of the
    bins with a non-zero weight on some tile row and column, else 0."""
    ys, xs = (torch.nonzero(m.any(0)).flatten() for m in (ay != 0, ax != 0))
    if len(ys) == 0 or len(xs) == 0:
        return 0
    return (ys.max() - ys.min() + 1).item() * (xs.max() - xs.min() + 1).item()


def emulate_backward(dout, rois, levels, hws, scales, plan):
    """→ (a list of (B, H_l, W_l, C) dF in dout's dtype, {(level, image,
    tile): kept roi indices}, the rounds of the busiest tile, the most bins
    a round staged)."""
    b, r, _, _, c = dout.shape
    th, tw = plan["tile_h"], plan["tile_w"]
    d32 = dout.float()
    inv_count = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(SR * SR))
    grads, kept_by_tile, most_rounds, most_bins = [], {}, 0, 0
    for li, ((h, w), scale) in enumerate(zip(hws, scales)):
        ys, xs = rk._geometry(rois, h, w, P, SR, scale)
        out = torch.zeros((b, h, w, c), dtype=torch.float32)
        for bi in range(b):
            for y0 in range(0, h, th):
                for x0 in range(0, w, tw):
                    y1, x1 = min(h, y0 + th) - 1, min(w, x0 + tw) - 1
                    kept = [ri for ri in range(r) if levels[bi, ri] == li
                            and may_touch(rois[bi, ri, 1], rois[bi, ri, 3], scale, h, y0, y1)
                            and may_touch(rois[bi, ri, 0], rois[bi, ri, 2], scale, w, x0, x1)]
                    kept_by_tile[li, bi, y0 // th, x0 // tw] = kept
                    rows, cols = torch.arange(y0, y0 + th), torch.arange(x0, x0 + tw)
                    weights = [(axis_weights(*(t[bi, ri] for t in ys), rows),
                                axis_weights(*(t[bi, ri] for t in xs), cols)) for ri in kept]
                    rounds, k0 = 0, 0                # rounds: a prefix of the batch that fits
                    while k0 < len(kept):
                        areas = np.cumsum([bin_rect(*wt) for wt in
                                           weights[k0:k0 + plan["batch"]]])
                        n = int((areas <= plan["stage_bins"]).sum())
                        assert n >= 1
                        most_bins = max(most_bins, int(areas[n - 1]))
                        k0, rounds = k0 + n, rounds + 1
                    most_rounds = max(most_rounds, rounds)
                    acc = torch.zeros((th, tw, c), dtype=torch.float32)
                    for ri, (ay, ax) in zip(kept, weights):
                        for py in range(P):
                            row = torch.zeros((tw, c), dtype=torch.float32)
                            for px in range(P):
                                row = row + ax[:, px, None] * d32[bi, ri, py, px][None]
                            acc = acc + ay[:, py, None, None] * row[None]
                    out[bi, y0:y1 + 1, x0:x1 + 1] = (acc * inv_count)[:y1 - y0 + 1, :x1 - x0 + 1]
        grads.append(out.to(dout.dtype))
    return grads, kept_by_tile, most_rounds, most_bins


def live_corners(rois, levels, li, h, w, scale):
    """{(image, roi): [(y, x) of every live sample corner]} on level li (a
    sample is live on both axes; both indices of each axis count)."""
    (yl, yh, wyl, wyh), (xl, xh, wxl, wxh) = rk._geometry(rois, h, w, P, SR, scale)
    out = {}
    for bi, ri in zip(*np.nonzero(levels == li)):
        ly = ((wyl[bi, ri] != 0) | (wyh[bi, ri] != 0)).tolist()
        lx = ((wxl[bi, ri] != 0) | (wxh[bi, ri] != 0)).tolist()
        out[bi, ri] = [(y, x) for sy in range(P * SR) if ly[sy]
                       for y in (yl[bi, ri, sy].item(), yh[bi, ri, sy].item())
                       for sx in range(P * SR) if lx[sx]
                       for x in (xl[bi, ri, sx].item(), xh[bi, ri, sx].item())]
    return out


@functools.lru_cache(maxsize=None)
def _case(c):
    """(dout (B, R, P, P, C) f32, rois (B, R, 4) on a 152x160 image, levels
    (B, R) over HWS: every edge case on both levels, one level outside)."""
    rng = np.random.RandomState(8)
    b, r = 2, 24
    x1, y1 = rng.uniform(-20, 140, (b, r)), rng.uniform(-20, 130, (b, r))
    rois = np.stack([x1, y1, x1 + rng.uniform(2, 90, (b, r)), y1 + rng.uniform(2, 90, (b, r))], -1)
    rois[:, 0] = [-900.0, -900.0, -700.0, -800.0]                # wholly outside
    rois[:, 1, 2:] = rois[:, 1, :2]                              # zero size
    rois[:, 2:5] = 0.0                                           # padding
    rois[:, 5] = [0.0, 0.0, 159.0, 151.0]                        # the whole map
    rois[:, 6, 2:] = rois[:, 6, :2] - 20.0                       # inverted corners
    levels = rng.randint(0, 2, (b, r)).astype(np.int32)
    levels[:, 0:6:2] = 0
    levels[:, 1:6:2] = 1
    levels[:, 7] = [2, -1]                                       # outside [0, L): adds nothing
    dout = rng.randn(b, r, P, P, c).astype(np.float32)
    return dout, rois.astype(np.float32), levels


def _tolerance(dtype, want):
    scale = max(np.abs(np.asarray(want, np.float32)).max(), 1e-12)
    return 1e-5 * scale if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(scale)) - 7)


def _bits_equal(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int8), b.view(torch.int8))


@pytest.mark.parametrize("c,dtype,tile,batch,bins", [
    (16, torch.float32, (8, 8), 8, 56),
    (16, torch.bfloat16, (8, 8), 8, 56),
    (9, torch.bfloat16, (8, 8), 8, 56),            # C no multiple of 8: one channel a thread
    (16, torch.float32, (16, 4), 2, 49)])           # one roi's bins a round at most
def test_backward_emulation_matches_twin_and_jax(c, dtype, tile, batch, bins):
    dout_np, rois_np, levels_np = _case(c)
    dout, rois = torch.from_numpy(dout_np).to(dtype), torch.from_numpy(rois_np)
    plan = roi_bwd_plan(c, dout.element_size(), tile=tile, batch=batch, stage_bins=bins)
    assert plan["vec"] == (1 if c == 9 else 16 // dout.element_size())
    on_level0 = np.zeros_like(levels_np)
    for (h, w), stride in zip(HWS, STRIDES):       # K2b: every roi on one map
        (got,), _, rounds, most = emulate_backward(dout, rois, on_level0, [(h, w)],
                                                   [1.0 / stride], plan)
        twin = roi_align_backward_reference(dout, rois, (h, w), P, 1.0 / stride, SR)
        assert got.dtype == dtype and got.shape == twin.shape
        assert (got.float() - twin.float()).abs().max().item() <= _tolerance(dtype, twin.float())
        assert rounds >= 2 and most <= bins
        if dtype != torch.float32:
            continue
        feat = np.zeros((h, w, c), np.float32)
        for i in range(dout.shape[0]):
            ro, g = jnp.asarray(rois_np[i]), jnp.asarray(dout_np[i])
            _, vjp_pallas = jax.vjp(lambda x: roi_align_pallas(x, ro, P, 1.0 / stride, SR, True),
                                    jnp.asarray(feat))
            _, vjp_plain = jax.vjp(lambda x: jax_roi_align(x, ro, P, 1.0 / stride, SR),
                                   jnp.asarray(feat))
            for want in (vjp_pallas(g)[0], vjp_plain(g)[0]):
                assert np.abs(got[i].numpy() - np.asarray(want)).max() <= _tolerance(dtype, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multilevel_emulation_matches_twin_and_jax(dtype):
    dout_np, rois_np, levels_np = _case(16)
    dout, rois = torch.from_numpy(dout_np).to(dtype), torch.from_numpy(rois_np)
    plan = roi_bwd_plan(16, dout.element_size())
    scales = [1.0 / s for s in STRIDES]
    got, _, _, _ = emulate_backward(dout, rois, levels_np, HWS, scales, plan)
    twin = roi_align_multilevel_backward_reference(dout, rois, torch.from_numpy(levels_np),
                                                   HWS, STRIDES, P, SR)
    tol = _tolerance(dtype, np.concatenate([t.float().flatten().numpy() for t in twin]))
    for g, t in zip(got, twin):
        assert g.dtype == dtype and (g.float() - t.float()).abs().max().item() <= tol
    if dtype != torch.float32:
        return
    # the JAX function takes levels in [0, L): the roi outside gets level 0
    # and a zero gradient there, which adds nothing, as the twin's level does
    outside = (levels_np < 0) | (levels_np >= len(HWS))
    jax_levels = np.where(outside, 0, levels_np)
    jax_dout = dout_np * ~outside[..., None, None, None]
    for i in range(dout.shape[0]):
        feats = [jnp.zeros((h, w, 16), jnp.float32) for h, w in HWS]
        _, vjp = jax.vjp(lambda fs: jax_roi_align_multilevel(
            fs, jnp.asarray(rois_np[i]), jnp.asarray(jax_levels[i]), STRIDES), feats)
        (want,) = vjp(jnp.asarray(jax_dout[i]))
        for li in range(len(HWS)):
            assert np.abs(got[li][i].numpy() - np.asarray(want[li])).max() <= tol


@pytest.mark.parametrize("tile", [(8, 8), (16, 4), (3, 5)])
def test_every_live_corner_lands_in_a_tile_that_keeps_its_roi(tile):
    """Counted over all tiles, the live sample corners of the rois each tile
    keeps that lie inside the tile add up to every live corner of every roi
    once; a roi whose samples are all empty (wholly outside, on a level
    outside [0, L)) is kept by no tile."""
    dout_np, rois_np, levels_np = _case(9)
    dout, rois = torch.from_numpy(dout_np[:, :, :, :, :1]), torch.from_numpy(rois_np)
    plan = roi_bwd_plan(1, 4, tile=tile)
    scales = [1.0 / s for s in STRIDES]
    _, kept_by_tile, _, _ = emulate_backward(dout, rois, levels_np, HWS, scales, plan)
    th, tw = tile
    for li, ((h, w), scale) in enumerate(zip(HWS, scales)):
        corners = live_corners(rois, levels_np, li, h, w, scale)
        total = sum(len(v) for v in corners.values())
        counted = 0
        for (lv, bi, ty, tx), kept in kept_by_tile.items():
            if lv != li:
                continue
            for ri in kept:
                counted += sum(ty * th <= y < (ty + 1) * th and tx * tw <= x < (tx + 1) * tw
                               for y, x in corners.get((bi, ri), []))
        assert counted == total and total > 0
    assert not live_corners(rois, levels_np, 0, *HWS[0], scales[0])[0, 0]   # wholly outside
    assert not any(ri in kept for kept in kept_by_tile.values() for ri in (0, 7))


def test_multilevel_on_one_level_equals_single_level_bit_for_bit():
    dout_np, rois_np, _ = _case(16)
    dout, rois = torch.from_numpy(dout_np).to(torch.bfloat16), torch.from_numpy(rois_np)
    scales = [1.0 / s for s in STRIDES]
    plan = roi_bwd_plan(16, 2)
    on_one = np.ones(dout.shape[:2], np.int32)
    multi, _, _, _ = emulate_backward(dout, rois, on_one, HWS, scales, plan)
    (single,), _, _, _ = emulate_backward(dout, rois, on_one * 0, HWS[1:], scales[1:], plan)
    assert _bits_equal(multi[1], single) and not multi[0].any()
    other = roi_bwd_plan(16, 2, tile=(3, 5), batch=1, stage_bins=49)   # no plan changes a bit
    (again,), _, _, _ = emulate_backward(dout, rois, on_one * 0, HWS[1:], scales[1:], other)
    assert _bits_equal(again, single)


def test_edge_rois_add_exactly_what_the_twin_adds():
    """A roi wholly outside, a zero-size roi and padding rois, each alone:
    the same dF as the twin's (zeros for the one outside)."""
    dout_np, rois_np, _ = _case(16)
    plan = roi_bwd_plan(16, 4)
    (h, w), scale = HWS[0], 1.0 / STRIDES[0]
    for ri in (0, 1, 2):
        dout = torch.from_numpy(dout_np[:, ri:ri + 1].copy())
        rois = torch.from_numpy(rois_np[:, ri:ri + 1].copy())
        (got,), _, _, _ = emulate_backward(dout, rois, np.zeros((2, 1), np.int32), [(h, w)],
                                           [scale], plan)
        twin = roi_align_backward_reference(dout, rois, (h, w), P, scale, SR)
        assert (got - twin).abs().max().item() <= _tolerance(torch.float32, twin)
        assert bool(got.any()) == bool(twin.any()) == (ri != 0)


@pytest.mark.parametrize("element_size", [4, 2])
@pytest.mark.parametrize("c", [256, 1024])
def test_roi_bwd_plan_fits_a_block(c, element_size):
    plan = roi_bwd_plan(c, element_size)
    vec, chunk = plan["vec"], plan["chunk"]
    assert vec == 16 // element_size and chunk % vec == 0 and vec <= chunk <= c
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 512
    assert 1 <= plan["batch"] <= 32 and plan["stage_bins"] >= P * P
    assert plan["smem_bytes"] == roi_bwd_smem_bytes(
        element_size, plan["tile_h"], plan["tile_w"], chunk, P, SR, plan["batch"],
        plan["stage_bins"], plan["threads"])
    assert plan["smem_bytes"] % 16 == 0 and plan["smem_bytes"] <= rk.MAX_BLOCK_SMEM
    assert -(-c // chunk) <= 65535
    with pytest.raises(ValueError):                 # 35 samples an axis
        roi_bwd_plan(c, element_size, sampling_ratio=5)
