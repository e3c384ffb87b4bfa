"""The parts of the redesigned K2 kernel (``csrc/roi_align_kernel.cu``, shared
by K6) that a CPU can hold.

  * ``stage_list`` repeats ``roi_stage_list`` sample by sample: from the
    (low, high) index pairs of an axis' samples it builds the ascending list of
    distinct map rows (or columns) the live samples touch, deciding "new entry
    or repeat" only from the previous sample's high index, as the kernel's
    ballots do, and rewrites each pair as positions in that list.
  * ``emulate_staged_roi_align`` repeats the block's work: the two lists, a
    staged ``[rows][cols][channels]`` buffer of the plan's size filled in as
    many passes as the roi's distinct pixels need, and every bin pooled from
    the buffer through the remapped positions.  It is held bit-equal to pooling
    straight from the map with the same arithmetic, and within 1e-5 of
    max|reference| of the port's twin and of the JAX package's ``roi_align``.
  * ``roi_plan`` stays within the shared memory a block may take.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frcnn_tpu.ops.roi_align import roi_align as jax_roi_align
from frcnn_tpu_torch.ops.cuda import roi_align_kernel
from frcnn_tpu_torch.ops.cuda.roi_align_kernel import (roi_align_reference, roi_plan,
                                                       staged_pixels)

MAX_BLOCK_SMEM = 232448
P, SR, SCALE = 7, 2, 1.0 / 16.0


def stage_list(low, high, w_lo, w_hi):
    """One axis of one roi: (the distinct indices in ascending order, the
    samples' (low, high) as positions in that list).  An empty sample (both
    weights zero) touches nothing and points at position 0."""
    entries, pos = [], []
    prev_live, prev_hi = False, 0
    for lo, hi, a, b in zip(low.tolist(), high.tolist(), w_lo.tolist(), w_hi.tolist()):
        live = not (a == 0.0 and b == 0.0)
        if not live:
            pos.append((0, 0))
            prev_live = False
            continue
        n0 = len(entries)
        new_lo = not prev_live or lo > prev_hi
        last = prev_hi if prev_live and prev_hi > lo else lo    # the last entry once lo is in
        new_hi = hi > last
        if new_lo:
            entries.append(lo)
        n1 = len(entries)
        if new_hi:
            entries.append(hi)
        p_lo = n0 if new_lo else (n0 - 1 if lo == prev_hi else n0 - 2)
        p_hi = n1 if new_hi else (n1 - 1 if hi == last else n1 - 2)
        pos.append((p_lo, p_hi))
        prev_live, prev_hi = True, hi
    return entries, pos


def pool_bins(f, y_pos, x_pos, y_w, x_w):
    """The kernel's arithmetic on a channels-last (rows, cols, C) f32 array:
    every bin the mean of its SR x SR bilinear samples, each interpolated
    along x, then along y, summed in the order (iy, ix) → (P, P, C)."""
    out = torch.zeros((P, P, f.shape[-1]), dtype=torch.float32)
    for py in range(P):
        for px in range(P):
            acc = torch.zeros(f.shape[-1], dtype=torch.float32)
            for iy in range(SR):
                (yl, yh), (wyl, wyh) = y_pos[py * SR + iy], y_w[py * SR + iy]
                for ix in range(SR):
                    (xl, xh), (wxl, wxh) = x_pos[px * SR + ix], x_w[px * SR + ix]
                    top = wxh * f[yl, xh] + wxl * f[yl, xl]
                    bot = wxh * f[yh, xh] + wxl * f[yh, xl]
                    acc = acc + (wyh * bot + wyl * top)
            out[py, px] = acc * (1.0 / (SR * SR))
    return out


def _axis(ys, b, r):
    low, high, w_lo, w_hi = (t[b, r] for t in ys)
    return low, high, w_lo.float(), w_hi.float()


def emulate_staged_roi_align(feat, rois, plan):
    """→ (staged result, result pooled straight from the map, pixels staged a
    roi, passes a roi took for its first channel chunk)."""
    b, h, w, c = feat.shape
    r = rois.shape[1]
    vec, chunk = plan["vec"], plan["chunk"]
    stage_elems = plan["smem_bytes"] // feat.element_size()
    ys, xs = roi_align_kernel._geometry(rois, h, w, P, SR, SCALE)
    staged = torch.zeros((b, r, P, P, c), dtype=torch.float32)
    direct = torch.zeros_like(staged)
    pixels = torch.zeros((b, r), dtype=torch.long)
    passes = torch.zeros((b, r), dtype=torch.long)
    for bi in range(b):
        f32 = feat[bi].float()
        for ri in range(r):
            yl, yh, wyl, wyh = _axis(ys, bi, ri)
            xl, xh, wxl, wxh = _axis(xs, bi, ri)
            y_w = list(zip(wyl.tolist(), wyh.tolist()))
            x_w = list(zip(wxl.tolist(), wxh.tolist()))
            direct[bi, ri] = pool_bins(f32, list(zip(yl.tolist(), yh.tolist())),
                                       list(zip(xl.tolist(), xh.tolist())), y_w, x_w)
            rows, y_pos = stage_list(yl, yh, wyl, wyh)
            cols, x_pos = stage_list(xl, xh, wxl, wxh)
            for lst, lo_i, hi_i, a, bb in ((rows, yl, yh, wyl, wyh), (cols, xl, xh, wxl, wxh)):
                live = (a != 0) | (bb != 0)
                assert lst == sorted(set(lo_i[live].tolist()) | set(hi_i[live].tolist()))
            n_pix = len(rows) * len(cols)
            pixels[bi, ri] = n_pix
            if n_pix == 0:
                continue                                  # the roi pools zeros
            for c0 in range(0, c, chunk):                 # a block a chunk of channels
                c1 = min(c, c0 + chunk)
                sub = min(c1 - c0, stage_elems // n_pix // vec * vec)
                assert sub >= vec                         # the buffer serves any roi
                for cs in range(c0, c1, sub):
                    cur = min(sub, c1 - cs)
                    assert n_pix * cur <= stage_elems
                    stage = f32[rows][:, cols][:, :, cs:cs + cur].contiguous()
                    staged[bi, ri, :, :, cs:cs + cur] = pool_bins(stage, y_pos, x_pos, y_w, x_w)
                    if c0 == 0:
                        passes[bi, ri] += 1
    return staged.to(feat.dtype), direct.to(feat.dtype), pixels, passes


@functools.lru_cache(maxsize=None)
def _case(c):
    """(feat (B, H, W, C) f32, rois (B, R, 4)) on a 20 x 40 map of stride 16."""
    rng = np.random.RandomState(5)
    b, h, w, r = 2, 20, 40, 20
    size_x, size_y = w * 16.0, h * 16.0
    x1 = rng.uniform(0, size_x - 40, (b, r))
    y1 = rng.uniform(0, size_y - 40, (b, r))
    rois = np.stack([x1, y1, np.minimum(x1 + rng.uniform(8, 200, (b, r)), size_x - 1),
                     np.minimum(y1 + rng.uniform(8, 200, (b, r)), size_y - 1)], -1)
    rois[:, 0:3] = rng.uniform(-300, size_x + 300, (b, 3, 4))     # partly / wholly outside
    rois[:, 3] = [-900.0, -900.0, -700.0, -800.0]                # wholly outside: zeros
    rois[:, 4, 2:] = rois[:, 4, :2]                              # degenerate (zero size)
    rois[:, 5] = 0.0                                             # padding
    rois[:, 6, 2:] = rois[:, 6, :2] - 30.0                       # inverted corners
    rois[:, 7] = [8.0, 40.0, size_x - 9.0, 300.0]                # 39 columns: no pixel shared
    rois[:, 8, 2:] = rois[:, 8, :2] + 1.0                        # one pixel
    rois[:, 9] = [0.0, 0.0, size_x - 1.0, size_y - 1.0]          # the whole map
    feat = rng.randn(b, h, w, c).astype(np.float32)
    return feat, rois.astype(np.float32)


@pytest.mark.parametrize("c,dtype,smem_kb", [(16, torch.float32, None), (16, torch.float32, 13),
                                             (24, torch.bfloat16, None), (24, torch.bfloat16, 7),
                                             (9, torch.float32, None), (9, torch.bfloat16, 2)])
def test_staged_roi_align_emulation(c, dtype, smem_kb):
    """Odd C takes one channel a thread; a small buffer makes the wide rois
    take their chunk in several passes."""
    feat_np, rois_np = _case(c)
    feat, rois = torch.from_numpy(feat_np).to(dtype), torch.from_numpy(rois_np)
    plan = roi_plan(c, feat.element_size(), P, SR)
    plan["chunk"] = 2 * plan["vec"] if plan["vec"] > 1 else 4
    if c == 9:
        assert plan["vec"] == 1
    if smem_kb is not None:
        plan["smem_bytes"] = max(smem_kb * 1024, (2 * P * SR) ** 2 * plan["vec"]
                                 * feat.element_size())
    staged, direct, pixels, passes = emulate_staged_roi_align(feat, rois, plan)
    assert torch.equal(staged, direct)                   # the staging changes no bit
    assert torch.equal(pixels, staged_pixels(rois, 20, 40, P, SCALE, SR))
    assert (pixels[:, 3] == 0).all() and not staged[:, 3].any()      # wholly outside
    assert (pixels[:, 7] >= 28 * 2).all()                # 14 samples, 28 distinct columns
    assert (pixels <= (2 * P * SR) ** 2).all()
    if smem_kb is not None:
        assert passes.max() > 1 and passes[:, 8].max() == 1
    else:
        assert passes.max() == 1

    twin = roi_align_reference(feat, rois, P, SCALE, SR)
    scale = twin.float().abs().max().item()
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert (staged.float() - twin.float()).abs().max().item() <= tol
    if dtype == torch.float32:
        for i in range(feat.shape[0]):
            want = np.asarray(jax_roi_align(jnp.asarray(feat_np[i]), jnp.asarray(rois_np[i]),
                                            P, SCALE, SR, chunk=rois_np.shape[1]))
            assert np.abs(staged[i].numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_stage_list_on_hand_made_axes():
    f = torch.tensor
    # samples share pixels: (3,4) (3,4) (4,5) (5,5: clamped at the edge) and an empty one
    rows, pos = stage_list(f([3, 3, 4, 5, 0]), f([4, 4, 5, 5, 0]),
                           f([.5, .25, .5, 1., 0.]), f([.5, .75, .5, 0., 0.]))
    assert rows == [3, 4, 5] and pos == [(0, 1), (0, 1), (1, 2), (2, 2), (0, 0)]
    # no sharing at all: a sample every third pixel
    rows, pos = stage_list(f([0, 3, 6]), f([1, 4, 7]), f([.5] * 3), f([.5] * 3))
    assert rows == [0, 1, 3, 4, 6, 7] and pos == [(0, 1), (2, 3), (4, 5)]
    # every sample empty
    assert stage_list(f([0, 0]), f([0, 0]), f([0., 0.]), f([0., 0.])) == ([], [(0, 0), (0, 0)])
    # a weight of exactly zero on one side keeps the sample live
    rows, pos = stage_list(f([2, 2]), f([3, 3]), f([1., 0.]), f([0., 1.]))
    assert rows == [2, 3] and pos == [(0, 1), (0, 1)]


@pytest.mark.parametrize("element_size", [4, 2])
@pytest.mark.parametrize("c", [256, 1024, 1023, 33, 8])
def test_roi_plan_fits_a_block(c, element_size):
    plan = roi_plan(c, element_size)
    vec, chunk, threads, smem = (plan[k] for k in ("vec", "chunk", "threads", "smem_bytes"))
    assert vec == (16 // element_size if c % (16 // element_size) == 0 else 1)
    assert vec <= chunk <= c and chunk % vec == 0
    assert threads % 32 == 0 and 32 <= threads <= 512
    assert smem % 16 == 0
    assert smem >= (2 * P * SR) ** 2 * vec * element_size     # any roi fits in passes of vec
    assert smem + roi_align_kernel.GEOMETRY_SMEM_BYTES <= MAX_BLOCK_SMEM
    assert -(-c // chunk) <= 65535                            # the grid's x extent


def test_roi_plan_refuses_too_many_samples():
    with pytest.raises(ValueError):
        roi_plan(256, 2, output_size=7, sampling_ratio=5)     # 35 samples an axis
    assert roi_plan(256, 2, output_size=14, sampling_ratio=2)["smem_bytes"] >= 56 * 56 * 16
