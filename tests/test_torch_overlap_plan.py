"""The redesigned anchor-overlap kernel K4 (``csrc/overlap_kernel.cu``,
``overlap_stats_kernel``) as far as a CPU can hold it.

``emulate_overlap`` repeats the kernel's work under a plan: the cluster's
segments and the warps' chunks of 32 anchors, the image's
valid gts compacted in index order, the cull of each chunk (the bounding
box of its inside anchors against every compacted gt, in the IoU's own f32
arithmetic), the survivors' IoUs in index order (the first compacted gt that
reaches the maximum wins; no survivor above 0 gives 0 at the lowest valid
index), each block's per-gt maximum over its survivors from 0, the cluster's
maximum, and the tie pass over the survivors whose block maximum is the
cluster's.  It is held

  (a) bit for bit (``torch.equal``, all three outputs) to the plain twin
      ``anchor_overlap_stats_reference``;
  (b) to the JAX dense form and to the Pallas ``anchor_overlap_stats`` in
      interpret mode: argmax and ties equal, max within 2e-7;
  (c) so that no culled (anchor, gt) pair has inter > 0 in the twin's
      arithmetic, counted over every chunk;
  (d) on real anchor tables (C4, and FPN P2-P6, at a small bucket), on
      random anchors and boxes (also under hypothesis), and on the edge
      cases: a gt edge that touches a chunk's box exactly (iw = 0 or ih = 0:
      culled) or overlaps it by one pixel, duplicated gts, anchor copies of a
      gt, a gt that overlaps nothing, an image with no valid gt, a chunk with
      no inside anchor, K no multiple of the chunk or the segment;

and (e) ``overlap_plan`` covers every anchor exactly once (block, warp,
chunk, lane) and fits a block's shared memory.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from frcnn_tpu.ops.boxes import bbox_overlaps as jax_bbox_overlaps
from frcnn_tpu.ops.pallas.overlap_kernel import anchor_overlap_stats as jax_overlap_stats
from frcnn_tpu_torch.ops.anchors import generate_anchors_pre
from frcnn_tpu_torch.ops.cuda.overlap_kernel import (MAX_MASK_BYTES,
                                                     anchor_overlap_stats_reference,
                                                     overlap_plan)
from tests.conftest import random_boxes

SMEM_BYTES = 232448       # the shared memory a block may have on an H100
STATIC_SMEM_BYTES = 2064  # the kernel's static arrays (ptxas)


def box_area(b):
    return (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)


def extents(a, g):
    """(iw, ih) of boxes a (..., 4) against g (..., 4), broadcast, in
    ``bbox_overlaps``' f32 operation order."""
    iw = torch.minimum(a[..., 2], g[..., 2]) - torch.maximum(a[..., 0], g[..., 0]) + 1.0
    ih = torch.minimum(a[..., 3], g[..., 3]) - torch.maximum(a[..., 1], g[..., 1]) + 1.0
    return iw, ih


def iou(a, g):
    iw, ih = extents(a, g)
    inter = torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)
    union = box_area(a) + box_area(g) - inter
    return torch.where(inter > 0, inter / union, torch.zeros_like(inter)), inter


def emulate_overlap(anchors, gt, valid, inside, plan):
    """→ ((max_overlaps, argmax, is_gt_argmax) as the kernel writes them,
    stats): stats["survivors"] the survivors of each chunk of each image,
    stats["culled_live"] the culled (inside anchor, valid gt) pairs whose
    inter is > 0 in the twin's arithmetic (the cull must make none)."""
    b, k = inside.shape
    chunk, seg = 32, plan["segment"]
    nch = -(-k // chunk)
    pad = nch * chunk - k
    a = torch.cat([anchors.float(), torch.zeros(pad, 4)]).reshape(nch, chunk, 4)
    rank = torch.arange(nch) * chunk // seg          # the block of each chunk
    max_ov = torch.full((b, k), float("nan"))
    argmax = torch.full((b, k), -7, dtype=torch.int32)
    is_ga = torch.zeros((b, k), dtype=torch.bool)
    survivors, culled_live = [], 0
    for bi in range(b):
        orig = torch.nonzero(valid[bi]).flatten()                 # compaction, in index order
        boxes, nv = gt[bi, orig].float(), len(orig)
        inn = torch.cat([inside[bi], torch.zeros(pad, dtype=torch.bool)]).reshape(nch, chunk)
        inn = inn & (nv > 0)
        # the cull: the box of each chunk's inside anchors against every gt
        big = torch.tensor(float("inf"))
        box = torch.stack([torch.where(inn, a[..., 0], big).amin(1),
                           torch.where(inn, a[..., 1], big).amin(1),
                           torch.where(inn, a[..., 2], -big).amax(1),
                           torch.where(inn, a[..., 3], -big).amax(1)], 1)
        iw, ih = extents(box[:, None, :], boxes[None, :, :])
        surv = (iw > 0) & (ih > 0) & inn.any(1)[:, None]            # (nch, nv)
        survivors.append(surv.sum(1))
        v, inter = iou(a[:, :, None, :], boxes[None, None, :, :])   # (nch, chunk, nv)
        culled_live += int(((inter > 0) & inn[..., None] & ~surv[:, None, :]).sum())
        v = torch.where(surv[:, None, :] & inn[..., None], v, 0.0)  # survivors only pay
        mx = torch.zeros((nch, chunk))
        am = torch.full((nch, chunk), -1)
        for j in range(nv):                                          # index order, strict >
            better = v[..., j] > mx
            mx, am = torch.where(better, v[..., j], mx), torch.where(better, j, am)
        first = orig[0] if nv else 0
        am_orig = torch.where(am >= 0, orig[am.clamp(min=0)] if nv else 0, first)
        max_ov[bi] = torch.where(inn, mx, -1.0).flatten()[:k]
        argmax[bi] = torch.where(inn, am_orig, 0).flatten()[:k].to(torch.int32)
        # block maxima over the survivors (from 0), the cluster's, the candidates
        warp_max = torch.where(surv, v.amax(1), 0.0)                 # (nch, nv)
        blk = torch.stack([warp_max[rank == r].amax(0) if (rank == r).any() else torch.zeros(nv)
                           for r in range(plan["cluster"])])
        gmax = blk.amax(0)
        cand = (gmax > 0) & (blk == gmax)                            # (cluster, nv)
        m = surv & cand[rank]                                        # the tie pass's gts
        tie = (m[:, None, :] & inn[..., None] & (v == gmax)).any(2)
        is_ga[bi] = tie.flatten()[:k]
    return (max_ov, argmax, is_ga), {"survivors": survivors, "culled_live": culled_live}


def assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def fpn_anchors(h, w):
    levels = [(-(-h // 2 ** lv), -(-w // 2 ** lv)) for lv in range(2, 7)]
    return np.concatenate([generate_anchors_pre(fh, fw, 2 ** lv, scales=(8.0,))[0]
                           for lv, (fh, fw) in enumerate(levels, start=2)])


def _inputs(table, seed=0):
    """(anchors, gt (3, 64, 4), valid, inside) over one anchor table: image
    0 all 64 gts valid, image 1 twelve, image 2 none; gts sized like the
    synthetic roidb's (24 px to half the image), an anchor copy and a
    duplicated gt in image 0, images of two sizes inside the bucket."""
    rng = np.random.RandomState(seed)
    if table == "c4":
        (h, w), anchors = (128, 192), generate_anchors_pre(8, 12, 16, scales=(2, 4, 8))[0]
    elif table == "fpn":
        (h, w), anchors = (128, 192), fpn_anchors(128, 192)
    else:                                                            # random anchors
        (h, w) = (300, 400)
        anchors = random_boxes(rng, 3001, width=w, height=h, min_size=3.0)
    b, g = 3, 64
    gt = np.stack([random_boxes(rng, g, w, h, min_size=12.0) for _ in range(b)])
    gt[0, 5] = anchors[len(anchors) // 3]                            # IoU exactly 1
    gt[0, 9] = gt[0, 8]                                              # duplicated gt
    valid = np.arange(g)[None, :] < np.array([[64], [12], [0]])
    hw = np.array([[h, w], [h - 20, w - 50], [h, w]])
    inside = ((anchors[None, :, 0] >= 0) & (anchors[None, :, 1] >= 0)
              & (anchors[None, :, 2] < hw[:, 1:2]) & (anchors[None, :, 3] < hw[:, 0:1]))
    return tuple(_t(x) for x in (anchors, gt, valid, inside))


PLANS = [dict(cluster=16), dict(cluster=8, threads=256), dict(cluster=4, threads=64),
         dict(cluster=1, threads=32), dict(cluster=3)]


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: "-".join(f"{v}" for v in p.values()))
@pytest.mark.parametrize("table", ["c4", "fpn", "random"])
def test_emulation_bit_equal_to_twin_and_culls_only_empty_pairs(table, plan):
    args = _inputs(table)
    got, stats = emulate_overlap(*args, overlap_plan(3, len(args[0]), **plan))
    assert_bit_equal(got, anchor_overlap_stats_reference(*args))
    assert stats["culled_live"] == 0
    assert got[2].any()                                      # some gt argmax to tie


@pytest.mark.parametrize("table", ["c4", "fpn"])
def test_emulation_matches_jax_dense_and_pallas(table):
    anchors, gt, valid, inside = _inputs(table, seed=1)
    (mx, am, is_ga), _ = emulate_overlap(anchors, gt, valid, inside,
                                         overlap_plan(3, len(anchors)))
    a = jnp.asarray(anchors.numpy())
    for i in range(2):                    # image 2 has no valid gt: the twin covers it
        gv, ins = valid[i].numpy(), inside[i].numpy()
        ov = np.asarray(jax_bbox_overlaps(a, jnp.asarray(gt[i].numpy())))
        ov = np.where(gv[None, :], ov, -1.0)
        ov = np.where(ins[:, None], ov, -1.0)
        gm = ov.max(0)
        want_ga = ((ov == gm[None, :]) & (gm[None, :] > 0) & gv[None, :]).any(1)
        np.testing.assert_array_equal(am[i].numpy(), ov.argmax(1))
        np.testing.assert_array_equal(is_ga[i].numpy(), want_ga)
        np.testing.assert_allclose(mx[i].numpy(), ov.max(1), atol=2e-7, rtol=0)
        pmx, pam, pga = jax_overlap_stats(a, jnp.asarray(gt[i].numpy()), jnp.asarray(gv),
                                          jnp.asarray(ins), interpret=True)
        np.testing.assert_array_equal(am[i].numpy(), np.asarray(pam))
        np.testing.assert_array_equal(is_ga[i].numpy(), np.asarray(pga))
        np.testing.assert_allclose(mx[i].numpy(), np.asarray(pmx), atol=2e-7, rtol=0)


def _edge(case):
    """One edge case on the C4 table of a 128x192 bucket, one image."""
    anchors, gt, valid, inside = (x[:1].clone() if x.dim() > 1 and x.shape[0] == 3 else x.clone()
                                  for x in _inputs("c4", seed=2))
    chunk = 32
    c = 10                                        # a chunk with inside anchors
    rows = slice(c * chunk, (c + 1) * chunk)
    box = anchors[rows][inside[0, rows]]
    x1, y1 = box[:, 0].min(), box[:, 1].min()
    x2, y2 = box[:, 2].max(), box[:, 3].max()
    if case == "touching":         # iw = 0, ih = 0 exactly (culled here), iw = 1 (kept)
        gt[0, 10:13] = torch.stack([torch.stack([x2 + 1, y1, x2 + 40, y2]),
                                    torch.stack([x1, y2 + 1, x2, y2 + 40]),
                                    torch.stack([x2, y1, x2 + 40, y2])])
    elif case == "duplicates":     # three copies of one gt and two of an anchor
        gt[0, 20:23] = gt[0, 3]
        gt[0, 30:32] = anchors[c * chunk + 3]
    elif case == "nothing":        # every gt overlaps nothing but one
        gt[0, 1:] = torch.tensor([900.0, 900.0, 950.0, 950.0])
    elif case == "no_valid":
        valid[:] = False
    elif case == "chunk_outside":  # a chunk with no inside anchor, its neighbours with some
        inside[0, rows] = False
    elif case == "ragged":         # K no multiple of the chunk; a gt covering every anchor
        anchors, inside = anchors[:chunk * 11 + 7], inside[:, :chunk * 11 + 7]
        gt[0, 2] = torch.tensor([-100.0, -100.0, 300.0, 300.0])
    return (anchors, gt, valid, inside), c


@pytest.mark.parametrize("threads", [64, 1024])
@pytest.mark.parametrize("case", ["touching", "duplicates", "nothing", "no_valid",
                                  "chunk_outside", "ragged"])
def test_edge_cases_bit_equal(case, threads):
    args, c = _edge(case)
    plan = overlap_plan(1, len(args[0]), cluster=3, threads=threads)
    got, stats = emulate_overlap(*args, plan)
    assert_bit_equal(got, anchor_overlap_stats_reference(*args))
    assert stats["culled_live"] == 0
    surv = stats["survivors"][0]
    if case == "touching":           # gts 10, 11 culled for chunk c; gt 12 kept
        anchors, gt, _, inside = args
        rows = slice(c * 32, (c + 1) * 32)
        _, inter = iou(anchors[rows][inside[0, rows]][:, None], gt[0, 10:13][None])
        assert (inter[:, :2] == 0).all() and (inter[:, 2] > 0).any() and surv[c] >= 1
    if case == "no_valid":
        assert (got[0] == -1).all() and (got[1] == 0).all() and not got[2].any()
    if case == "chunk_outside":
        assert surv[c] == 0
    if case == "duplicates":
        assert got[2].any() and (got[0] == 1.0).any()


@settings(max_examples=40, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 31 - 1), k=st.integers(1, 300), g=st.integers(1, 64),
       cluster=st.sampled_from([1, 2, 5, 16]), grid=st.booleans())
def test_emulation_bit_equal_on_random_boxes(seed, k, g, cluster, grid):
    """Random anchors and gts, on a coarse grid (many exact ties, touching
    edges, zero extents) or not."""
    rng = np.random.RandomState(seed)
    anchors = random_boxes(rng, k, 200, 150, min_size=1.0)
    gt = np.stack([random_boxes(rng, g, 200, 150, min_size=1.0) for _ in range(2)])
    if grid:
        anchors, gt = np.round(anchors / 16) * 16, np.round(gt / 16) * 16
    valid = rng.rand(2, g) < 0.7
    inside = rng.rand(2, k) < 0.8
    args = tuple(_t(x) for x in (anchors, gt, valid, inside))
    got, stats = emulate_overlap(*args, overlap_plan(2, k, cluster=cluster))
    assert_bit_equal(got, anchor_overlap_stats_reference(*args))
    assert stats["culled_live"] == 0


@pytest.mark.parametrize("b,k,cluster,threads", [
    (8, 21888, None, 1024),          # C4 train
    (8, 155520, None, 1024),         # FPN train, P2-P6 of 608x1024
    (8, 155520, 8, 256),
    (2, 38370, None, 512),           # FPN at 320x480, batch 2
    (1, 242991, None, 1024),         # FPN at 800x1216
    (3, 100, 16, 64),                # fewer anchors than the cluster has lanes
    (200, 5400, None, 32)])          # more images than SMs: a cluster of one block
def test_overlap_plan_covers_every_anchor_once_and_fits(b, k, cluster, threads):
    plan = overlap_plan(b, k, cluster=cluster, threads=threads)
    chunk, seg, nwarps = 32, plan["segment"], threads // 32
    assert seg % chunk == 0 and seg * plan["cluster"] >= k and 1 <= plan["cluster"] <= 16
    assert plan["smem_bytes"] == seg // chunk * 8 <= MAX_MASK_BYTES
    assert plan["smem_bytes"] + STATIC_SMEM_BYTES <= SMEM_BYTES
    assert b * plan["cluster"] <= 132 or plan["cluster"] == 1   # one wave of clusters
    seen = np.zeros(k, np.int64)
    for rank in range(plan["cluster"]):               # the kernel's loops, as written
        lo, hi = rank * seg, min(rank * seg + seg, k)
        nch = -(-(hi - lo) // chunk) if hi > lo else 0
        for warp in range(nwarps):
            for c in range(warp, nch, nwarps):
                idx = lo + c * chunk + np.arange(chunk)
                seen[idx[idx < hi]] += 1
    assert (seen == 1).all()


def test_overlap_plan_refuses_more_anchors_than_shared_memory_holds():
    with pytest.raises(ValueError):
        overlap_plan(1, 30_000_000, cluster=1)
