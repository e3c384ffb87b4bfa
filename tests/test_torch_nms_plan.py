"""The parts of the redesigned K1 kernel (``csrc/nms_kernel.cu``) that a CPU
can hold.

  * ``emulate_chunked_nms`` repeats the kernel's decomposition in plain
    PyTorch and Python integers: chunks of 64 candidates, each pulled against
    the kept list that is dealt round-robin over the cluster's blocks (one
    64-bit word a block, ORed), the chunk's own triangle of IoU bits, the
    greedy order resolved by repeating K <- alive & ~(triangle[j] & K) to its
    fixed point, the cap cutting a chunk after its first set bits, and the
    early exit at the cap.  It is held equal to the port's twin (cut after
    its first ``cap`` kept boxes) and to the JAX package's ``nms_mask`` and
    ``nms_mask_pallas_batched`` (interpret mode) on seeded numpy inputs.
  * ``nms_plan`` covers the main-path shapes within the shared memory a block
    may take, and refuses what the cluster cannot hold.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frcnn_tpu.ops.nms import nms_mask as jax_nms_mask
from frcnn_tpu.ops.pallas.nms_kernel import nms_mask_pallas_batched
from frcnn_tpu_torch.ops.boxes import bbox_overlaps
from frcnn_tpu_torch.ops.cuda import nms_kernel
from frcnn_tpu_torch.ops.cuda.nms_kernel import nms_mask_reference, nms_plan

MAX_BLOCK_SMEM = 232448
CHUNK = nms_kernel.CHUNK


def _bits(flags):
    """A Python int with bit i set where flags[i]."""
    return sum(1 << i for i, f in enumerate(flags.tolist()) if f)


def emulate_chunked_nms(boxes, valid, thresh, cap, plan):
    """K1's decomposition, one problem at a time → (keep (B, N) bool, the
    steps each problem took: chunks that went through the exchange)."""
    b, n = valid.shape
    ranks, slots = plan["cluster"], plan["slots"]
    cap = n if cap is None else cap
    thr = torch.tensor(thresh, dtype=torch.float32)
    keep = torch.zeros((b, n), dtype=torch.bool)
    steps = []
    for p in range(b):
        lists = [[] for _ in range(ranks)]       # block r holds kept box g where g % ranks == r
        kept = step = 0
        for j0 in range(0, n, CHUNK):
            if kept >= cap:
                break                             # the rest of the mask stays zero
            cand = boxes[p, j0:j0 + CHUNK]
            size = cand.shape[0]
            vword = _bits(valid[p, j0:j0 + CHUNK])
            if vword == 0:
                continue                          # no barrier, nothing kept
            step += 1
            sup = 0                               # the blocks' words, ORed after the exchange
            for mine in lists:
                if mine:
                    hit = bbox_overlaps(boxes[p, mine], cand) > thr          # (mine, size)
                    sup |= _bits(hit.any(0))
            iou = bbox_overlaps(cand, cand) > thr
            tri = [_bits(iou[:j, j]) for j in range(size)]                   # bit i: i < j
            alive = vword & ~sup
            k = alive
            for _ in range(CHUNK + 1):            # position j is final after round j
                nxt = sum(1 << j for j in range(size)
                          if (alive >> j) & 1 and not tri[j] & k)
                if nxt == k:
                    break
                k = nxt
            else:
                raise AssertionError("the chunk's resolve did not reach a fixed point")
            room = cap - kept
            if bin(k).count("1") > room:          # the cap falls inside this chunk
                k = sum(1 << j for j in range(size)
                        if (k >> j) & 1 and bin(k & ((1 << j) - 1)).count("1") < room)
            for j in range(size):
                if (k >> j) & 1:
                    g = kept + bin(k & ((1 << j) - 1)).count("1")
                    assert g // ranks < slots     # the plan's list holds it
                    lists[g % ranks].append(j0 + j)
                    keep[p, j0 + j] = True
            kept += bin(k).count("1")
        steps.append(step)
    return keep, steps


def _clustered(rng, b, n, clusters=12, size=400.0):
    centres = rng.uniform(0, size, (b, clusters, 2))
    pick = rng.randint(0, clusters, (b, n))
    c = np.take_along_axis(centres, pick[..., None], axis=1) + rng.normal(0, 10, (b, n, 2))
    wh = rng.uniform(8, 120, (b, n, 2))
    return np.clip(np.concatenate([c - wh / 2, c + wh / 2], -1), 0, size - 1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _nms_case(case):
    """(boxes (B, N, 4), valid (B, N), thresh, cap)."""
    rng = np.random.RandomState(21)
    if case == "ragged_n":                   # N no multiple of 64; a problem with no valid box
        boxes = _clustered(rng, 3, 333)
        valid = rng.uniform(0, 1, (3, 333)) > 0.2
        valid[1] = False
        return boxes, valid, 0.5, None
    if case == "below_one_chunk":            # N < 64
        return _clustered(rng, 2, 37), rng.uniform(0, 1, (2, 37)) > 0.1, 0.3, None
    if case == "duplicates":                 # exact duplicates: IoU 1 suppresses the later copy
        boxes = _clustered(rng, 2, 200)
        boxes[:, 1::3] = boxes[:, 0:-1:3][:, :boxes[:, 1::3].shape[1]]
        return boxes, np.ones((2, 200), bool), 0.7, None
    if case == "integer_grid":               # IoUs that land exactly on the threshold
        boxes = np.round(_clustered(rng, 2, 260, clusters=4, size=120.0) / 8) * 8
        boxes[0, :4] = [[0, 0, 9, 9], [0, 0, 9, 4], [0, 5, 9, 9], [0, 0, 4, 9]]  # IoU 0.5 with the first
        return boxes.astype(np.float32), np.ones((2, 260), bool), 0.5, None
    if case == "cap_1":
        return _clustered(rng, 2, 150), rng.uniform(0, 1, (2, 150)) > 0.3, 0.5, 1
    if case == "cap_in_first_chunk":
        return _clustered(rng, 2, 300), np.ones((2, 300), bool), 0.7, 9
    if case == "cap_never_reached":
        return _clustered(rng, 2, 300, clusters=3), np.ones((2, 300), bool), 0.3, 250
    if case == "cap_mid_walk":               # the walk ends inside a later chunk
        return _clustered(rng, 3, 500), rng.uniform(0, 1, (3, 500)) > 0.1, 0.5, 100
    if case == "invalid_chunk":              # a whole chunk of invalid boxes costs no step
        valid = np.ones((2, 256), bool)
        valid[:, 64:128] = False
        return _clustered(rng, 2, 256), valid, 0.5, None
    raise KeyError(case)


NMS_CASES = ("ragged_n", "below_one_chunk", "duplicates", "integer_grid", "cap_1",
             "cap_in_first_chunk", "cap_never_reached", "cap_mid_walk", "invalid_chunk")


@functools.lru_cache(maxsize=None)
def _references(case):
    """The twin's mask cut at the cap, and the JAX package's two."""
    boxes, valid, thresh, cap = _nms_case(case)
    twin = nms_mask_reference(torch.from_numpy(boxes), thresh, torch.from_numpy(valid))
    if cap is not None:
        twin = twin & (torch.cumsum(twin, 1) <= cap)
    plain = np.stack([np.asarray(jax_nms_mask(jnp.asarray(bx), thresh, jnp.asarray(vd)))
                      for bx, vd in zip(boxes, valid)])
    pallas = np.asarray(nms_mask_pallas_batched(jnp.asarray(boxes), thresh, jnp.asarray(valid),
                                                interpret=True, max_keep=cap))
    if cap is not None:                      # later keep bits of the capped walk may be dropped
        plain = plain & (np.cumsum(plain, 1) <= cap)
        pallas = pallas & (np.cumsum(pallas, 1) <= cap)
    return twin, plain, pallas


@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
@pytest.mark.parametrize("case", NMS_CASES)
def test_chunked_nms_emulation_matches_twin_and_jax(case, cluster):
    boxes, valid, thresh, cap = _nms_case(case)
    plan = nms_plan(boxes.shape[0], boxes.shape[1], cap, cluster=cluster)
    keep, steps = emulate_chunked_nms(torch.from_numpy(boxes), torch.from_numpy(valid), thresh,
                                      cap, plan)
    twin, plain, pallas = _references(case)
    assert torch.equal(keep, twin)
    np.testing.assert_array_equal(keep.numpy(), plain)
    np.testing.assert_array_equal(keep.numpy(), pallas)
    chunks = -(-boxes.shape[1] // CHUNK)
    assert max(steps) <= chunks
    if case == "ragged_n":
        assert steps[1] == 0 and not keep[1].any()       # no valid box: no step
    if case == "cap_in_first_chunk":
        assert steps == [1, 1] and (keep.sum(1) == cap).all()
    if case == "cap_never_reached":
        assert (keep.sum(1) < cap).all() and steps == [chunks] * 2
    if case == "cap_mid_walk":
        assert (keep.sum(1) == cap).all() and max(steps) < chunks
    if case == "invalid_chunk":
        assert steps == [chunks - 1] * 2
    if case == "integer_grid":
        assert keep[0, 0] and keep[0, 1:4].all()         # IoU exactly 0.5 is not above 0.5


# (B, N, cap) of K1's main-path launches (C4 serve proposals and per-class, FPN
# serve proposals, C4 and FPN train proposals) and the single problem (K1b)
K1_MAIN_PATH = ((8, 6000, 300), (168, 300, 100), (8, 4741, 300), (8, 12000, 2000),
                (8, 8480, 2000), (1, 6000, 300))


@pytest.mark.parametrize("b,n,cap", K1_MAIN_PATH + ((1, 12000, None), (4, 2000, None),
                                                    (3, 50, 7), (1, 100000, None)))
def test_nms_plan_holds_the_kept_list(b, n, cap):
    plan = nms_plan(b, n, cap)
    cluster, threads, slots = plan["cluster"], plan["threads"], plan["slots"]
    assert cluster in (1, 2, 4, 8, 16) and cluster <= nms_kernel.MAX_CLUSTER
    assert threads & (threads - 1) == 0 and CHUNK <= threads <= nms_kernel.MAX_THREADS
    assert slots * cluster >= min(n, n if cap is None else cap)     # every kept box has a slot
    assert plan["smem_bytes"] == slots * nms_kernel.SLOT_BYTES <= nms_kernel.MAX_LIST_BYTES
    assert plan["smem_bytes"] + nms_kernel.STATIC_SMEM_BYTES <= MAX_BLOCK_SMEM
    if (b, n, cap) in K1_MAIN_PATH:
        assert cluster <= 8                                         # the portable cluster size
        assert b * cluster <= max(b, nms_kernel.SM_COUNT)           # a problem's blocks fit the card
    if (b, n, cap) == (168, 300, 100):
        assert cluster == 1                                         # small problems: one block each


def test_nms_plan_refuses_what_the_cluster_cannot_hold():
    with pytest.raises(ValueError):
        nms_plan(1, 400000, None)                                   # 8 MB of kept boxes
    with pytest.raises(ValueError):
        nms_plan(1, 100, 10, cluster=3)                             # not a power of two
    with pytest.raises(ValueError):
        nms_plan(1, 100, 10, threads=96)                            # not a power of two
    assert nms_plan(1, 20000, None, cluster=1)["cluster"] == 2      # raised until the list fits
