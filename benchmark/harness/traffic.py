"""The general generator of the benchmark's inputs: every traffic file under
``benchmark/traffic/`` is data that this module reads.

A seed fixes the pixels, the boxes and the order; the sizes come from the
traffic file alone.  Every seed gets the same set of image shapes, the same
share of portrait images, the same multiset of ground-truth counts and the
same mix of request buckets, in another order, so that two seeds give the
program the same work.

Images are low-frequency noise with flat rectangles (the ground-truth boxes
where there are any), BGR uint8, drawn on the given device from a
``torch.Generator`` and returned as host arrays, which both the program and
the reference read.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def image_shapes(spec: dict, rng: np.random.RandomState):
    """``spec["count"]`` (h, w) shapes: the long side ``long_side``, the short
    sides evenly spread over ``short_side`` [lo, hi], a ``portrait_share`` of
    them portrait, spread over the short sides; the set is the same for every
    seed, its order is the seed's."""
    n = spec["count"]
    lo, hi = spec["short_side"]
    shorts = np.round(np.linspace(lo, hi, n)).astype(int)
    share = spec["portrait_share"]
    idx = np.arange(n)
    portrait = np.floor((idx + 1) * share) > np.floor(idx * share)   # spread over the shorts
    long = spec["long_side"]
    shapes = [(long, int(s)) if p else (int(s), long) for s, p in zip(shorts, portrait)]
    return [shapes[i] for i in rng.permutation(n)]


def gt_counts(n: int, lo: int, hi: int, mean: float):
    """A fixed multiset of ``n`` ground-truth counts in [lo, hi], spread as
    lo + an exponential of mean ``mean - lo`` taken at its quantiles."""
    q = (np.arange(n) + 0.5) / n
    return np.clip(np.round(lo - (mean - lo) * np.log1p(-q)), lo, hi).astype(int)


def draw_images(shapes, seed: int, device, boxes=None):
    """One BGR uint8 image a shape: bilinear noise on a 16-pixel lattice plus
    six flat rectangles, and a flat rectangle over each of ``boxes[i]``
    (x1, y1, x2, y2) where given."""
    g = torch.Generator(device=device).manual_seed(seed)
    ims = []
    for i, (h, w) in enumerate(shapes):
        base = torch.randint(0, 255, (1, 3, h // 16 + 1, w // 16 + 1), generator=g,
                             device=device).float()
        im = F.interpolate(base, size=(h, w), mode="bilinear", align_corners=False)[0]
        rects = torch.rand((6, 4), generator=g, device=device).cpu().numpy()
        colors = torch.randint(0, 255, (6 + (0 if boxes is None else len(boxes[i])), 3),
                               generator=g, device=device).float()
        im = im.permute(1, 2, 0).contiguous()
        for (ry, rx, rh, rw), col in zip(rects, colors[:6]):
            y, x = int(ry * (h - 60)), int(rx * (w - 60))
            im[y:y + 20 + int(rh * 40), x:x + 20 + int(rw * 40)] = col
        if boxes is not None:
            for (x1, y1, x2, y2), col in zip(boxes[i].astype(int), colors[6:]):
                im[y1:y2, x1:x2] = col
        ims.append(im)
    return [im.clamp(0, 255).to(torch.uint8).cpu().numpy() for im in ims]


def serve_pool(spec: dict, seed: int, device):
    """The images a serving cell's requests are drawn from."""
    rng = np.random.RandomState(seed % 2**32)
    shapes = image_shapes(spec["images"], rng)
    return draw_images(shapes, seed, device)


def request_plan(spec: dict, pool_shapes, seed: int, buckets_of):
    """The request sequence: a list of lists of pool indices, cycled by the
    window.  ``"group": "bucket"`` makes every request ``request_images``
    images of one bucket, the buckets in the traffic's ``bucket_mix``
    proportions (the order the seed's); else requests take the pool
    ``request_images`` at a time, whatever their buckets, in an order whose
    sequence of buckets is fixed by ``mix_seed``, so that every seed sends
    requests of the same bucket compositions: the seed picks which image of
    a bucket fills each place and the order of the requests."""
    rng = np.random.RandomState((seed + 1) % 2**32)
    k, n = spec["request_images"], spec["requests"]
    if spec.get("group") == "bucket":
        by_bucket: dict = {}
        for i, shape in enumerate(pool_shapes):
            by_bucket.setdefault(tuple(buckets_of(shape)), []).append(i)
        names = sorted(by_bucket, key=lambda b: (b[0] > b[1], b))     # landscape first
        mix = spec["bucket_mix"]
        plan = []
        for b, share in zip(names, mix):
            plan += [b] * int(round(share / sum(mix) * n))
        rng.shuffle(plan)
        cursor = {b: 0 for b in names}
        perms = {b: list(rng.permutation(by_bucket[b])) for b in names}
        out = []
        for b in plan:
            pool = perms[b]
            out.append([pool[(cursor[b] + j) % len(pool)] for j in range(k)])
            cursor[b] += k
        return out
    buckets = [tuple(buckets_of(shape)) for shape in pool_shapes]
    places = np.random.RandomState(spec["mix_seed"]).permutation(sorted(buckets, key=str))
    fill = {b: iter(rng.permutation([i for i, x in enumerate(buckets) if x == b]).tolist())
            for b in set(buckets)}
    order = [next(fill[tuple(b)]) for b in places]
    groups = [order[r * k:(r + 1) * k] for r in range(-(-len(order) // k))]
    groups = [groups[g] for g in rng.permutation(len(groups))]
    order = [i for g in groups for i in g]
    return [[order[(r * k + j) % len(order)] for j in range(k)] for r in range(n)]


def roidb(spec: dict, num_classes: int, seed: int, device):
    """A training roidb over seeded images: each entry with its boxes (the
    counts a fixed multiset, ``gts`` [lo, hi] of mean ``gt_mean``), classes
    in 1..num_classes-1, its size, and, with ``flipped``, a mirrored copy of
    every entry as the lineage's ``append_flipped_images`` makes it.
    Returns (roidb, images: path → BGR uint8)."""
    rng = np.random.RandomState(seed % 2**32)
    shapes = image_shapes(spec["images"], rng)
    lo, hi = spec["gts"]
    counts = gt_counts(len(shapes), lo, hi, spec["gt_mean"])
    rng.shuffle(counts)
    boxes, entries = [], []
    for i, ((h, w), n) in enumerate(zip(shapes, counts)):
        xy = np.stack([rng.uniform(0, w - 40, n), rng.uniform(0, h - 40, n)], 1)
        wh = rng.uniform(24, np.array([w, h]) / 2, (n, 2))
        b = np.concatenate([xy, np.minimum(xy + wh, [w - 1, h - 1])], 1).astype(np.float32)
        boxes.append(b)
        entries.append({"image": f"{spec['image_dir']}/{i}.jpg", "boxes": b, "flipped": False,
                        "gt_classes": rng.randint(1, num_classes, n).astype(np.int32),
                        "height": h, "width": w, "max_overlaps": np.ones(n, np.float32)})
    ims = draw_images(shapes, seed, device, boxes)
    images = {e["image"]: im for e, im in zip(entries, ims)}
    if spec.get("flipped", False):
        for e in list(entries):
            b = e["boxes"].copy()
            b[:, 0], b[:, 2] = e["width"] - e["boxes"][:, 2] - 1, e["width"] - e["boxes"][:, 0] - 1
            entries.append({**e, "boxes": b, "flipped": True})
    return entries, images


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values`` (linear between order
    statistics, numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def rate(count: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0 or not math.isfinite(seconds):
        raise ValueError(f"window of {seconds} s")
    return count / seconds
