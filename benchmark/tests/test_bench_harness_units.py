"""The harness's arithmetic on synthetic data: generators, percentiles and
rates, the idle share of an interval list, K3's bound from its shapes."""

import numpy as np
import pytest
import torch

from benchmark.harness import roofline, traffic
from benchmark.harness.trace import Trace, gaps, union_us
from benchmark.reference import data as refdata

SPEC = {"count": 24, "long_side": 640, "short_side": [360, 639], "portrait_share": 0.25}


def test_image_shapes_are_one_set_in_a_seeds_order():
    a = traffic.image_shapes(SPEC, np.random.RandomState(1))
    b = traffic.image_shapes(SPEC, np.random.RandomState(1))
    c = traffic.image_shapes(SPEC, np.random.RandomState(2))
    assert a == b
    assert a != c and sorted(a) == sorted(c)
    assert sum(h > w for h, w in a) == 6


def test_draw_images_is_deterministic_per_seed():
    shapes = [(40, 64), (64, 40)]
    a = traffic.draw_images(shapes, 7, "cpu")
    b = traffic.draw_images(shapes, 7, "cpu")
    c = traffic.draw_images(shapes, 8, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert a[0].dtype == np.uint8 and a[0].shape == (40, 64, 3)


def test_roidb_counts_and_flips():
    spec = {"images": dict(SPEC, count=8, long_side=200, short_side=[120, 199]), "gts": [1, 30],
            "gt_mean": 7, "flipped": True, "image_dir": "x"}
    roidb, images = traffic.roidb(spec, 81, 5, "cpu")
    again, _ = traffic.roidb(spec, 81, 5, "cpu")
    other, _ = traffic.roidb(spec, 81, 6, "cpu")
    assert len(roidb) == 16 and len(images) == 8
    assert sorted(len(e["boxes"]) for e in roidb) == sorted(len(e["boxes"]) for e in other)
    assert all(np.array_equal(x["boxes"], y["boxes"]) for x, y in zip(roidb, again))
    e, f = roidb[0], roidb[8]
    assert f["flipped"] and f["image"] == e["image"]
    np.testing.assert_allclose(f["boxes"][:, 0], e["width"] - e["boxes"][:, 2] - 1)
    assert all(1 <= e["gt_classes"].min() and e["gt_classes"].max() <= 80 for e in roidb)


def test_gt_counts_mean_and_range():
    counts = traffic.gt_counts(256, 1, 30, 7)
    assert counts.min() >= 1 and counts.max() <= 30
    assert 6.0 < counts.mean() < 8.0


def test_request_plan_mix_and_buckets():
    shapes = [(360, 640)] * 20 + [(640, 360)] * 20

    def bucket(shape):
        return (608, 1024) if shape[0] < shape[1] else (1024, 608)

    spec = {"request_images": 8, "requests": 24, "group": "bucket", "bucket_mix": [2, 1]}
    plan = traffic.request_plan(spec, shapes, 3, bucket)
    assert len(plan) == 24 and all(len(r) == 8 for r in plan)
    kinds = [{bucket(shapes[i]) for i in r} for r in plan]
    assert all(len(k) == 1 for k in kinds)
    assert sum(k == {(608, 1024)} for k in kinds) == 16
    assert plan == traffic.request_plan(spec, shapes, 3, bucket)


def test_ungrouped_requests_have_one_set_of_compositions_for_every_seed():
    shapes = [(281 + i, 500) for i in range(24)] + [(500, 281 + i) for i in range(8)]

    def bucket(shape):
        return (800, 1344) if shape[0] < shape[1] else (1344, 800)

    spec = {"request_images": 8, "requests": 12, "mix_seed": 0}
    plans = [traffic.request_plan(spec, shapes, seed, bucket) for seed in (5, 2**31 + 9)]
    mixes = [sorted(sum(bucket(shapes[i]) == (1344, 800) for i in r) for r in p) for p in plans]
    assert mixes[0] == mixes[1] and len(set(mixes[0])) > 1
    assert plans[0] != plans[1]
    assert all(sorted(i for r in p[:4] for i in r) == list(range(32)) for p in plans)


def test_p95_is_over_all_requests():
    lat = list(range(1, 201))
    assert traffic.percentile(lat, 95) == pytest.approx(np.percentile(lat, 95))
    assert traffic.percentile(lat + [10_000], 95) > traffic.percentile(lat, 95)


def test_rate_is_over_the_whole_window():
    assert traffic.rate(80, 2.0) == 40.0
    with pytest.raises(ValueError):
        traffic.rate(1, 0.0)


def test_idle_share_of_an_interval_list():
    assert union_us([(0, 10), (5, 15), (20, 30)]) == 25
    assert gaps([(2, 4), (6, 8)], 0, 10) == [(0, 2), (4, 6), (8, 10)]
    tr = Trace(device=[("k1", 0, 10), ("k2", 5, 15), ("k3", 20, 30), ("k4", 95, 120)],
               host=[("wait", 14, 21, 0), ("inner", 16, 19, 1), ("prep", 30, 96, 0)],
               window=(0, 100))
    assert tr.window_s == pytest.approx(1e-4)
    assert tr.busy_s == pytest.approx(30e-6)                 # the last kernel clipped at 100
    idle = dict(tr.idle_by_host())
    assert idle["inner"] == pytest.approx(5e-6)              # 15-20, innermost at 17.5
    assert idle["prep"] == pytest.approx(65e-6)              # 30-95
    assert tr.device_seconds(lambda n: n in ("k1", "k2")) == (pytest.approx(20e-6), 2)


def test_k3_bound_from_shapes():
    launches = roofline.k3_launches(608, 1024, 8)
    assert [l[1:3] for l in launches] == [(152, 256)] * 3 + [(76, 128)] * 3
    # the six launches' bounds of the trunk pass, all by bytes: 59.5 + 2 x 95.2 + 3 x 47.7 us
    first = roofline.k3_bound_s(launches[:1])
    assert first == pytest.approx(2 * (8 * 152 * 256 * 320 + 4096 + 36864 + 16384 + 16384
                                      + 128 + 256 + 256) / 3.35e12)
    assert roofline.k3_bound_s(launches) == pytest.approx(393e-6, rel=0.01)


def test_reference_resize_matches_the_programs():
    from frcnn_tpu_torch.data.loader import prep_im_for_blob

    im = traffic.draw_images([(90, 120)], 1, "cpu")[0]
    for keep in (False, True):
        mine, info = refdata.prep(im, 128, 192, [(128, 192), (192, 128)], keep_uint8=keep)
        theirs, scale = prep_im_for_blob(im, 128, 192, [(128, 192), (192, 128)], keep_uint8=keep)
        assert np.array_equal(mine, theirs) and info[2] == scale


def test_weights_are_seeded_on_the_device():
    from benchmark.harness.weights import make_weights

    c = {"ANCHOR_SCALES": [8.0], "ANCHOR_RATIOS": [1.0]}
    a = make_weights("res50", 3, c, 11, "cpu")
    b = make_weights("res50", 3, c, 11, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["bn1.weight"][0] == 1 / 64 and a["layer1.0.bn3.weight"][0] == 0.5
    assert a["layer1.0.conv2.weight"].std() == pytest.approx((2 / 576) ** 0.5, rel=0.05)
