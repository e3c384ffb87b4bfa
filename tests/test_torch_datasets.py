"""The port's datasets, evaluators and data layer against the JAX package,
on the CPU.

  * roidbs: ``pascal_voc`` over the ``voc_root`` devkit (with and without
    difficult objects) and ``coco`` over ``coco_root`` give JAX's boxes,
    gt_classes, dense gt_overlaps, flipped and seg_areas; so does
    ``append_flipped_images`` (widths read from the images);
    ``factory.list_imdbs`` gives JAX's names;
  * VOC evaluation: fed the same all_boxes, ``evaluate_detections`` gives
    JAX's per-class APs exactly: perfect detections, misses and false
    positives, a detection of a difficult box, under the 11-point (2007)
    and the area (2012) metric;
  * COCO: ``COCOEval`` gives the golden 12-stat vector of
    ``tests/test_coco_e2e.py``, and ``coco.evaluate_detections`` JAX's stats;
  * the data layer: the index order over two epochs equals JAX's (aspect
    groups on and off, the random validation layer), and
    ``get_state``/``set_state`` resume the order exactly;
  * ``ds_utils``, ``evaluate_recall`` and ``merge_roidbs`` equal JAX's on
    seeded boxes; the default reader is cv2's.
"""

import os
import os.path as osp
import shutil

import numpy as np
import pytest

from frcnn_tpu import cfg_from_list as jax_cfg_from_list
from frcnn_tpu import default_config as jax_default_config
from frcnn_tpu.data import ds_utils as jax_ds_utils
from frcnn_tpu.data import factory as jax_factory
from frcnn_tpu.data.coco import coco as JaxCoco
from frcnn_tpu.data.imdb import imdb as jax_imdb
from frcnn_tpu.data.loader import RoIDataLayer as JaxRoIDataLayer
from frcnn_tpu.data.pascal_voc import pascal_voc as JaxVoc
from frcnn_tpu_torch import cfg_from_list, default_config
from frcnn_tpu_torch.data import ds_utils, factory
from frcnn_tpu_torch.data.coco import coco
from frcnn_tpu_torch.data.coco_eval import COCOEval
from frcnn_tpu_torch.data.imdb import imdb
from frcnn_tpu_torch.data.loader import RoIDataLayer, read_image
from frcnn_tpu_torch.data.pascal_voc import VOC_CLASSES, pascal_voc
from tests.conftest import random_boxes

ROIDB_KEYS = ("boxes", "gt_classes", "gt_overlaps", "flipped", "seg_areas")


def _voc_pair(voc_root, tmp_path, split="test", year="2007", use_diff=False):
    """The port's and JAX's pascal_voc over one devkit, each with a cache
    directory of its own (neither reads the other's pkl)."""
    root, _ = voc_root
    devkit = osp.join(root, "VOCdevkit2007")
    if year != "2007":                      # the same annotations under VOC<year>
        devkit = str(tmp_path / f"VOCdevkit{year}")
        if not osp.exists(devkit):
            shutil.copytree(osp.join(root, "VOCdevkit2007", "VOC2007"),
                            osp.join(devkit, f"VOC{year}"))
    ours = pascal_voc(split, year, use_diff=use_diff, devkit_path=devkit,
                      data_dir=str(tmp_path / "port"))
    theirs = JaxVoc(split, year, use_diff=use_diff, devkit_path=devkit,
                    data_dir=str(tmp_path / "jax"))
    return ours, theirs


def _assert_roidbs_equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        for key in ROIDB_KEYS:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)
            assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key


@pytest.mark.parametrize("use_diff", [False, True])
def test_voc_roidb_matches_jax(voc_root, tmp_path, use_diff):
    ours, theirs = _voc_pair(voc_root, tmp_path, split="trainval", use_diff=use_diff)
    assert ours.name == theirs.name and ours.classes == theirs.classes
    assert ours.image_index == theirs.image_index
    assert [ours.image_path_at(i) for i in range(ours.num_images)] == \
        [theirs.image_path_at(i) for i in range(theirs.num_images)]
    _assert_roidbs_equal(ours.roidb, theirs.roidb)
    # read back from the pkl cache
    again, _ = _voc_pair(voc_root, tmp_path, split="trainval", use_diff=use_diff)
    _assert_roidbs_equal(again.roidb, theirs.roidb)


def test_append_flipped_images_matches_jax(voc_root, tmp_path):
    ours, theirs = _voc_pair(voc_root, tmp_path, split="trainval")
    ours.append_flipped_images()
    theirs.append_flipped_images()
    assert ours.num_images == theirs.num_images == 12
    _assert_roidbs_equal(ours.roidb, theirs.roidb)
    assert [e["flipped"] for e in ours.roidb] == [False] * 6 + [True] * 6


def test_coco_roidb_matches_jax(coco_root, tmp_path):
    ours = coco("train", "2014", data_path=coco_root, data_dir=str(tmp_path / "port"))
    theirs = JaxCoco("train", "2014", data_path=coco_root, data_dir=str(tmp_path / "jax"))
    assert ours.classes == theirs.classes and ours.image_index == theirs.image_index
    assert [ours.image_path_at(i) for i in range(6)] == [theirs.image_path_at(i) for i in range(6)]
    _assert_roidbs_equal(ours.roidb, theirs.roidb)
    for a, b in zip(ours.roidb, theirs.roidb):
        assert (a["width"], a["height"]) == (b["width"], b["height"])
    ours.append_flipped_images()
    theirs.append_flipped_images()
    _assert_roidbs_equal(ours.roidb, theirs.roidb)


def test_factory_names_match_jax(tmp_path):
    assert factory.list_imdbs() == jax_factory.list_imdbs()
    with pytest.raises(KeyError):
        factory.get_imdb("voc_2007_nosuchsplit")
    with pytest.raises(FileNotFoundError):              # no devkit under this data_dir
        factory.get_imdb("voc_2007_test", data_dir=str(tmp_path))


def _gt_boxes(voc_root, split_index, with_difficult):
    """all_boxes built from the devkit's ground truth: [class][image] (k, 5)."""
    _, gt = voc_root
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in split_index] for _ in range(21)]
    for im_ind, name in enumerate(split_index):
        for cls, x1, y1, x2, y2, diff in gt[name]:
            if diff and not with_difficult:
                continue
            c = VOC_CLASSES.index(cls)
            all_boxes[c][im_ind] = np.vstack([all_boxes[c][im_ind],
                                              [[x1, y1, x2, y2, 1.0]]]).astype(np.float32)
    return all_boxes


def _misses(all_boxes, rng):
    """Every third image's gts missed, duplicates of the next third's (false
    positives), random scores, and two scored false positives a class and
    image."""
    out = [[b.copy() for b in per_class] for per_class in all_boxes]
    for per_class in out:
        for im_ind, dets in enumerate(per_class):
            if im_ind % 3 == 0:
                dets = dets[:0]
            elif im_ind % 3 == 1:
                dets = np.vstack([dets, dets + [3, 2, 3, 2, 0]])
            dets[:, 4] = rng.uniform(0.2, 1.0, len(dets))
            fp = np.concatenate([random_boxes(rng, 2, 320, 240, min_size=10),
                                 rng.uniform(0.0, 0.9, (2, 1)).astype(np.float32)], 1)
            per_class[im_ind] = np.vstack([dets, fp]).astype(np.float32)
    return out


@pytest.mark.parametrize("case", ["perfect", "misses", "difficult", "misses_2012"])
def test_voc_evaluate_detections_matches_jax(voc_root, tmp_path, case):
    year = "2012" if case.endswith("2012") else "2007"
    ours, theirs = _voc_pair(voc_root, tmp_path, year=year)
    all_boxes = _gt_boxes(voc_root, ours.image_index, with_difficult=case == "difficult")
    if case.startswith("misses"):
        all_boxes = _misses(all_boxes, np.random.RandomState(5))
    got = ours.evaluate_detections(all_boxes, str(tmp_path / "out_port"))
    want = theirs.evaluate_detections(all_boxes, str(tmp_path / "out_jax"))
    assert got.keys() == want.keys()
    for cls, ap in want.items():
        assert got[cls] == ap, (cls, got[cls], ap)
    if case in ("perfect", "difficult"):              # a detection on a difficult box is ignored
        assert got["dog"] == got["cat"] == got["car"] == 1.0
    else:
        assert 0.0 < got["mAP"] < 1.0
    assert osp.exists(tmp_path / "out_port" / "dog_pr.pkl")
    # cleanup removed the salted results files
    results = osp.join(ours._devkit_path, "results", f"VOC{year}", "Main")
    assert not [f for f in os.listdir(results) if ours._salt in f]


def test_coco_eval_golden_stats_vector():
    """The 12 stats of tests/test_coco_e2e.py::test_coco_eval_golden_stats_vector."""
    gts = [{"id": k + 1, "image_id": k, "category_id": 1, "bbox": [10, 10, 50, 50],
            "area": 2500, "iscrowd": 0} for k in range(4)]
    dts = [{"image_id": 0, "category_id": 1, "bbox": [10, 10, 50, 50], "score": 0.9},
           {"image_id": 1, "category_id": 1, "bbox": [20, 10, 50, 50], "score": 0.8},
           {"image_id": 2, "category_id": 1, "bbox": [200, 200, 50, 50], "score": 0.7}]
    ev = COCOEval(gts, dts, [{"id": 1, "name": "a"}])
    ev.evaluate()
    ev.accumulate()
    stats = ev.summarize(verbose=False)
    ap = (4 * 51 + 6 * 26) / (10 * 101)
    want = {"AP": ap, "AP50": 51 / 101, "AP75": 26 / 101, "APs": -1.0, "APm": ap, "APl": -1.0,
            "AR1": 0.35, "AR10": 0.35, "AR100": 0.35, "ARs": -1.0, "ARm": 0.35, "ARl": -1.0}
    assert list(stats) == list(want)
    for k, v in want.items():
        assert stats[k] == pytest.approx(v, abs=1e-9), (k, stats[k], v)


def test_coco_evaluate_detections_matches_jax(coco_root, tmp_path):
    ours = coco("train", "2014", data_path=coco_root, data_dir=str(tmp_path / "port"))
    theirs = JaxCoco("train", "2014", data_path=coco_root, data_dir=str(tmp_path / "jax"))
    rng = np.random.RandomState(9)
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in range(6)] for _ in range(4)]
    for im_ind, entry in enumerate(theirs.roidb):
        for box, cls in zip(entry["boxes"].astype(np.float32), entry["gt_classes"]):
            if rng.rand() < 0.7:                     # most gts found, a little off
                row = np.r_[box + rng.uniform(-3, 3, 4), rng.uniform(0.3, 1.0)]
                all_boxes[cls][im_ind] = np.vstack([all_boxes[cls][im_ind], row])
        all_boxes[1][im_ind] = np.vstack([all_boxes[1][im_ind], [5, 5, 40, 40, 0.1]])
    all_boxes = [[b.astype(np.float32) for b in per_class] for per_class in all_boxes]
    got = ours.evaluate_detections(all_boxes, str(tmp_path))
    want = theirs.evaluate_detections(all_boxes, None)
    assert got == want and 0.0 < got["AP"] < 1.0
    assert osp.exists(tmp_path / "detections_coco_2014_train_results.json")


def _layer_roidb(rng, n=11):
    """Entries of both orientations; only sizes matter to the order."""
    hw = [(240, 320) if rng.rand() < 0.6 else (320, 240) for _ in range(n)]
    return [{"height": h, "width": w} for h, w in hw]


@pytest.mark.parametrize("buckets,batch,random", [
    ("((128, 192), (192, 128))", 2, False),   # two orientations: aspect groups
    ("((128, 192),)", 3, False),
    ("((128, 192),)", 2, True),               # the validation layer
])
def test_data_layer_order_and_state_match_jax(buckets, batch, random):
    overrides = ["TPU.BUCKETS", buckets, "TRAIN.IMS_PER_BATCH", str(batch)]
    cfg = cfg_from_list(default_config(), overrides)
    jcfg = jax_cfg_from_list(jax_default_config(), overrides)
    roidb = _layer_roidb(np.random.RandomState(1))
    n = 2 * len(roidb) // batch + 1                       # over two epochs

    def order(layer_cls, config):
        # the random layer reseeds each epoch from the global numpy RNG
        np.random.seed(4)
        layer = layer_cls(roidb, config, random=random)
        return [layer._get_next_minibatch_inds() for _ in range(n)], layer

    ours, layer = order(RoIDataLayer, cfg)
    theirs, _ = order(JaxRoIDataLayer, jcfg)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        np.testing.assert_array_equal(a, b, err_msg=f"batch {i}")

    # a snapshot holds the layer's state and the global numpy RNG
    state, np_rng = layer.get_state(), np.random.get_state()
    rest = [layer._get_next_minibatch_inds() for _ in range(n)]
    resumed = RoIDataLayer(roidb, cfg, random=random)
    resumed.set_state(state)
    np.random.set_state(np_rng)
    for want in rest:
        np.testing.assert_array_equal(resumed._get_next_minibatch_inds(), want)


def test_data_layer_batch_size_argument():
    roidb = _layer_roidb(np.random.RandomState(2), n=5)
    cfg = cfg_from_list(default_config(), ["TPU.BUCKETS", "((128, 192),)"])
    jcfg = jax_cfg_from_list(jax_default_config(), ["TPU.BUCKETS", "((128, 192),)"])
    ours = RoIDataLayer(roidb, cfg, batch_size=7)            # more than the roidb holds
    theirs = JaxRoIDataLayer(roidb, jcfg, batch_size=7)
    for _ in range(3):
        a = ours._get_next_minibatch_inds()
        assert len(a) == 7
        np.testing.assert_array_equal(a, theirs._get_next_minibatch_inds())


def test_ds_utils_match_jax():
    rng = np.random.RandomState(6)
    boxes = random_boxes(rng, 40, 500, 400).astype(np.float64)
    boxes[30:] = boxes[:10]                                    # duplicates
    for scale in (1.0, 1.0 / 16.0):
        np.testing.assert_array_equal(ds_utils.unique_boxes(boxes, scale),
                                      jax_ds_utils.unique_boxes(boxes, scale))
    np.testing.assert_array_equal(ds_utils.xywh_to_xyxy(boxes), jax_ds_utils.xywh_to_xyxy(boxes))
    np.testing.assert_array_equal(ds_utils.xyxy_to_xywh(boxes), jax_ds_utils.xyxy_to_xywh(boxes))
    for min_size in (0.0, 20.0, 120.0):
        np.testing.assert_array_equal(ds_utils.filter_small_boxes(boxes, min_size),
                                      jax_ds_utils.filter_small_boxes(boxes, min_size))
    ds_utils.validate_boxes(boxes, 500, 400)
    jax_ds_utils.validate_boxes(boxes, 500, 400)
    for bad in ([-1, 0, 5, 5], [6, 0, 5, 5], [0, 0, 500, 5], [0, 0, 5, 400]):
        with pytest.raises(ValueError):
            ds_utils.validate_boxes(np.array([bad], float), 500, 400)
        with pytest.raises(AssertionError):
            jax_ds_utils.validate_boxes(np.array([bad], float), 500, 400)


class _Entries(imdb):
    def __init__(self, roidb):
        super().__init__("entries")
        self._image_index = list(range(len(roidb)))
        self._roidb = roidb


class _JaxEntries(jax_imdb):
    def __init__(self, roidb):
        super().__init__("entries")
        self._image_index = list(range(len(roidb)))
        self._roidb = roidb


def test_evaluate_recall_and_merge_match_jax():
    rng = np.random.RandomState(8)
    roidb = []
    for _ in range(4):
        n = rng.randint(1, 5)
        boxes = random_boxes(rng, n + 3, 300, 200)
        roidb.append({"boxes": boxes, "gt_classes": np.r_[rng.randint(1, 4, n), [0, 0, 0]],
                      "gt_overlaps": rng.rand(n + 3, 4).astype(np.float32),
                      "seg_areas": rng.rand(n + 3).astype(np.float32)})
    cands = [np.vstack([e["boxes"][:2] + rng.uniform(-6, 6, (2, 4)),
                        random_boxes(rng, 5, 300, 200)]).astype(np.float32) for e in roidb]
    ours, theirs = _Entries(roidb), _JaxEntries(roidb)
    for kw in ({}, {"candidate_boxes": cands}, {"candidate_boxes": cands, "limit": 3}):
        a, b = ours.evaluate_recall(**kw), theirs.evaluate_recall(**kw)
        np.testing.assert_allclose(a["gt_overlaps"], b["gt_overlaps"], rtol=1e-6)
        np.testing.assert_array_equal(a["recalls"], b["recalls"])
        assert a["ar"] == b["ar"]
    copy = lambda: [{k: v.copy() for k, v in e.items()} for e in roidb]  # noqa: E731
    merged, jmerged = imdb.merge_roidbs(copy(), copy()), jax_imdb.merge_roidbs(copy(), copy())
    for a, b in zip(merged, jmerged):
        for key in ("boxes", "gt_classes", "gt_overlaps", "seg_areas"):
            np.testing.assert_array_equal(a[key], b[key])


def test_read_image_is_cv2(voc_root, monkeypatch):
    import sys

    import cv2

    root, _ = voc_root
    path = osp.join(root, "VOCdevkit2007", "VOC2007", "JPEGImages", "000000.jpg")
    np.testing.assert_array_equal(read_image(path), cv2.imread(path))
    with pytest.raises(ValueError):
        read_image(path + ".missing")
    monkeypatch.setitem(sys.modules, "cv2", None)          # a machine without cv2
    with pytest.raises(ImportError, match="reader="):
        read_image(path)
