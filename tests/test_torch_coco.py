"""The COCO recipe in the port against the JAX package, on the CPU, f32.

A synthetic COCO (``chip_smoke.write_coco_dataset``: the 80 categories at
their COCO ids, crowds, a zero-area annotation, one training image of 12
annotations against a DEVICE.MAX_GT of 8), its pixels written as PNG bytes
at the JPEG paths so that cv2 reads them on both sides; images whose short
side is the test scale and that fit the bucket, so that neither side
resizes.  MobileNet-v1 at DEPTH_MULTIPLIER 0.25 stands for the recipe's
res101 (the same heads at 81 classes and 12 anchors a cell).

  * (a) the roidb of train2014 and minival2014, the class and category-id
    maps and ``_results_to_json``'s ids equal JAX's; crowds are -1 rows;
  * (b) a COCO minibatch equals JAX's ``get_minibatch``, the 12 gts cut to
    MAX_GT;
  * (c) one f32 SGD step at 81 classes and ANCHOR_SCALES (4, 8, 16, 32)
    against a jitted JAX train step (the recipe of test_torch_train.py):
    losses within 1e-4 relative, updates within 1e-3 of max|update|, frozen
    tensors exactly unchanged;
  * (d) ``test_net`` over minival2014 on the same weights: the detections
    matched per image and class and the 12 stats within 1e-6 of JAX's;
  * (e) the CLIs with ``--cpu``: ``trainval_net`` on
    coco_2014_train+coco_2014_valminusminival for 2 iterations, then
    ``test_net`` on its snapshot: the 12 stats and the results json;
  * (f) ``proposal_layer_batch(use_threshold=True)`` at 34200 anchors,
    pre_n 1000, rows of ties with a NEG_INF tail: bit-equal to the sorted
    route; against JAX's route (its Pallas kernel in interpret mode) the
    scores and valid masks bit-equal, the boxes within XLA's f32 decode
    (rtol 1e-6, atol 1e-4);
  * (g) ``--set ANCHOR_SCALES [4,8,16,32]`` gives 12 anchors a cell, as in
    JAX, and ``--cfg experiments/cfgs/res101.yml`` loads as JAX loads it;
    the port's recipe wrappers (``experiments/scripts/*_torch.sh``) give
    their CLIs argument lists that parse, with the COCO recipe's config;
  * COCOEval, vectorised: on seeded cases with crowds, ignored and
    area-ignored gts, tied scores, images without dets or gts and the
    maxDets cut, ``eval_imgs`` equal to JAX's entry for entry and the stats
    and precision/recall arrays equal.
"""

import copy
import json
import os
import os.path as osp
import pickle
import shutil
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import chip_smoke
from frcnn_tpu import cfg_from_list as jax_cfg_from_list
from frcnn_tpu import default_config as jax_default_config
from frcnn_tpu.config import cfg_from_file as jax_cfg_from_file
from frcnn_tpu.data.coco import coco as JaxCoco
from frcnn_tpu.data.coco_eval import COCOEval as JaxCOCOEval
from frcnn_tpu.data.loader import get_minibatch as jax_get_minibatch
from frcnn_tpu.engine import test as jax_test
from frcnn_tpu.engine.train import _param_labels, stop_frozen_gradients
from frcnn_tpu.engine.train import make_optimizer as jax_make_optimizer
from frcnn_tpu.models import build_model as jax_build_model
from frcnn_tpu.models.proposals import proposal_layer_batch as jax_proposal_layer_batch
from frcnn_tpu.ops.pallas import select_kernel as jax_select_kernel
from frcnn_tpu_torch import cfg_from_list, default_config
from frcnn_tpu_torch.config import cfg_from_file
from frcnn_tpu_torch.data.coco import coco
from frcnn_tpu_torch.data.coco_eval import COCOEval
from frcnn_tpu_torch.data.loader import get_minibatch
from frcnn_tpu_torch.engine import test as port_test
from frcnn_tpu_torch.engine.train import SolverWrapper, get_training_roidb
from frcnn_tpu_torch.models.network import build_model
from frcnn_tpu_torch.models.proposals import proposal_layer_batch
from frcnn_tpu_torch.ops.anchors import generate_anchors_pre
from frcnn_tpu_torch.ops.cuda import build
from frcnn_tpu_torch.tools import test_net as test_net_cli
from frcnn_tpu_torch.tools import trainval_net as trainval_net_cli
from frcnn_tpu_torch.utils import summary
from frcnn_tpu_torch.utils.weight_convert import convert_from_jax
from tests.test_pipeline_parity import _assert_det_sets_match
from tests.test_torch_train import _close, _jax_draws
from tests.test_torch_vgg_mobile import numpy_params

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CLASSES = 81
H, W, B = 128, 192, 2
MAX_GT = 8
SPLITS = {"train2014": [(H, W), (H, 160)], "valminusminival2014": [(H, 176)],
          "minival2014": [(H, W), (H, 160), (H, 176)]}
# the recipe's anchors and classes at the test size, a narrow net
OVERRIDES = ["ANCHOR_SCALES", "[4,8,16,32]", "ANCHOR_RATIOS", "[0.5,1,2]",
             "MOBILENET.DEPTH_MULTIPLIER", "0.25", "TPU.BUCKETS", f"(({H}, {W}),)",
             "TPU.MAX_GT", str(MAX_GT), "TRAIN.SCALES", f"({H},)", "TRAIN.MAX_SIZE", str(W),
             "TRAIN.IMS_PER_BATCH", str(B), "TRAIN.RPN_PRE_NMS_TOP_N", "400",
             "TRAIN.RPN_POST_NMS_TOP_N", "64", "TRAIN.BATCH_SIZE", "32",
             "TRAIN.RPN_BATCHSIZE", "64", "TEST.SCALES", f"({H},)", "TEST.MAX_SIZE", str(W),
             "TEST.RPN_PRE_NMS_TOP_N", "400", "TEST.RPN_POST_NMS_TOP_N", "32"]
COCO_IDS = [i for i, _ in chip_smoke.COCO_CATEGORIES]


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    """DATA_DIR of the synthetic COCO, its images readable by cv2."""
    import cv2

    root = str(tmp_path_factory.mktemp("coco_recipe"))
    reader = chip_smoke.write_coco_dataset(root, SPLITS, np.random.RandomState(23),
                                           many=("train2014", 12))
    for dirpath, _, files in os.walk(osp.join(root, "coco", "images")):
        for name in files:
            path = osp.join(dirpath, name)
            ok, png = cv2.imencode(".png", reader(path))
            with open(path, "wb") as f:
                f.write(png.tobytes())
    return root


def _pair(root, split, tmp_path):
    """The port's and JAX's coco imdb over one split, each with a cache
    directory of its own."""
    data = osp.join(root, "coco")
    return (coco(split, "2014", data_path=data, data_dir=str(tmp_path / "port")),
            JaxCoco(split, "2014", data_path=data, data_dir=str(tmp_path / "jax")))


# ---------------------------------------------------------------------------
# (a), (b): the roidb and the minibatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split", ["train", "minival"])
def test_coco_roidb_and_maps_match_jax(coco_dir, tmp_path, split):
    ours, theirs = _pair(coco_dir, split, tmp_path)
    assert ours.num_classes == theirs.num_classes == CLASSES
    assert ours.classes == theirs.classes
    assert ours._class_to_coco_cat_id == theirs._class_to_coco_cat_id
    assert ours._coco_cat_id_to_class_ind == theirs._coco_cat_id_to_class_ind
    assert [ours._class_to_coco_cat_id[c] for c in ours.classes[1:]] == COCO_IDS
    assert ours.image_index == theirs.image_index
    assert [ours.image_path_at(i) for i in range(ours.num_images)] == \
        [theirs.image_path_at(i) for i in range(theirs.num_images)]
    with open(ours._anno_file) as f:
        n_anns = len(json.load(f)["annotations"])

    # _results_to_json: the same rows, at the COCO category ids
    rng = np.random.RandomState(3)
    n = ours.num_images
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in range(n)] for _ in range(CLASSES)]
    for cls in (1, 11, 12, 40, 80):                  # ids 1, 11, 13, 44, 90: across the gaps
        for im in range(n):
            xy = rng.uniform(0, 100, (3, 2))
            all_boxes[cls][im] = np.concatenate([xy, xy + 20, rng.uniform(0, 1, (3, 1))],
                                                1).astype(np.float32)
    got, want = ours._results_to_json(all_boxes), theirs._results_to_json(all_boxes)
    assert got == want and len(got) == 5 * 3 * n
    assert sorted({r["category_id"] for r in got}) == [1, 11, 13, 44, 90]

    for flipped in (False, True):
        if flipped:
            ours.append_flipped_images()
            theirs.append_flipped_images()
        assert len(ours.roidb) == len(theirs.roidb)
        for a, b in zip(ours.roidb, theirs.roidb):
            for key in ("boxes", "gt_classes", "gt_overlaps", "flipped", "seg_areas", "width",
                        "height"):
                np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), key)
                assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key
    kept = ours.roidb[:n]
    assert sum(len(e["boxes"]) for e in kept) == n_anns - 1          # the zero-area one dropped
    assert sum(int((e["gt_overlaps"] == -1).all(1).sum()) for e in kept) > 0   # crowds


def test_coco_minibatch_matches_jax(coco_dir, tmp_path):
    import cv2

    cfg = cfg_from_list(default_config(), OVERRIDES)
    jcfg = jax_cfg_from_list(jax_default_config(), OVERRIDES)
    ours, _ = _pair(coco_dir, "train", tmp_path)
    roidb = get_training_roidb(ours, cfg)
    assert len(roidb) == 4 and max(len(e["boxes"]) for e in roidb) == 12
    for entries in (roidb[:2], roidb[2:]):            # the 12-gt image, then its flip
        blobs = get_minibatch(entries, cfg, np.random.RandomState(0), reader=cv2.imread)
        jblobs = jax_get_minibatch(entries, jcfg, np.random.RandomState(0), reader=cv2.imread)
        for key in ("im_info", "gt_boxes", "gt_labels", "gt_valid"):
            np.testing.assert_array_equal(blobs[key], jblobs[key], key)
        np.testing.assert_array_equal(blobs["data"], jblobs["data"])
        assert blobs["gt_valid"][0].sum() == MAX_GT
        assert set(blobs["gt_labels"][blobs["gt_valid"]]) <= set(range(1, CLASSES))


# ---------------------------------------------------------------------------
# (c): one SGD step at 81 classes and four anchor scales
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """Seeded weights in the JAX tree's shapes (the VGG/MobileNet tests'
    recipe); the class scores' weights at N(0, 0.1), so that 81 softmax
    scores spread and few near-tied detections reach the stats."""
    jcfg = jax_cfg_from_list(jax_default_config(), OVERRIDES)
    params = numpy_params(jax_build_model("mobile", CLASSES, jcfg))
    rng = np.random.RandomState(1)
    params["cls_score"]["kernel"] = (rng.randn(*params["cls_score"]["kernel"].shape)
                                     * 0.1).astype(np.float32)
    return params


def test_sgd_step_matches_jax(coco_dir, tmp_path, weights):
    import cv2

    overrides = OVERRIDES + ["TRAIN.LEARNING_RATE", "1.0"]   # test_torch_train.py: lr 1.0
    jcfg = jax_cfg_from_list(jax_default_config(), overrides)
    cfg = cfg_from_list(default_config(), overrides)
    assert cfg.num_anchors == jcfg.num_anchors == 12
    ours, _ = _pair(coco_dir, "train", tmp_path)
    roidb = get_training_roidb(ours, cfg)[:2]
    blobs = get_minibatch(roidb, cfg, np.random.RandomState(0), reader=cv2.imread)

    jmodel = jax_build_model("mobile", CLASSES, jcfg)
    tx, _ = jax_make_optimizer(jmodel, weights, jcfg)
    labels = _param_labels(jmodel, weights)

    def train_step(params, opt_state, data, im_info, gt_boxes, gt_labels, gt_valid, key):
        dkey, skey = jax.random.split(key)

        def loss_fn(p):
            losses, _ = jmodel.apply({"params": stop_frozen_gradients(labels, p)}, data, im_info,
                                     gt_boxes, gt_labels, gt_valid, skey,
                                     method="train_forward", rngs={"dropout": dkey})
            return losses["total_loss"], losses

        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), losses

    names = ("data", "im_info", "gt_boxes", "gt_labels", "gt_valid")
    key = jax.random.PRNGKey(5)
    new_params, jlosses = jax.jit(train_step)(weights, tx.init(weights),
                                              *[jnp.asarray(blobs[n]) for n in names], key)
    k = -(-H // 16) * -(-W // 16) * 12                    # MobileNet's SAME convs: ceil
    draws = _jax_draws(jax.random.split(key)[1], k, 64 + MAX_GT)

    model = build_model("mobile", CLASSES, cfg)
    model.load_state_dict(convert_from_jax(weights, "mobile", num_anchors=12), strict=True)
    before = {n: t.clone() for n, t in model.state_dict().items()}
    solver = SolverWrapper(model, roidb, cfg, reader=cv2.imread, device="cpu")
    losses = solver.train_step(blobs, draws)
    assert float(jlosses["rpn_loss_box"]) > 0 and int(solver.aux["n_fg"]) > 0
    for name, want in jlosses.items():
        got, want = float(losses[name]), float(want)
        assert abs(got - want) <= 1e-4 * max(abs(want), 1e-6), (name, got, want)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    delta = convert_from_jax(jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                                          new_params, weights), "mobile",
                             num_anchors=12)
    after = model.state_dict()
    moved = 0
    for name, d_jax in delta.items():
        d_jax, d_port = d_jax.numpy(), (after[name] - before[name]).numpy()
        if name not in trainable:
            assert not d_jax.any() and not d_port.any(), name
            continue
        assert np.abs(d_jax).max() > 0, name
        _close(d_port, d_jax, 1e-3)
        moved += 1
    assert moved == len(trainable) and "cls_score.weight" in trainable


# ---------------------------------------------------------------------------
# (d): test_net and COCOEval on the same weights
# ---------------------------------------------------------------------------


def test_test_net_matches_jax(coco_dir, tmp_path, weights):
    # every roi scores in every class: some land on a gt of their class by chance
    overrides = OVERRIDES + ["TEST.SCORE_THRESH", "0.0"]
    jcfg = jax_cfg_from_list(jax_default_config(), overrides)
    cfg = cfg_from_list(default_config(), overrides)
    jmodel = jax_build_model("mobile", CLASSES, jcfg)
    model = build_model("mobile", CLASSES, cfg)
    model.load_state_dict(convert_from_jax(weights, "mobile", num_anchors=12), strict=True)
    ours, theirs = _pair(coco_dir, "minival", tmp_path)
    per_image = CLASSES * 32                        # every per-class survivor: no top-k cut
    build.reset_launch_counts()
    got = port_test.test_net(model.eval(), ours, cfg, str(tmp_path / "port"),
                             max_per_image=per_image, batch=2, device="cpu")
    assert sum(build.LAUNCH_COUNTS.values()) == 0              # CPU tensors: the twins
    want = jax_test.test_net(jmodel, {"params": weights}, theirs, jcfg, str(tmp_path / "jax"),
                             max_per_image=per_image, batch=2, verbose=False)
    assert got.keys() == want.keys() and len(got) == 12
    for name, v in want.items():
        assert abs(got[name] - v) <= 1e-6, (name, got[name], v)
    assert max(got.values()) > 0
    dets = {}
    for side in ("port", "jax"):
        with open(tmp_path / side / "detections.pkl", "rb") as f:
            dets[side] = pickle.load(f)
        assert osp.exists(tmp_path / side / "detections_coco_2014_minival_results.json")
    total = 0
    for cls in range(1, CLASSES):
        for im in range(3):
            _assert_det_sets_match(dets["jax"][cls][im], dets["port"][cls][im],
                                   f"image {im} class {cls}")
            total += len(dets["port"][cls][im])
    assert total > 100


# ---------------------------------------------------------------------------
# (e): the CLIs on the COCO recipe's imdbs
# ---------------------------------------------------------------------------


def test_clis_train_then_test_on_coco(coco_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(summary.SummaryWriter, "_board", lambda self: None)
    common = ["DATA_DIR", coco_dir, "ROOT_DIR", str(tmp_path), *OVERRIDES,
              "TRAIN.SNAPSHOT_ITERS", "2", "TRAIN.DISPLAY", "1", "TEST.SCORE_THRESH", "0.0"]
    imdb = "coco_2014_train+coco_2014_valminusminival"
    solver = trainval_net_cli.main(["--cpu", "--net", "mobile", "--imdb", imdb, "--imdbval", "",
                                    "--iters", "2", "--set", *common])
    assert solver.step == 2 and len(solver.data_layer._roidb) == 6   # 3 images, their flips
    out = osp.join(str(tmp_path), "output", "default", imdb, "default")
    with open(osp.join(out, "train_log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["iter"] for r in records] == [1, 2] and np.isfinite(records[-1]["total_loss"])
    stats = test_net_cli.main(["--cpu", "--net", "mobile", "--imdb", "coco_2014_minival",
                               "--model", osp.join(out, "default_iter_2.pth"), "--batch", "2",
                               "--set", *common])
    assert set(stats) == {"AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10", "AR100",
                          "ARs", "ARm", "ARl"}
    assert all(-1.0 <= v <= 1.0 for v in stats.values())
    test_out = osp.join(str(tmp_path), "output", "default", "coco_2014_minival", "default")
    with open(osp.join(test_out, "detections_coco_2014_minival_results.json")) as f:
        results = json.load(f)
    assert results and {r["category_id"] for r in results} <= set(COCO_IDS)
    assert {r["image_id"] for r in results} <= set(coco("minival", "2014",
                                                        data_dir=coco_dir).image_index)


# ---------------------------------------------------------------------------
# (f): the C4 threshold route of the proposal layer
# ---------------------------------------------------------------------------


def test_proposal_threshold_route_is_bit_equal(monkeypatch):
    anchors = generate_anchors_pre(50, 76, 16)[0]                       # 34200 anchors
    rng = np.random.RandomState(31)
    k = len(anchors)
    scores = (np.round(rng.uniform(0, 1, (2, k)) * 256) / 256).astype(np.float32)   # ties
    deltas = (rng.randn(2, k, 4) * 0.1).astype(np.float32)
    im_info = np.array([[800.0, 1216.0, 1.0], [600.0, 912.0, 1.0]], np.float32)  # NEG_INF tail
    kw = dict(pre_nms_top_n=1000, post_nms_top_n=300, nms_thresh=0.7)
    args = [torch.from_numpy(a) for a in (scores, deltas, anchors, im_info)]
    build.reset_launch_counts()
    on = proposal_layer_batch(*args, use_threshold=True, **kw)
    off = proposal_layer_batch(*args, use_threshold=False, **kw)
    assert sum(build.LAUNCH_COUNTS.values()) == 0              # CPU tensors: the twins
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    monkeypatch.setattr(jax_select_kernel, "topk_threshold",
                        partial(jax_select_kernel.topk_threshold, interpret=True))
    want = jax_proposal_layer_batch(*[jnp.asarray(a) for a in (scores, deltas, anchors,
                                                                  im_info)],
                                    use_threshold=True, **kw)
    # the same rois in the same order: scores (read from the input) and valid
    # masks bit-equal; boxes within the f32 rounding of XLA's decode
    rois, roi_scores, valid = (np.asarray(v) for v in want)
    np.testing.assert_array_equal(on[1].numpy(), roi_scores)
    np.testing.assert_array_equal(on[2].numpy(), valid)
    np.testing.assert_allclose(on[0].numpy(), rois, rtol=1e-6, atol=1e-4)
    assert 0 < int(on[2][1].sum()) <= 300 and int(on[2].sum()) > 300


# ---------------------------------------------------------------------------
# (g): the recipe's config and its wrappers
# ---------------------------------------------------------------------------


def test_anchor_scales_list_syntax_and_res101_cfg():
    args = ["ANCHOR_SCALES", "[4,8,16,32]", "ANCHOR_RATIOS", "[0.5,1,2]",
            "TRAIN.STEPSIZE", "[350000]"]
    cfg = cfg_from_file(cfg_from_list(default_config(), args),
                        osp.join(ROOT, "experiments", "cfgs", "res101.yml"))
    jcfg = jax_cfg_from_file(jax_cfg_from_list(jax_default_config(), args),
                             osp.join(ROOT, "experiments", "cfgs", "res101.yml"))
    assert cfg.ANCHOR_SCALES == jcfg.ANCHOR_SCALES == (4.0, 8.0, 16.0, 32.0)
    assert cfg.ANCHOR_RATIOS == jcfg.ANCHOR_RATIOS and cfg.TRAIN.STEPSIZE == (350000,)
    assert cfg.num_anchors == jcfg.num_anchors == 12
    assert (cfg.EXP_DIR, cfg.TRAIN.SNAPSHOT_PREFIX, cfg.POOLING_MODE) == \
        (jcfg.EXP_DIR, jcfg.TRAIN.SNAPSHOT_PREFIX, jcfg.POOLING_MODE) == \
        ("res101", "res101_faster_rcnn", "align")
    with torch.device("meta"):
        model = build_model("res101", CLASSES, cfg)
    assert model.rpn_cls_score.out_channels == 24 and model.rpn_bbox_pred.out_channels == 48
    assert model.cls_score.out_features == CLASSES
    assert generate_anchors_pre(38, 64, 16, scales=cfg.ANCHOR_SCALES)[0].shape == (29184, 4)


def _script_calls(tmp_path, script, dataset, net):
    """Run ``experiments/scripts/<script>`` from a copy of experiments/ with
    a ``python`` on PATH that only records its arguments: the argument
    lists the script passes, one per call."""
    shutil.copytree(osp.join(ROOT, "experiments"), tmp_path / "experiments",
                    ignore=shutil.ignore_patterns("logs"))
    bindir = tmp_path / "bin"
    bindir.mkdir()
    calls = tmp_path / "calls.jsonl"
    stub = bindir / "python"
    stub.write_text("#!/bin/sh\nexec \"$REAL_PYTHON\" -c 'import json, sys; "
                    "print(json.dumps(sys.argv[1:]))' \"$@\" >> \"$CALLS\"\n")
    stub.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}", CALLS=str(calls),
               REAL_PYTHON=sys.executable)
    subprocess.run(["bash", f"experiments/scripts/{script}", dataset, net], cwd=tmp_path,
                   env=env, check=True, capture_output=True, timeout=60)
    with open(calls) as f:
        return [json.loads(line) for line in f]


def test_recipe_wrappers_parse_in_the_port_clis(tmp_path, monkeypatch):
    calls = _script_calls(tmp_path, "train_faster_rcnn_torch.sh", "coco", "res101")
    assert [c[:2] for c in calls] == [["-m", "frcnn_tpu_torch.tools.trainval_net"],
                                      ["-m", "frcnn_tpu_torch.tools.test_net"]]
    seen = {}
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(trainval_net_cli, "_train", lambda args, mesh=None: seen.update(
        train=args))
    trainval_net_cli.main(calls[0][2:])
    args = seen["train"]
    assert (args.imdb_name, args.imdbval_name, args.max_iters, args.net) == (
        "coco_2014_train+coco_2014_valminusminival", "coco_2014_minival", 490000, "res101")
    cfg = cfg_from_list(cfg_from_file(default_config(), args.cfg_file), args.set_cfgs)
    assert cfg.ANCHOR_SCALES == (4.0, 8.0, 16.0, 32.0) and cfg.TRAIN.STEPSIZE == (350000,)
    assert cfg.EXP_DIR == "res101"

    test_args = test_net_cli.parse_args(calls[1][2:])
    assert test_args.imdb_name == "coco_2014_minival" and test_args.net == "res101"
    cfg = cfg_from_list(cfg_from_file(default_config(), test_args.cfg_file),
                        test_args.set_cfgs)
    assert cfg.num_anchors == 12
    assert test_args.model_ckpt == ("output/res101/coco_2014_train+coco_2014_valminusminival/"
                                    "default/res101_faster_rcnn_iter_490000.pth")
    # the other datasets, as the JAX wrappers give them
    for dataset, iters, scales in (("pascal_voc", 70000, (8.0, 16.0, 32.0)),
                                   ("pascal_voc_0712", 110000, (8.0, 16.0, 32.0))):
        sub = tmp_path / dataset
        sub.mkdir()
        call = _script_calls(sub, "test_faster_rcnn_torch.sh", dataset, "res50")[0]
        parsed = test_net_cli.parse_args(call[2:])
        assert parsed.model_ckpt.endswith(f"res50_faster_rcnn_iter_{iters}.pth")
        assert cfg_from_list(default_config(), parsed.set_cfgs).ANCHOR_SCALES == scales


# ---------------------------------------------------------------------------
# COCOEval, vectorised, against the JAX loops
# ---------------------------------------------------------------------------


def _eval_case(seed, n_img=40, cats=(3, 7, 12, 44, 90)):
    """Seeded gts and dets: crowds, explicit ``ignore`` flags, areas across
    the small/medium/large ranges, dets jittered from gts at many IoUs plus
    strays, scores on a grid of 100 (ties), images with gts and no dets and
    dets and no gts, and an image of 150 dets in one category (maxDets)."""
    rng = np.random.RandomState(seed)
    gts, dts = [], []
    aid = 1
    for i in range(n_img):
        for _ in range(rng.randint(0, 12) if i % 9 else 0):
            w, h = rng.choice([8, 20, 40, 90, 150]) * rng.uniform(0.7, 1.3, 2)
            x, y = rng.uniform(0, 400, 2)
            g = {"id": aid, "image_id": i, "category_id": int(cats[rng.randint(len(cats))]),
                 "bbox": [float(x), float(y), float(w), float(h)],
                 "area": float(w * h * rng.uniform(0.6, 1.0)), "iscrowd": int(rng.rand() < 0.1)}
            if rng.rand() < 0.05:
                g["ignore"] = 1
            gts.append(g)
            aid += 1
            if i % 7:
                for _ in range(rng.randint(0, 4)):
                    j = rng.normal(0, 0.15, 4) * [w, h, w, h]
                    dts.append({"image_id": i, "category_id": g["category_id"],
                                "bbox": [float(x + j[0]), float(y + j[1]),
                                         float(max(w + j[2], 1)), float(max(h + j[3], 1))],
                                "score": float(np.round(rng.rand(), 2))})
        for _ in range(150 if i == 5 else rng.randint(0, 6)):
            w, h = rng.uniform(5, 200, 2)
            x, y = rng.uniform(0, 400, 2)
            c = cats[0] if i == 5 else cats[rng.randint(len(cats))]
            dts.append({"image_id": i, "category_id": int(c),
                        "bbox": [float(x), float(y), float(w), float(h)],
                        "score": float(np.round(rng.rand(), 2))})
    return gts, dts, [{"id": c, "name": str(c)} for c in cats]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_eval_matches_jax_loops(seed):
    gts, dts, cats = _eval_case(seed)
    ours = COCOEval(copy.deepcopy(gts), copy.deepcopy(dts), cats)
    theirs = JaxCOCOEval(copy.deepcopy(gts), copy.deepcopy(dts), cats)
    for ev in (ours, theirs):
        ev.evaluate()
        ev.accumulate()
    assert ours.eval_imgs.keys() == theirs.eval_imgs.keys()
    seen = {"crowd": 0, "ignored": 0, "cut": 0, "no_dets": 0, "no_gts": 0}
    for key, want in theirs.eval_imgs.items():
        got = ours.eval_imgs[key]
        assert (got is None) == (want is None), key
        if want is None:
            continue
        for field, value in want.items():
            np.testing.assert_array_equal(got[field], value, f"{key} {field}")
            assert got[field].dtype == value.dtype, (key, field)
        seen["ignored"] += int(want["gtIgnore"].sum() > 0)
        seen["no_dets"] += int(len(want["dtScores"]) == 0)
        seen["no_gts"] += int(len(want["gtIgnore"]) == 0)
        seen["cut"] += int(len(want["dtScores"]) == 100)
    seen["crowd"] = sum(g["iscrowd"] for g in gts)
    assert all(v > 0 for v in seen.values()), seen
    np.testing.assert_array_equal(ours.eval["precision"], theirs.eval["precision"])
    np.testing.assert_array_equal(ours.eval["recall"], theirs.eval["recall"])
    got, want = ours.summarize(verbose=False), theirs.summarize(verbose=False)
    for name, v in want.items():
        assert abs(got[name] - v) <= 1e-12, name
    assert 0 < want["AP"] < 1


def test_bbox_iou_xywh_matches_jax_loop():
    from frcnn_tpu.data.coco_eval import bbox_iou_xywh as jax_iou

    from frcnn_tpu_torch.data.coco_eval import bbox_iou_xywh

    rng = np.random.RandomState(4)
    dt = np.concatenate([rng.uniform(0, 50, (30, 2)), rng.uniform(1, 30, (30, 2))], 1)
    gt = np.concatenate([dt[:10], np.concatenate([rng.uniform(0, 50, (10, 2)),
                                                  rng.uniform(1, 30, (10, 2))], 1)])
    gt[12] = [dt[3, 0] + dt[3, 2], dt[3, 1], 5, 5]                 # touching: iw = 0
    crowd = rng.uniform(0, 1, len(gt)) < 0.3
    got = bbox_iou_xywh(dt.tolist(), gt.tolist(), crowd.tolist())
    want = jax_iou(dt.tolist(), gt.tolist(), crowd.astype(int).tolist())
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and (got == 1).any() and ((got > 0) & (got < 1)).any()
    assert bbox_iou_xywh([], gt, crowd).shape == (0, len(gt))
