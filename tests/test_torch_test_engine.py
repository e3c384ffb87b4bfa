"""The port's test engine against the JAX package's, on the CPU, f32.

A small VOC devkit whose images have a short side of TEST.SCALES[0] and fit
the bucket, so that neither side resizes and both see the same blobs: three
images, so that ``test_net``'s last batch of 2 holds a zero-image pad slot.
res50 C4 (weights of ``_detector_state_dict``, the lineage names, carried to
JAX by ``convert_detector``) and res50_fpn (the FPN tests' seeded JAX tree,
carried to the port by ``convert_fpn_from_jax``):

  * ``test_net``: the detections of detections.pkl matched per image and
    class (``_assert_det_sets_match``) and the per-class APs within 1e-4;
  * ``im_detect``: valid rows equal, scores and boxes within 1e-4 of their
    max;
  * ``apply_nms`` keeps JAX's rows;
  * the CLIs in-process with ``--cpu``: ``trainval_net`` for 2 iterations,
    then ``test_net --model`` on its snapshot; detections.pkl and the AP
    files are written; ``trainval_net --data-parallel 2 --cpu`` on two gloo
    ranks, and its refusals (more ranks than cards, a negative count).
"""

import os.path as osp
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from frcnn_tpu import cfg_from_list as jax_cfg_from_list
from frcnn_tpu import default_config as jax_default_config
from frcnn_tpu.data.pascal_voc import pascal_voc as JaxVoc
from frcnn_tpu.engine import test as jax_test
from frcnn_tpu.models import build_model as jax_build_model
from frcnn_tpu.utils.weight_convert import convert_detector
from frcnn_tpu_torch import cfg_from_list, default_config
from frcnn_tpu_torch.data.pascal_voc import pascal_voc
from frcnn_tpu_torch.engine import test as port_test
from frcnn_tpu_torch.models.network import build_model
from frcnn_tpu_torch.ops.cuda import build
from frcnn_tpu_torch.tools import test_net as test_net_cli
from frcnn_tpu_torch.tools import trainval_net as trainval_net_cli
from frcnn_tpu_torch.utils.weight_convert import convert_fpn_from_jax
from tests.test_pipeline_parity import NUM_CLASSES, _assert_det_sets_match, _detector_state_dict
from tests.test_torch_fpn import _numpy_params

CLASSES = ("aeroplane", "bicycle", "bird", "boat")        # VOC classes 1-4: the C4 model's 5
SHAPES = ((128, 192), (128, 160), (128, 176))
NETS = {
    # net: (classes, overrides, max_per_image: every per-class survivor)
    "res50": (NUM_CLASSES, ["TEST.SCALES", "(128,)", "TEST.MAX_SIZE", "192",
                            "TEST.RPN_PRE_NMS_TOP_N", "400", "TEST.RPN_POST_NMS_TOP_N", "32",
                            "TPU.BUCKETS", "((128, 192),)"], NUM_CLASSES * 32),
    # 21 untrained classes score ~1/21, under the default threshold of 0.05
    "res50_fpn": (21, ["TEST.SCALES", "(128,)", "TEST.MAX_SIZE", "200",
                       "TEST.RPN_POST_NMS_TOP_N", "64", "TPU.BUCKETS", "((128, 200),)",
                       "TEST.SCORE_THRESH", "0.0"], 21 * 64),
}


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    """VOCdevkit2007 with a trainval and a test split of three JPEGs each:
    low-frequency noise (few exactly tied scores) and flat boxes, labelled
    with CLASSES."""
    import cv2

    root = tmp_path_factory.mktemp("engine_data")
    d = root / "VOCdevkit2007" / "VOC2007"
    for sub in ("Annotations", "ImageSets/Main", "JPEGImages"):
        (d / sub).mkdir(parents=True)
    rng = np.random.RandomState(21)
    names = []
    for i, (h, w) in enumerate(SHAPES * 2):
        base = rng.randint(0, 255, (h // 16 + 1, w // 16 + 1, 3)).astype(np.uint8)
        im = cv2.resize(base, (w, h), interpolation=cv2.INTER_LINEAR)
        objs = []
        for j in range(rng.randint(3, 6)):
            # tall boxes, 50-110 px wide: the shapes the C4 anchors (128-512 px)
            # clipped to a 128-pixel image give, so that random heads hit some
            x1, y1 = rng.randint(0, w - 110), rng.randint(0, 40)
            x2, y2 = x1 + rng.randint(50, 110), rng.randint(100, h)
            im[y1:y2, x1:x2] = rng.randint(0, 255, 3)
            objs.append(f"<object><name>{CLASSES[rng.randint(0, 4)]}</name><difficult>0"
                        f"</difficult><bndbox><xmin>{x1 + 1}</xmin><ymin>{y1 + 1}</ymin>"
                        f"<xmax>{x2 + 1}</xmax><ymax>{y2 + 1}</ymax></bndbox></object>")
        name = f"{i:06d}"
        names.append(name)
        cv2.imwrite(str(d / "JPEGImages" / f"{name}.jpg"), im)
        (d / "Annotations" / f"{name}.xml").write_text(
            f"<annotation><size><width>{w}</width><height>{h}</height></size>"
            + "".join(objs) + "</annotation>")
    (d / "ImageSets" / "Main" / "trainval.txt").write_text("\n".join(names[:3]) + "\n")
    (d / "ImageSets" / "Main" / "test.txt").write_text("\n".join(names[3:]) + "\n")
    return root


def _models(net):
    """(port model, JAX model, JAX variables) with one set of weights."""
    classes, overrides, _ = NETS[net]
    jcfg = jax_cfg_from_list(jax_default_config(), overrides)
    cfg = cfg_from_list(default_config(), overrides)
    jmodel = jax_build_model(net, classes, jcfg)
    model = build_model(net, classes, cfg)
    if net == "res50":
        sd = _detector_state_dict(np.random.RandomState(0))
        params = convert_detector({k: v.numpy() for k, v in sd.items()}, "res50")
    else:
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((2, 128, 200, 3)),
                                jnp.zeros((2, 3)))
        params = _numpy_params(shapes["params"])
        sd = convert_fpn_from_jax(params, net)
    model.load_state_dict(sd, strict=True)
    return model.eval(), jmodel, {"params": params}


@pytest.fixture(scope="module", params=list(NETS))
def evaluated(request, devkit, tmp_path_factory):
    net = request.param
    _, _, max_per_image = NETS[net]
    model, jmodel, variables = _models(net)
    out = tmp_path_factory.mktemp(f"test_net_{net}")
    devkit_path = str(devkit / "VOCdevkit2007")
    ours = pascal_voc("test", "2007", devkit_path=devkit_path, data_dir=str(out / "port"))
    theirs = JaxVoc("test", "2007", devkit_path=devkit_path, data_dir=str(out / "jax"))
    build.reset_launch_counts()
    got = port_test.test_net(model, ours, model.config, str(out / "port"),
                             max_per_image=max_per_image, batch=2, device="cpu")
    assert sum(build.LAUNCH_COUNTS.values()) == 0               # CPU tensors: the twins
    want = jax_test.test_net(jmodel, variables, theirs, jmodel.config, str(out / "jax"),
                             max_per_image=max_per_image, batch=2, verbose=False)
    dets = {}
    for side in ("port", "jax"):
        with open(out / side / "detections.pkl", "rb") as f:
            dets[side] = pickle.load(f)
    return {"net": net, "model": model, "jmodel": jmodel, "variables": variables,
            "aps": (got, want), "dets": dets}


def test_test_net_matches_jax(evaluated):
    got, want = evaluated["aps"]
    assert got.keys() == want.keys()
    for cls, ap in want.items():
        assert abs(got[cls] - ap) <= 1e-4, (cls, got[cls], ap)
    assert 0.0 < got["mAP"] <= 1.0
    ours, theirs = evaluated["dets"]["port"], evaluated["dets"]["jax"]
    assert len(ours) == len(theirs) == 21 and all(len(c) == 3 for c in ours)
    total = 0
    for cls in range(21):
        for im in range(3):
            _assert_det_sets_match(theirs[cls][im], ours[cls][im],
                                   f"{evaluated['net']} image {im} class {cls}")
            total += len(ours[cls][im])
    assert total > 10


def test_im_detect_matches_jax(evaluated, devkit):
    import cv2

    im = cv2.imread(str(devkit / "VOCdevkit2007" / "VOC2007" / "JPEGImages" / "000004.jpg"))
    scores, boxes, valid = port_test.im_detect(evaluated["model"], im, device="cpu")
    jscores, jboxes, jvalid = jax_test.im_detect(evaluated["jmodel"], evaluated["variables"], im)
    np.testing.assert_array_equal(valid, jvalid)
    assert valid.sum() > 10 and boxes.shape[1] == 4 * scores.shape[1]
    for ours, theirs in ((scores, jscores), (boxes, jboxes)):
        ours, theirs = ours[valid], theirs[valid]
        assert np.abs(ours - theirs).max() <= 1e-4 * np.abs(theirs).max()


def test_apply_nms_matches_jax():
    rng = np.random.RandomState(13)
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in range(3)] for _ in range(3)]
    for cls in (1, 2):
        for im in range(3):
            n = rng.randint(1, 40)
            xy = rng.uniform(0, 60, (n, 2))                  # crowded: some suppress
            wh = rng.uniform(10, 80, (n, 2))
            all_boxes[cls][im] = np.concatenate(
                [xy, xy + wh, rng.permutation(n)[:, None] / n + 0.01], 1).astype(np.float32)
    for thresh in (0.3, 0.7):
        ours, theirs = port_test.apply_nms(all_boxes, thresh), jax_test.apply_nms(all_boxes, thresh)
        kept = 0
        for cls in range(3):
            for im in range(3):
                np.testing.assert_array_equal(ours[cls][im], theirs[cls][im])
                kept += len(ours[cls][im])
        assert 0 < kept < sum(len(b) for c in all_boxes for b in c)


def test_clis_train_then_test(devkit, tmp_path):
    common = ["DATA_DIR", str(devkit), "ROOT_DIR", str(tmp_path), "TRAIN.SCALES", "(128,)",
              "TRAIN.MAX_SIZE", "192", "TEST.SCALES", "(128,)", "TEST.MAX_SIZE", "192",
              "TPU.BUCKETS", "((128, 192),)", "TRAIN.IMS_PER_BATCH", "2",
              "TRAIN.RPN_PRE_NMS_TOP_N", "400", "TRAIN.RPN_POST_NMS_TOP_N", "64",
              "TRAIN.BATCH_SIZE", "32", "TRAIN.RPN_BATCHSIZE", "64", "TPU.MAX_GT", "8",
              "TEST.RPN_PRE_NMS_TOP_N", "400", "TEST.RPN_POST_NMS_TOP_N", "32",
              "TEST.SCORE_THRESH", "0.0", "ANCHOR_SCALES", "(2, 4, 8)",
              "TRAIN.SNAPSHOT_ITERS", "2", "TRAIN.DISPLAY", "1"]
    solver = trainval_net_cli.main(["--cpu", "--net", "res50", "--imdb", "voc_2007_trainval",
                                    "--imdbval", "", "--iters", "2", "--set", *common])
    assert solver.device == torch.device("cpu") and solver.step == 2
    out = osp.join(str(tmp_path), "output", "default", "voc_2007_trainval", "default")
    snapshot = osp.join(out, "default_iter_2.pth")
    assert osp.exists(snapshot) and osp.exists(osp.join(out, "train_log.jsonl"))
    results = test_net_cli.main(["--cpu", "--net", "res50", "--imdb", "voc_2007_test",
                                 "--model", snapshot, "--batch", "2", "--set", *common])
    assert 0.0 <= results["mAP"] <= 1.0
    test_out = osp.join(str(tmp_path), "output", "default", "voc_2007_test", "default")
    with open(osp.join(test_out, "detections.pkl"), "rb") as f:
        all_boxes = pickle.load(f)
    assert len(all_boxes) == 21 and sum(len(b) for c in all_boxes for b in c) > 0
    for cls in CLASSES:
        assert osp.exists(osp.join(test_out, f"{cls}_pr.pkl"))


def test_cli_refuses_data_parallel(capsys):
    """More ranks than cards (here: none) over NCCL: refused, never run on
    fewer devices or on the CPU."""
    assert torch.cuda.device_count() < 4
    with pytest.raises(SystemExit):
        trainval_net_cli.parse_args(["--data-parallel", "4"])
    assert "needs 4 CUDA cards" in capsys.readouterr().err


def test_cli_refuses_a_negative_data_parallel(capsys):
    with pytest.raises(SystemExit):
        trainval_net_cli.parse_args(["--data-parallel", "-1", "--cpu"])
    assert "must be >= 0" in capsys.readouterr().err


def test_cli_data_parallel_on_the_cpu(voc_root, tmp_path):
    """``--data-parallel 2 --cpu``: two gloo ranks on the CPU train 2
    iterations over the synthetic VOC devkit; rank 0 writes the snapshot."""
    args = ["--cpu", "--data-parallel", "2", "--net", "mobile", "--imdb", "voc_2007_trainval",
            "--imdbval", "", "--iters", "2"]
    assert trainval_net_cli.parse_args(args).data_parallel == 2
    out = trainval_net_cli.main(args + [
        "--set", "DATA_DIR", voc_root[0], "ROOT_DIR", str(tmp_path),
        "MOBILENET.DEPTH_MULTIPLIER", "0.25", "TRAIN.SCALES", "(160,)", "TRAIN.MAX_SIZE", "256",
        "TPU.BUCKETS", "((160, 256),)", "TRAIN.IMS_PER_BATCH", "2",
        "TRAIN.RPN_PRE_NMS_TOP_N", "256", "TRAIN.RPN_POST_NMS_TOP_N", "32",
        "TRAIN.BATCH_SIZE", "32", "TRAIN.RPN_BATCHSIZE", "64", "TRAIN.SNAPSHOT_ITERS", "2"])
    assert out == [{"rank": r, "step": 2, "device": "cpu"} for r in range(2)]
    run = osp.join(str(tmp_path), "output", "default", "voc_2007_trainval", "default")
    assert osp.exists(osp.join(run, "default_iter_2.pth"))
    with open(osp.join(run, "train_log.jsonl")) as f:
        assert len(f.read().splitlines()) == 0      # DISPLAY 10: no line at step 2
