"""``scripts/ap_regression_torch.py`` (the port's trained-AP check) against
``scripts/ap_regression.py`` and ``tools/make_synthetic_voc.py``, on the
CPU:

  * its numpy draw of the synthetic VOC gives the tool's image names,
    splits, sizes, boxes and classes, and pixels that cv2 encodes into the
    tool's JPEG files byte for byte (within JPEG error of the decoded files:
    mean |delta| < 4 inside the flat boxes);
  * its recipe is ``ap_regression.py``'s: the JAX script's config, taken
    where it calls ``train_net``, equals the JAX default config with the
    port's ``RECIPE`` applied, TRAIN.IMAGE_CACHE included;
  * its whole run end to end at a small bucket for 2 iterations on the CPU
    (``--cpu``), down to the JSON result.
"""

import importlib.util
import os.path as osp
import subprocess
import sys
import xml.etree.ElementTree as ET

import cv2
import numpy as np
import pytest

import frcnn_tpu.engine.train as jax_train
from frcnn_tpu import cfg_from_list as jax_cfg_from_list
from frcnn_tpu import default_config as jax_default_config
from frcnn_tpu_torch import cfg_from_list, default_config

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, osp.join(ROOT, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ap_torch = _load("ap_regression_torch", "scripts/ap_regression_torch.py")


@pytest.fixture(scope="module")
def devkits(tmp_path_factory):
    """The tool's devkit (JPEG files) and the script's (a reader)."""
    tool_root = tmp_path_factory.mktemp("tool")
    subprocess.run([sys.executable, osp.join(ROOT, "tools", "make_synthetic_voc.py"),
                    "--root", str(tool_root), "--images", "120", "--seed", "0"],
                   check=True, capture_output=True, timeout=300)
    port_root = tmp_path_factory.mktemp("port")
    reader = ap_torch.synthetic_voc(str(port_root))
    voc = [osp.join(str(r), "VOCdevkit2007", "VOC2007") for r in (tool_root, port_root)]
    return tool_root, voc, reader


def _split(voc, name):
    with open(osp.join(voc, "ImageSets", "Main", name + ".txt")) as f:
        return f.read().split()


def _annotation(voc, index):
    ann = ET.parse(osp.join(voc, "Annotations", index + ".xml"))
    size = tuple(int(ann.find(f"size/{t}").text) for t in ("height", "width"))
    objs = [(o.find("name").text, int(o.find("difficult").text),
             tuple(int(o.find(f"bndbox/{t}").text) for t in ("xmin", "ymin", "xmax", "ymax")))
            for o in ann.findall("object")]
    return size, objs


def test_names_splits_and_boxes_equal_the_tool(devkits):
    _, (tool, port), _ = devkits
    for split, n in (("trainval", 90), ("test", 30)):
        assert _split(port, split) == _split(tool, split)
        assert len(_split(tool, split)) == n
    classes = set()
    for index in _split(tool, "trainval") + _split(tool, "test"):
        want = _annotation(tool, index)
        assert _annotation(port, index) == want, index
        classes |= {name for name, _, _ in want[1]}
    assert classes == set(ap_torch.CLASSES)


def test_pixels_are_the_tools_before_its_jpeg_encoding(devkits):
    """cv2's JPEG encoder (the tool's ``imwrite`` at its default quality)
    turns the script's pixels into the tool's files byte for byte, so the
    decoded files are the script's pixels through the codec.  The codec's
    error on this data is not small (uniform noise in [0, 80) around the
    boxes): its mean is reported and bounded inside the flat boxes only."""
    _, (tool, port), reader = devkits
    inside, overall = [], []
    for index in _split(tool, "trainval") + _split(tool, "test"):
        path = osp.join(tool, "JPEGImages", index + ".jpg")
        ours = reader(osp.join(port, "JPEGImages", index + ".jpg"))
        assert ours.dtype == np.uint8 and ours.shape[:2] == _annotation(tool, index)[0]
        ok, encoded = cv2.imencode(".jpg", ours)
        with open(path, "rb") as f:
            assert ok and encoded.tobytes() == f.read(), index
        delta = np.abs(ours.astype(np.float64) - cv2.imread(path))
        overall.append(delta.mean())
        for _, _, (x1, y1, x2, y2) in _annotation(tool, index)[1]:
            inside.append(delta[y1 + 7:y2 - 9, x1 + 7:x2 - 9].mean())   # 8x8 blocks off the edge
    assert max(inside) < 4.0
    print(f"JPEG error, mean |delta|: {np.mean(overall):.2f} overall, "
          f"{np.mean(inside):.2f} inside the boxes")


class _AtTrainNet(Exception):
    def __init__(self, cfg):
        super().__init__("train_net reached")
        self.cfg = cfg


def test_recipe_equals_ap_regression(devkits, monkeypatch):
    tool_root, _, _ = devkits

    def stop(model, imdb, roidb, valroidb, output_dir, cfg=None, **kw):
        assert model.norm == "group" and len(roidb) == 180        # 90 images and their flips
        raise _AtTrainNet(cfg)

    monkeypatch.setattr(jax_train, "train_net", stop)
    monkeypatch.setattr(sys, "argv", ["ap_regression.py", "--root", str(tool_root)])
    np_state = np.random.get_state()
    try:
        with pytest.raises(_AtTrainNet) as stopped:
            _load("ap_regression", "scripts/ap_regression.py").main()
    finally:
        np.random.set_state(np_state)
    want = stopped.value.cfg
    assert want.TRAIN.IMAGE_CACHE
    recipe = [k.replace("DEVICE.", "TPU.") for k in ap_torch.RECIPE[0::2]]
    got = jax_cfg_from_list(jax_default_config(), [
        v for pair in zip(recipe, ap_torch.RECIPE[1::2]) for v in pair]
        + ["DATA_DIR", str(tool_root)])
    assert got == want
    port = cfg_from_list(default_config(), ap_torch.RECIPE)
    assert port.TRAIN.IMAGE_CACHE and port.DEVICE.BUCKETS == ((608, 1024),)
    assert port.RESNET.FIXED_BLOCKS == 0 and port.TRAIN.STEPSIZE == (1200,)


def test_script_runs_on_the_cpu(tmp_path, monkeypatch):
    """The script's whole run (data, ``train_net`` from the from-scratch
    init, ``test_net`` in competition mode, the mean AP over the present
    classes, the JSON) in a CPU rehearsal: 2 iterations at a 160x256
    bucket, no floor."""
    import json

    small = {"TRAIN.SCALES": "(160,)", "TRAIN.MAX_SIZE": "256", "TEST.SCALES": "(160,)",
             "TEST.MAX_SIZE": "256", "DEVICE.BUCKETS": "((160, 256),)", "TRAIN.DISPLAY": "1"}
    recipe = [x for k, v in zip(ap_torch.RECIPE[0::2], ap_torch.RECIPE[1::2])
              for x in (k, small.get(k, v))]
    monkeypatch.setattr(ap_torch, "RECIPE", recipe + ["FPN.PRE_NMS_PER_LEVEL_TEST", "200"])
    out = tmp_path / "ap.json"
    rc = ap_torch.main(["--cpu", "--iters", "2", "--floor", "0.0", "--root", str(tmp_path),
                        "--json-out", str(out)])
    result = json.loads(out.read_text())
    assert rc == 0 and result["pass"] and result["backend"] == "cpu"
    assert set(result["per_class"]) == set(ap_torch.CLASSES)
    assert all(0.0 <= v <= 1.0 for v in result["per_class"].values())
    assert result["iters"] == 2 and result["net"] == "res50_fpn_gn"
    assert (tmp_path / "cache" / "voc_2007_trainval_resized.dat").exists()    # IMAGE_CACHE
    assert set(result) >= {"mean_ap", "floor", "seconds", "s_per_iter_incl_compile",
                           "s_per_iter_steady", "device", "power_limit"}
