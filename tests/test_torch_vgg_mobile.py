"""VGG-16 and MobileNet-v1 in the port against the JAX package, on the CPU,
f32.  Weights are numpy-seeded in the JAX tree's shapes (He-normal kernels,
the first conv's 64x smaller: raw pixels are O(100); frozen BN near identity;
the RPN's class weights N(0, 0.03), so that its scores spread), carried to the
port by ``convert_from_jax``.  VGG-16's tail is 256 wide here (the JAX
``VGG16.tail_dim``; both packages build 4096), so that the f32 SGD step stays
small; its trunk is full width.  MobileNet runs at DEPTH_MULTIPLIER 0.25, the
width of the JAX package's own CPU tests.

  * the trunks within 1e-4 of max|features|, MobileNet's at an even and an
    odd image side (flax's "SAME" pads a stride-2 conv asymmetrically on an
    even side); the tails within 1e-4 of max|output|, VGG's also in training,
    with dropout on the same uniforms;
  * ``convert_from_jax``: a lineage VGG-16 state_dict through the JAX
    ``convert_detector`` and back is the same state_dict, bit for bit, and
    loads into the port strictly; a MobileNet tree maps every leaf to one
    port tensor and back, bit for bit;
  * ``detect`` through ``Detector``: matched per class by
    ``_assert_det_sets_match`` (score atol 1e-3, box atol 5e-2);
  * one SGD step each against a jitted JAX train step (``make_optimizer``),
    in f64 (``sgd_step`` says why): losses within 1e-4 relative, each tensor's update within 1e-3 of
    max|update|, frozen tensors exactly unchanged on both sides, and the
    trainable names those ``_param_labels`` does not freeze.  VGG's dropout:
    ``flax.linen.intercept_methods`` replaces each ``nn.Dropout`` call by
    flax's formula on the uniforms the port is given.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from frcnn_tpu import cfg_from_list as jax_cfg_from_list
from frcnn_tpu import default_config as jax_default_config
from frcnn_tpu.engine.serve import Detector as JaxDetector
from frcnn_tpu.engine.train import _param_labels, stop_frozen_gradients
from frcnn_tpu.engine.train import make_optimizer as jax_make_optimizer
from frcnn_tpu.models import build_model as jax_build_model
from frcnn_tpu.models.backbones import VGG16 as JaxVGG16
from frcnn_tpu.models.network import FasterRCNN as JaxFasterRCNN
from frcnn_tpu.utils.weight_convert import convert_detector
from frcnn_tpu_torch import cfg_from_list, default_config
from frcnn_tpu_torch.data.loader import get_minibatch
from frcnn_tpu_torch.engine.serve import Detector, iter_bucket_batches
from frcnn_tpu_torch.engine.train import SolverWrapper
from frcnn_tpu_torch.models.backbones import VGG16
from frcnn_tpu_torch.models.network import FasterRCNN, build_model
from frcnn_tpu_torch.ops.cuda import build
from frcnn_tpu_torch.utils.weight_convert import convert_from_jax
from tests.test_pipeline_parity import _assert_det_sets_match
from tests.test_torch_detect import _images
from tests.test_torch_train import OVERRIDES as TRAIN_OVERRIDES
from tests.test_torch_train import B, H, W, _close, _jax_draws, _roidb

NUM_CLASSES = 21
TAIL = 256
NETS = ("vgg16", "mobile")
SERVE = ["TEST.SCALES", "(128,)", "TEST.MAX_SIZE", "192", "TEST.RPN_PRE_NMS_TOP_N", "400",
         "TEST.RPN_POST_NMS_TOP_N", "32", "TPU.BUCKETS", "((128, 192),)",
         "MOBILENET.DEPTH_MULTIPLIER", "0.25"]
MAX_PER_IMAGE = NUM_CLASSES * 32  # every per-class survivor
HEAD_STD = {"rpn_cls_score": 0.03, "rpn_bbox_pred": 0.01, "cls_score": 0.01, "bbox_pred": 0.001}


def jax_model(net, cfg, dtype=jnp.float32):
    if net == "vgg16":
        return JaxFasterRCNN(backbone=JaxVGG16(tail_dim=TAIL, dtype=dtype),
                             num_classes=NUM_CLASSES, config=cfg, dtype=dtype)
    return jax_build_model(net, NUM_CLASSES, cfg, dtype=dtype)


def port_model(net, cfg, dtype=torch.float32):
    if net == "vgg16":
        return FasterRCNN(VGG16(tail_dim=TAIL), NUM_CLASSES, cfg, dtype=dtype)
    return build_model(net, NUM_CLASSES, cfg, dtype=dtype)


def numpy_params(jmodel, seed=0):
    """Seeded weights in the JAX tree's shapes (see the module docstring)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
                            jnp.zeros((1, 3)))["params"]
    rng = np.random.RandomState(seed)

    def make(path, s):
        keys = [p.key for p in path]
        if keys[-1] == "kernel":
            std = HEAD_STD.get(keys[0], np.sqrt(2.0 / np.prod(s.shape[:-1])))
            std /= 64.0 if keys[-2] in ("conv1_1", "conv0") else 1.0
            return (rng.randn(*s.shape) * std).astype(np.float32)
        if keys[-1] == "scale":
            return rng.uniform(0.5, 1.0, s.shape).astype(np.float32)
        if keys[-1] == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) * 0.05).astype(np.float32)   # bias, mean

    return jax.tree_util.tree_map_with_path(make, shapes)


def both_models(net, overrides):
    """(JAX model, its params, the port's model loaded from them)."""
    jmodel = jax_model(net, jax_cfg_from_list(jax_default_config(), overrides))
    params = numpy_params(jmodel)
    model = port_model(net, cfg_from_list(default_config(), overrides))
    model.load_state_dict(convert_from_jax(params, net), strict=True)
    return jmodel, params, model


@pytest.fixture(scope="module")
def served():
    return {net: both_models(net, SERVE) for net in NETS}


def _dropout_interceptor(uniforms):
    """Each ``nn.Dropout`` call of the tail (``Dropout_0`` after fc6,
    ``Dropout_1`` after fc7) replaced by flax's formula on the given
    uniforms: bernoulli(keep) is uniform < keep; kept inputs / keep."""
    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if not isinstance(mod, fnn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        x, keep = args[0], 1.0 - mod.rate
        u = uniforms[int(mod.name.split("_")[-1])]
        return jax.lax.select(u < keep, x / keep, jnp.zeros_like(x))

    return intercept


@pytest.mark.parametrize("net,hw", [("vgg16", (128, 192)), ("mobile", (96, 128)),
                                    ("mobile", (97, 131))])
def test_trunk_matches_jax(served, net, hw):
    jmodel, params, model = served[net]
    x = (np.random.RandomState(3).randn(2, *hw, 3) * 60).astype(np.float32)
    want = jmodel.apply({"params": params}, jnp.asarray(x),
                        method=lambda m, v: m.backbone.extract_features(v))
    with torch.no_grad():
        got = model.backbone.extract_features(torch.from_numpy(x).permute(0, 3, 1, 2))
    # VGG's pools floor each side; MobileNet's SAME convs take its ceiling
    side = (lambda n: n // 16) if net == "vgg16" else (lambda n: -(-n // 16))
    assert got.shape[2:] == want.shape[1:3] == tuple(map(side, hw))
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-4)
    assert np.abs(np.asarray(want)).max() > 0.1


@pytest.mark.parametrize("net", NETS)
def test_tail_matches_jax(served, net):
    jmodel, params, model = served[net]
    c = model.backbone.feat_channels
    rng = np.random.RandomState(4)
    pooled = rng.randn(6, 7, 7, c).astype(np.float32)
    tail = model.backbone.head_to_tail
    with torch.no_grad():
        got = tail(torch.from_numpy(pooled).permute(0, 3, 1, 2))
    want = jmodel.apply({"params": params}, jnp.asarray(pooled),
                        method=lambda m, v: m.backbone.head_to_tail(v, train=False))
    assert got.shape == want.shape == (6, model.backbone.tail_dim)
    _close(got.numpy(), want, 1e-4)
    if net != "vgg16":
        return
    drop = rng.uniform(0, 1, (2, 6, TAIL)).astype(np.float32)
    with torch.no_grad():
        got = tail(torch.from_numpy(pooled).permute(0, 3, 1, 2), torch.from_numpy(drop))
    with fnn.intercept_methods(_dropout_interceptor(jnp.asarray(drop))):
        want = jmodel.apply({"params": params}, jnp.asarray(pooled),
                            method=lambda m, v: m.backbone.head_to_tail(v, train=True),
                            rngs={"dropout": jax.random.PRNGKey(0)})
    assert 0 < (got.numpy() == 0).mean() < 1
    _close(got.numpy(), want, 1e-4)


def test_convert_vgg16_round_trip():
    """A lineage VGG-16 state_dict (torchvision names, fc6 over the C, H, W
    flattening) → the JAX ``convert_detector`` → ``convert_from_jax``: the
    same tensors bit for bit, under the port's own names and shapes."""
    rng = np.random.default_rng(5)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in
                  build_model("vgg16", NUM_CLASSES, default_config()).state_dict().items()}
    sd = {k: rng.standard_normal(s, dtype=np.float32) for k, s in shapes.items()}
    back = convert_from_jax(convert_detector(sd, "vgg16"), "vgg16")
    assert back.keys() == sd.keys()
    for name, want in sd.items():
        assert torch.equal(back[name], torch.from_numpy(want)), name


def _mobile_to_jax(sd):
    """The port's MobileNet detector state_dict → the JAX tree (this test's
    inverse of ``convert_from_jax``)."""
    tree = {"backbone": {"trunk": {}, "tail": {}}}
    bn = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
    for name, t in sd.items():
        a, *mid, leaf = name.split(".")
        t = t.numpy()
        if a in ("rpn_net", "rpn_cls_score", "rpn_bbox_pred", "cls_score", "bbox_pred"):
            continue                                         # the C4 heads: res50's recipe
        part = "tail" if a in ("sep12", "sep13") else "trunk"
        node = tree["backbone"][part].setdefault(a, {})
        sub = mid[0] if mid else None
        if leaf == "weight" and (sub or a) in ("depthwise", "pointwise", "conv0"):
            value, key = t.transpose(2, 3, 1, 0), "kernel"
        else:
            value, key = t, bn[leaf]
        (node.setdefault(sub, {}) if sub else node)[key] = value
    return tree


def test_convert_mobilenet_maps_every_leaf(served):
    _, params, model = served["mobile"]
    sd = convert_from_jax(params, "mobile")
    back = _mobile_to_jax(sd)["backbone"]
    flat_want = jax.tree_util.tree_flatten_with_path(params["backbone"])[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], leaf, err_msg=str(path))
    assert sd["sep3.depthwise.weight"].shape == (32, 1, 3, 3)    # HWIO (3, 3, 1, C) → OIHW
    for name, t in model.state_dict().items():
        assert torch.equal(t, sd[name]), name


@pytest.mark.parametrize("net", NETS)
def test_detect_same_detections(served, net):
    jmodel, params, model = served[net]
    jdet = JaxDetector(jmodel, {"params": params}, max_per_image=MAX_PER_IMAGE)
    det = Detector(model.eval(), max_per_image=MAX_PER_IMAGE, device="cpu")
    (_, data, im_info), = iter_bucket_batches(_images(), det.cfg)
    want_d, want_v = jdet.detect_blobs(data, im_info)
    build.reset_launch_counts()
    got_d, got_v = det.detect_blobs(data, im_info)
    assert sum(build.LAUNCH_COUNTS.values()) == 0       # CPU tensors: the twins
    total = 0
    for i in range(len(data)):
        w = np.asarray(want_d[i])[np.asarray(want_v[i])]
        g = got_d[i].numpy()[got_v[i].numpy()]
        total += len(w)
        for j in range(1, NUM_CLASSES):
            _assert_det_sets_match(w[w[:, 5] == j][:, :5], g[g[:, 5] == j][:, :5],
                                   f"{net} image {i} class {j}")
    assert total > 3


def _trainable_per_jax(jmodel, params, net):
    """Port names of the tensors ``_param_labels`` does not freeze."""
    labels = _param_labels(jmodel, params)
    mask = jax.tree.map(lambda lab, p: np.full(np.shape(p), lab != "frozen", np.float32),
                        labels, params)
    out = set()
    for name, t in convert_from_jax(mask, net).items():
        assert t.all() or not t.any(), name
        if t.all():
            out.add(name)
    return out


def sgd_step(net):
    """One jitted JAX train step and the port's step from the same weights,
    minibatch and draws (VGG's dropout uniforms included), both in f64 (JAX
    under ``enable_x64``): in f32 a relu input within rounding of zero
    passes the gradient on one side only, and moves some of VGG-16's
    conv3_* updates by up to 8e-3 of their max (the rest agree to 1e-5)."""
    # lr 1.0: at the default 1e-3 an update is ~100 ulps of its weight
    overrides = TRAIN_OVERRIDES + ["TRAIN.LEARNING_RATE", "1.0", "MOBILENET.DEPTH_MULTIPLIER",
                                   "0.25"]
    jcfg = jax_cfg_from_list(jax_default_config(), overrides)
    cfg = cfg_from_list(default_config(), overrides)
    params = numpy_params(jax_model(net, jcfg))
    model = port_model(net, cfg, torch.float64)
    model.load_state_dict(convert_from_jax(params, net), strict=True)
    model.double()
    roidb, reader = _roidb(np.random.RandomState(1))
    blobs = get_minibatch(roidb, cfg, np.random.RandomState(0), reader=reader)
    drop = np.random.RandomState(2).uniform(0, 1, (2, B * cfg.TRAIN.BATCH_SIZE, TAIL))
    names = ("data", "im_info", "gt_boxes", "gt_labels", "gt_valid")
    key = jax.random.PRNGKey(5)
    k = (H // 16) * (W // 16) * cfg.num_anchors
    with jax.enable_x64(True):
        jmodel = jax_model(net, jcfg, jnp.float64)
        params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
        tx, _ = jax_make_optimizer(jmodel, params, jcfg)
        labels = _param_labels(jmodel, params)

        def train_step(params, opt_state, data, im_info, gt_boxes, gt_labels, gt_valid, key):
            dkey, skey = jax.random.split(key)

            def loss_fn(p):
                losses, _ = jmodel.apply({"params": stop_frozen_gradients(labels, p)}, data,
                                         im_info, gt_boxes, gt_labels, gt_valid, skey,
                                         method="train_forward", rngs={"dropout": dkey})
                return losses["total_loss"], losses

            with fnn.intercept_methods(_dropout_interceptor(jnp.asarray(drop))):
                (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), losses

        new_params, jlosses = jax.jit(train_step)(params, tx.init(params),
                                                  *[jnp.asarray(blobs[n]) for n in names], key)
        new_params = jax.tree.map(np.asarray, new_params)
        draws = _jax_draws(jax.random.split(key)[1], k, cfg.TRAIN.RPN_POST_NMS_TOP_N
                           + cfg.DEVICE.MAX_GT)
    if net == "vgg16":
        draws["dropout"] = torch.from_numpy(drop)
    before = {n: t.clone() for n, t in model.state_dict().items()}
    solver = SolverWrapper(model, roidb, cfg, reader=reader, device="cpu")
    losses = solver.train_step(blobs, draws)
    return {"net": net, "jmodel": jmodel, "params": params, "new_params": new_params,
            "jlosses": jlosses, "losses": losses, "model": model, "before": before,
            "after": model.state_dict()}


@pytest.fixture(scope="module", params=NETS)
def stepped(request):
    return sgd_step(request.param)


def test_sgd_step_matches_jax(stepped):
    net, model = stepped["net"], stepped["model"]
    for name, want in stepped["jlosses"].items():
        ours, want = float(stepped["losses"][name]), float(want)
        assert abs(ours - want) <= 1e-4 * max(abs(want), 1e-6), (net, name, ours, want)
    assert float(stepped["jlosses"]["rpn_loss_box"]) > 0
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert trainable == _trainable_per_jax(stepped["jmodel"], stepped["params"], net)
    frozen = {n for n, _ in model.named_parameters()} - trainable
    if net == "vgg16":
        assert {n.rsplit(".", 1)[0] for n in frozen} == {f"features.{i}" for i in (0, 2, 5, 7)}
    else:   # FIXED_LAYERS 5: conv0 and sep1-sep4 (bn0 and every BN are buffers)
        assert {n.split(".")[0] for n in frozen} == {"conv0", "sep1", "sep2", "sep3", "sep4"}
    delta = convert_from_jax(jax.tree.map(np.subtract, stepped["new_params"],
                                          stepped["params"]), net)
    assert delta.keys() == stepped["after"].keys()
    moved = 0
    for name, d_jax in delta.items():
        d_jax = d_jax.double().numpy()
        d_port = (stepped["after"][name] - stepped["before"][name]).numpy()
        if name not in trainable:
            assert not d_jax.any() and not d_port.any(), name   # frozen or a buffer: exactly 0
            continue
        scale = np.abs(d_jax).max()
        assert scale > 0, name
        assert np.abs(d_port - d_jax).max() <= 1e-3 * scale, (net, name)
        moved += 1
    assert moved == len(trainable)
