"""The port's training step against the JAX package, on the CPU, f32.

  * K2b's twin against ``jax.vjp`` of the Pallas RoIAlign (interpret mode)
    and of the plain ``roi_align``, within 1e-5 of max|dF|; the same
    gradient through ``extract_roi_features``;
  * ``FusedBottleneckFunction``'s gradients against ``jax.vjp`` of
    ``bottleneck_reference``; both autograd Functions pass ``gradcheck`` in
    f64 through their twins;
  * ``train_forward`` (res50 C4, 128x192 bucket, batch 2, weights from
    ``_detector_state_dict`` converted by ``convert_detector``, sampling
    draws from the JAX package's key splits): the four losses within 1e-4
    relative, the proposals equal in order;
  * two SGD steps against a jitted JAX ``train_step``: per tensor and per
    step, the update within 1e-3 of max|update|, frozen tensors exactly
    unchanged on both sides; the second step carries momentum, so it checks
    the order of weight decay, momentum and the learning rate, and the
    biases' 2x lr under momentum;
  * the learning-rate schedule, the optimizer's groups, the global-norm
    clip, the minibatch, the data layer's order, and the training roidb
    (flips, metadata, filtering).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from frcnn_tpu import cfg_from_list as jax_cfg_from_list
from frcnn_tpu import default_config as jax_default_config
from frcnn_tpu.data.imdb import imdb as jax_imdb
from frcnn_tpu.data.loader import RoIDataLayer as JaxRoIDataLayer
from frcnn_tpu.data.loader import get_minibatch as jax_get_minibatch
from frcnn_tpu.data.loader import im_list_to_blob as jax_im_list_to_blob
from frcnn_tpu.engine.train import _param_labels, stop_frozen_gradients
from frcnn_tpu.engine.train import filter_roidb as jax_filter_roidb
from frcnn_tpu.engine.train import get_training_roidb as jax_get_training_roidb
from frcnn_tpu.engine.train import make_lr_schedule as jax_make_lr_schedule
from frcnn_tpu.engine.train import make_optimizer as jax_make_optimizer
from frcnn_tpu.models import build_model as jax_build_model
from frcnn_tpu.ops.pallas.fused_block import bottleneck_reference as jax_bottleneck_reference
from frcnn_tpu.ops.pallas.roi_align_kernel import roi_align_pallas
from frcnn_tpu.ops.roi_align import roi_align as jax_roi_align
from frcnn_tpu.utils.weight_convert import convert_detector
from frcnn_tpu_torch import cfg_from_list, default_config
from frcnn_tpu_torch.data.loader import RoIDataLayer, get_minibatch, im_list_to_blob
from frcnn_tpu_torch.engine.train import (SolverWrapper, clip_by_global_norm_, filter_roidb,
                                          get_training_roidb, make_lr_schedule, make_optimizer)
from frcnn_tpu_torch.models.network import build_model
from frcnn_tpu_torch.ops.cuda import build
from frcnn_tpu_torch.ops.cuda.fused_block import FusedBottleneckFunction
from frcnn_tpu_torch.ops.cuda.roi_align_kernel import RoIAlignFunction, roi_align_backward
from frcnn_tpu_torch.ops.roi_align import extract_roi_features
from frcnn_tpu_torch.utils.weight_convert import convert_from_jax
from tests.conftest import random_boxes
from tests.test_pipeline_parity import NUM_CLASSES, _assert_det_sets_match, _detector_state_dict

H, W, B = 128, 192, 2
# anchors of 32-128 px (ANCHOR_SCALES 2, 4, 8) so that some lie inside a
# 128x192 image and the RPN loss terms are live
OVERRIDES = ["TRAIN.SCALES", f"({H},)", "TRAIN.MAX_SIZE", str(W), "TPU.BUCKETS", f"(({H}, {W}),)",
             "TRAIN.IMS_PER_BATCH", str(B), "TRAIN.RPN_PRE_NMS_TOP_N", "400",
             "TRAIN.RPN_POST_NMS_TOP_N", "64", "TRAIN.BATCH_SIZE", "32",
             "TRAIN.RPN_BATCHSIZE", "64", "TPU.MAX_GT", "8", "ANCHOR_SCALES", "(2, 4, 8)"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    """max |got - want| <= tol * max |want|."""
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-12)
    assert np.abs(np.asarray(got) - want).max() <= tol * scale


def _roidb(rng, shapes=((H, W), (H, W - 40))):
    """Synthetic entries with 3-6 gt boxes painted on noise, and a reader."""
    roidb, images = [], {}
    for i, (h, w) in enumerate(shapes):
        im = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
        n = rng.randint(3, 7)
        boxes = random_boxes(rng, n, w, h, min_size=24)
        for x1, y1, x2, y2 in boxes.astype(int):
            im[y1:y2, x1:x2] = rng.randint(0, 255, 3)
        roidb.append({"image": f"im{i}", "boxes": boxes, "flipped": False,
                      "gt_classes": rng.randint(1, NUM_CLASSES, n).astype(np.int32),
                      "height": h, "width": w, "max_overlaps": np.ones(n)})
        images[f"im{i}"] = im
    return roidb, images.__getitem__


def test_roi_align_backward_twin_matches_jax_vjp(rng):
    h, w, c, r = 8, 16, 8, 16
    feat = rng.randn(B, h, w, c).astype(np.float32)
    rois = np.stack([random_boxes(rng, r, width=w * 16 - 1, height=h * 16 - 1, min_size=16)
                     for _ in range(B)])
    rois[1, :3] = rng.uniform(-200, 400, (3, 4))          # partly outside, inverted
    g = rng.randn(B, r, 7, 7, c).astype(np.float32)
    build.reset_launch_counts()
    got = roi_align_backward(_t(g), _t(rois), (h, w)).numpy()
    assert build.LAUNCH_COUNTS["roi_align_bwd"] == 0  # CPU tensors run the twin
    for i in range(B):
        f, ro = jnp.asarray(feat[i]), jnp.asarray(rois[i])
        _, vjp_pallas = jax.vjp(lambda x: roi_align_pallas(x, ro, 7, 1.0 / 16, 2, True), f)
        _, vjp_plain = jax.vjp(lambda x: jax_roi_align(x, ro), f)
        _close(got[i], vjp_pallas(jnp.asarray(g[i]))[0], 1e-5)
        _close(got[i], vjp_plain(jnp.asarray(g[i]))[0], 1e-5)
    feat_t = _t(feat).requires_grad_(True)
    out = extract_roi_features(feat_t, _t(rois))
    assert out.grad_fn is not None
    out.backward(_t(g))
    np.testing.assert_allclose(feat_t.grad.numpy(), got, rtol=0, atol=0)


def _block_args(rng, cin, mid, cout, proj, dtype=np.float32):
    def t(*s):
        return (rng.randn(*s) * 0.3).astype(dtype)

    args = [t(2, 6, 5, cin), t(cin, mid), t(mid), t(9 * mid, mid), t(mid), t(mid, cout), t(cout)]
    return args + ([t(cin, cout), t(cout)] if proj else [None, None])


@pytest.mark.parametrize("cin,proj", [(16, False), (12, True)])
def test_fused_function_grads_match_jax_vjp(rng, cin, proj):
    mid, cout = 8, 16
    args = _block_args(rng, cin, mid, cout, proj)
    g = rng.randn(2, 6, 5, cout).astype(np.float32)
    jargs = [jnp.asarray(a) for a in args if a is not None]
    jargs[3] = jargs[3].reshape(3, 3, mid, mid)            # HWIO for the reference
    _, vjp = jax.vjp(jax_bottleneck_reference, *jargs)
    want = vjp(jnp.asarray(g))
    targs = [None if a is None else _t(a).requires_grad_(True) for a in args]
    out = FusedBottleneckFunction.apply(*targs)
    assert out.grad_fn is not None
    out.backward(_t(g))
    got = [a.grad.numpy() for a in targs if a is not None]
    got[3] = got[3].reshape(3, 3, mid, mid)
    assert len(got) == len(want)
    for ours, theirs in zip(got, want):
        _close(ours, theirs, 1e-5)


def test_functions_pass_gradcheck_f64(rng):
    feat = torch.from_numpy(rng.randn(1, 4, 5, 3)).requires_grad_(True)
    rois = torch.tensor([[[4.0, 8.0, 60.0, 50.0], [-20.0, 10.0, 30.0, 90.0]]])
    assert torch.autograd.gradcheck(lambda f: RoIAlignFunction.apply(f, rois, 7, 1.0 / 16, 2),
                                    (feat,))
    for cin, proj in ((8, False), (6, True)):
        args = [None if a is None else _t(a).requires_grad_(True)
                for a in _block_args(rng, cin, 4, 8, proj, np.float64)]
        args[0] = args[0][:1, :3, :4].detach().requires_grad_(True)
        assert torch.autograd.gradcheck(FusedBottleneckFunction.apply, tuple(args))


def _jax_draws(skey, k, n):
    """The port's sampling draws from the key ``train_forward`` gets: the
    JAX package splits it into 2B image keys, each into (fg, bg) keys."""
    keys = jax.random.split(skey, 2 * B)
    out = {}
    for name, first, size in (("anchor", 0, k), ("roi", B, n)):
        pairs = [jax.random.split(keys[first + i]) for i in range(B)]
        for j, part in enumerate(("fg", "bg")):
            out[f"{name}_{part}"] = _t(np.stack([np.asarray(jax.random.uniform(p[j], (size,)))
                                                 for p in pairs]))
    return out


@pytest.fixture(scope="module")
def stepped():
    """Two jitted JAX train steps and the port's two steps from the same
    weights, minibatch and draws."""
    sd = _detector_state_dict(np.random.RandomState(0))
    # lr 1.0: at the default 1e-3 an update is ~100 ulps of its weight, and
    # the f32 rounding of p + delta alone would exceed 1e-3 of max|delta|
    overrides = OVERRIDES + ["TRAIN.LEARNING_RATE", "1.0"]
    jcfg = jax_cfg_from_list(jax_default_config(), overrides)
    cfg = cfg_from_list(default_config(), overrides)
    roidb, reader = _roidb(np.random.RandomState(1))
    blobs = get_minibatch(roidb, cfg, np.random.RandomState(0), reader=reader)

    jmodel = jax_build_model("res50", NUM_CLASSES, jcfg)
    params = convert_detector({k: v.numpy() for k, v in sd.items()}, "res50")
    tx, _ = jax_make_optimizer(jmodel, params, jcfg)
    labels = _param_labels(jmodel, params)

    def train_step(params, opt_state, data, im_info, gt_boxes, gt_labels, gt_valid, key):
        # the body of SolverWrapper.construct_graph's train_step
        dkey, skey = jax.random.split(key)

        def loss_fn(p):
            losses, aux = jmodel.apply({"params": stop_frozen_gradients(labels, p)}, data,
                                       im_info, gt_boxes, gt_labels, gt_valid, skey,
                                       method="train_forward", rngs={"dropout": dkey})
            return losses["total_loss"], (losses, aux)

        (_, (losses, aux)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, losses, aux

    step = jax.jit(train_step)
    feed = [jnp.asarray(blobs[k]) for k in ("data", "im_info", "gt_boxes", "gt_labels", "gt_valid")]
    keys = (jax.random.PRNGKey(5), jax.random.PRNGKey(6))
    new_params, opt_state, jlosses, jaux = step(params, tx.init(params), *feed, keys[0])
    params2, _, jlosses2, _ = step(new_params, opt_state, *feed, keys[1])

    model = build_model("res50", NUM_CLASSES, cfg)
    model.load_state_dict(sd)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    k = (H // 16) * (W // 16) * cfg.num_anchors
    draws = [_jax_draws(jax.random.split(key)[1], k, 64 + cfg.DEVICE.MAX_GT) for key in keys]
    feed = [_t(blobs[k]) for k in ("data", "im_info", "gt_boxes", "gt_labels", "gt_valid")]
    with torch.no_grad():
        losses, aux = model.train_forward(*feed, draws[0])
    solver = SolverWrapper(model, roidb, cfg, reader=reader, device="cpu")
    step_losses = solver.train_step(blobs, draws[0])
    after = {k: v.clone() for k, v in model.state_dict().items()}
    step2_losses = solver.train_step(blobs, draws[1])
    return {"jax": (params, new_params, jlosses, jaux), "jax2": (params2, jlosses2),
            "before": before, "after": after, "after2": model.state_dict(), "model": model,
            "losses": losses, "aux": aux, "step_losses": step_losses,
            "step2_losses": step2_losses}


def test_train_forward_losses_match_jax(stepped):
    _, _, jlosses, jaux = stepped["jax"]
    aux = stepped["aux"]
    assert int(jaux["n_fg"]) > 0 and float(jlosses["rpn_loss_box"]) > 0
    for i in range(B):
        valid = aux["proposal_valid"][i].numpy()
        np.testing.assert_array_equal(valid, np.asarray(jaux["proposal_valid"][i]))
        rows = np.concatenate([aux["proposals"][i].numpy(),
                               aux["proposal_scores"][i].numpy()[:, None]], 1)[valid]
        jrows = np.concatenate([np.asarray(jaux["proposals"][i]),
                                np.asarray(jaux["proposal_scores"][i])[:, None]], 1)[valid]
        _assert_det_sets_match(jrows, rows, f"image {i} proposals", score_atol=1e-5,
                               box_atol=1e-3)
        # the sampling draws attach to proposal positions: the order must agree
        np.testing.assert_allclose(rows, jrows, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(aux["roi_labels"].numpy(), np.asarray(jaux["roi_labels"]))
    np.testing.assert_allclose(aux["rois"].numpy(), np.asarray(jaux["rois"]), atol=1e-3, rtol=0)
    for name, want in jlosses.items():
        ours, want = float(stepped["losses"][name]), float(want)
        assert abs(ours - want) <= 1e-4 * max(abs(want), 1e-6), (name, ours, want)
        assert float(stepped["step_losses"][name]) == ours


def _assert_updates_match(model, jax_old, jax_new, port_old, port_new):
    """Per tensor: the port's update within 1e-3 of max|JAX update|; frozen
    tensors and buffers exactly unchanged on both sides."""
    old = convert_from_jax(jax.tree.map(np.asarray, jax_old), "res50")
    new = convert_from_jax(jax.tree.map(np.asarray, jax_new), "res50")
    params = dict(model.named_parameters())
    frozen = {n for n, p in params.items() if not p.requires_grad}
    assert {"conv1.weight", "layer1.0.conv1.weight"} <= frozen
    assert len(new) == len(port_new)
    moved = 0
    for name, want_new in new.items():
        d_jax = (want_new - old[name]).numpy()
        d_port = (port_new[name] - port_old[name]).numpy()
        if name in frozen or name not in params:
            assert not d_jax.any() and not d_port.any(), name   # frozen: exactly 0
            continue
        scale = np.abs(d_jax).max()
        assert scale > 0, name
        assert np.abs(d_port - d_jax).max() <= 1e-3 * scale, name
        moved += 1
    assert moved == len(params) - len(frozen)


def test_sgd_step_matches_jax(stepped):
    params, new_params, _, _ = stepped["jax"]
    _assert_updates_match(stepped["model"], params, new_params, stepped["before"],
                          stepped["after"])


def test_second_sgd_step_matches_jax(stepped):
    """The second step: momentum holds the first step's update, so weight
    decay, momentum, the lr and the biases' lr_scale all enter."""
    _, new_params, _, _ = stepped["jax"]
    params2, jlosses2 = stepped["jax2"]
    for name, want in jlosses2.items():
        ours, want = float(stepped["step2_losses"][name]), float(want)
        assert abs(ours - want) <= 1e-4 * max(abs(want), 1e-6), (name, ours, want)
    _assert_updates_match(stepped["model"], new_params, params2, stepped["after"],
                          stepped["after2"])


def test_lr_schedule_and_optimizer_groups():
    extra = ["TRAIN.STEPSIZE", "(3, 6)", "TRAIN.WARMUP_ITERS", "4"]
    cfg = cfg_from_list(default_config(), OVERRIDES + extra + ["RESNET.FIXED_BLOCKS", "2"])
    want = jax_make_lr_schedule(jax_cfg_from_list(jax_default_config(), OVERRIDES + extra))
    ours = make_lr_schedule(cfg)
    for step in range(9):
        np.testing.assert_allclose(ours(step), float(want(jnp.asarray(step))), rtol=1e-6)
    model = build_model("res50", NUM_CLASSES, cfg)
    optimizer, _ = make_optimizer(model, cfg)
    names = {id(p): n for n, p in model.named_parameters()}
    weights, biases = ([names[id(p)] for p in g["params"]] for g in optimizer.param_groups)
    assert all(n.endswith("bias") for n in biases) and not any(n.endswith("bias") for n in weights)
    assert optimizer.param_groups[1]["lr_scale"] == 2.0
    assert optimizer.param_groups[1]["weight_decay"] == 0.0
    trained = set(weights) | set(biases)
    assert not any(n.startswith(("conv1", "layer1.", "layer2.")) for n in trained)
    assert "layer3.0.conv1.weight" in trained and "rpn_net.bias" in trained

    rng = np.random.RandomState(4)
    grads = [rng.randn(5, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    for max_norm in (1.0, 100.0):                  # clipped, and left alone
        params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
        for p, g in zip(params, grads):
            p.grad = _t(g)
        clip_by_global_norm_(params, max_norm)
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6)


def test_minibatch_and_data_layer_match_jax():
    import cv2  # noqa: F401  (the JAX loader resizes with cv2)

    extra = ["TPU.BUCKETS", f"(({H}, {W}), ({W}, {H}))"]
    cfg = cfg_from_list(default_config(), OVERRIDES + extra)
    jcfg = jax_cfg_from_list(jax_default_config(), OVERRIDES + extra)
    roidb, reader = _roidb(np.random.RandomState(2),
                           shapes=((H, W), (W, H), (100, 150), (H, W), (150, 100), (90, 192)))
    roidb[3]["flipped"] = True
    layer, jlayer = (RoIDataLayer(roidb, cfg, reader=reader),
                     JaxRoIDataLayer(roidb, jcfg, reader=reader))
    for _ in range(5):
        ours, theirs = layer.forward(), jlayer.forward()
        for key in ("im_info", "gt_boxes", "gt_labels", "gt_valid"):
            np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
        assert ours["data"].shape == theirs["data"].shape
        assert np.abs(ours["data"] - theirs["data"]).max() <= 0.02
    blobs = get_minibatch(roidb[:2], cfg, np.random.RandomState(0), reader=reader)
    jblobs = jax_get_minibatch(roidb[:2], jcfg, np.random.RandomState(0), reader=reader)
    assert blobs["data"].shape == jblobs["data"].shape == (2, W, W, 3)  # union bucket
    np.testing.assert_array_equal(blobs["gt_boxes"], jblobs["gt_boxes"])
    ims = [reader(e["image"]) for e in roidb[:3]]
    np.testing.assert_array_equal(im_list_to_blob(ims), jax_im_list_to_blob(ims))


class _Imdb(jax_imdb):
    """The JAX package's imdb base over in-memory entries and image files."""

    def __init__(self, roidb, paths):
        super().__init__("synthetic")
        self._image_index = list(range(len(paths)))
        self._paths = paths
        self._roidb = [dict(e) for e in roidb]

    def image_path_at(self, i):
        return self._paths[self._image_index[i]]


def test_training_roidb_matches_jax(tmp_path):
    import cv2

    roidb, reader = _roidb(np.random.RandomState(3), shapes=((H, W), (W, H), (100, 150)))
    paths = []
    for e in roidb:
        paths.append(str(tmp_path / f"{e['image']}.png"))
        cv2.imwrite(paths[-1], reader(e["image"]))
        e.pop("height"), e.pop("width"), e.pop("max_overlaps")
        if e is roidb[2]:                            # no box: filtered out
            e["boxes"], e["gt_classes"] = e["boxes"][:0], e["gt_classes"][:0]
        n = len(e["boxes"])
        e["gt_overlaps"] = np.eye(n, NUM_CLASSES, 1, dtype=np.float32)[np.arange(n) % 4]
    cfg = cfg_from_list(default_config(), OVERRIDES)
    jcfg = jax_cfg_from_list(jax_default_config(), OVERRIDES)
    ours = get_training_roidb(_Imdb(roidb, paths), cfg,
                              image_size=lambda p: cv2.imread(p).shape[:2])
    theirs = jax_get_training_roidb(_Imdb(roidb, paths), jcfg)
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    kept = filter_roidb(ours, cfg)
    assert [e["image"] for e in kept] == [e["image"] for e in jax_filter_roidb(theirs, jcfg)]
    assert len(kept) == 4
