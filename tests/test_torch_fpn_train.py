"""The FPN training step of the port against the JAX ``FasterRCNNFPN``, on
the CPU, f32: res50_fpn, the 128x200 bucket and the seeded weights of
``tests/test_torch_fpn.py``, batch 2 (one image leaves padding), 200 pre-NMS
candidates a level, 64 proposals, 32 sampled rois, an RPN batch of 64.

  * K6b's twin against ``jax.vjp`` of ``roi_align_multilevel`` (its own
    ``custom_vjp``) and of the Pallas level kernels in interpret mode, one
    level empty, a roi count off the roi tile: within 1e-5 of max|dF|;
    the empty level's gradient is dense zeros;
  * ``RoIAlignMultilevelFunction`` passes ``gradcheck`` in f64 and carries
    the twin's gradient through ``extract_multilevel_features``;
  * ``gather_anchor_rows`` equal to the JAX function on ids that cross the
    level boundaries;
  * ``_propose(train=True)`` on the same RPN outputs: rois within 1.3e-4 px,
    valid equal, the order equal (the sampling draws attach to positions);
  * ``train_forward``: roi labels equal, rois within 1e-3, the four losses
    and their total within 1e-4 relative, from the JAX key's draws;
  * two SGD steps against a jitted JAX ``train_step``: per tensor the update
    within 1e-3 of max|JAX update| and non-zero for every trainable tensor,
    frozen tensors and buffers unchanged; the anchors (2 x stride) and the
    roi level rule (canonical size 28) are scaled to the bucket, so that
    every level P2-P5 holds sampled anchors and pools sampled rois; the
    RPN's ``rpn_cls_b`` / ``rpn_box_b`` train in the weight group, as the JAX
    label tree puts them (a leaf is a bias only if it is named ``bias``);
  * ``conv1`` and ``layer1`` stay frozen through the detector's
    re-registration of the ResNet's children.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from frcnn_tpu import cfg_from_list as jax_cfg_from_list
from frcnn_tpu import default_config as jax_default_config
from frcnn_tpu.engine.train import _param_labels, stop_frozen_gradients
from frcnn_tpu.engine.train import make_optimizer as jax_make_optimizer
from frcnn_tpu.models import build_model as jax_build_model
from frcnn_tpu.models.network import gather_anchor_rows as jax_gather_anchor_rows
from frcnn_tpu.ops.roi_align import roi_align_multilevel as jax_roi_align_multilevel
from frcnn_tpu.ops.roi_align import roi_align_multilevel_pallas
from frcnn_tpu_torch import cfg_from_list, default_config
from frcnn_tpu_torch.data.loader import get_minibatch
from frcnn_tpu_torch.engine.train import SolverWrapper, make_optimizer
from frcnn_tpu_torch.models.network import build_model, gather_anchor_rows
from frcnn_tpu_torch.ops.cuda import build
from frcnn_tpu_torch.ops.cuda.roi_align_kernel import (RoIAlignMultilevelFunction,
                                                       roi_align_multilevel_backward,
                                                       roi_align_multilevel_reference)
from frcnn_tpu_torch.ops.roi_align import extract_multilevel_features
from frcnn_tpu_torch.utils.weight_convert import convert_fpn_from_jax
from tests.test_torch_fpn import H, NUM_CLASSES, STRIDES, W, _ml_inputs, _numpy_params
from tests.test_torch_train import _close, _jax_draws, _roidb, _t

B, POST, MAX_GT = 2, 64, 8
OVERRIDES = ["TRAIN.SCALES", f"({H},)", "TRAIN.MAX_SIZE", str(W), "TPU.BUCKETS", f"(({H}, {W}),)",
             "TRAIN.IMS_PER_BATCH", str(B), "FPN.PRE_NMS_PER_LEVEL_TRAIN", "200",
             "TRAIN.RPN_POST_NMS_TOP_N", str(POST), "TRAIN.BATCH_SIZE", "32",
             "TRAIN.RPN_BATCHSIZE", "64", "TPU.MAX_GT", str(MAX_GT),
             # a 128x200 image holds no roi of 224 px (the least that goes to P4)
             # and no anchor of 8 x stride past P3: scale both down, so that P4
             # and P5 train as P2 and P3 do
             "FPN.ANCHOR_SCALE", "2.0", "FPN.ROI_CANONICAL_SCALE", "28.0"]
LEVEL_HW = [(32, 50), (16, 25), (8, 13), (4, 7), (2, 4)]          # P2-P6 of 128x200
K = 3 * sum(h * w for h, w in LEVEL_HW)
FEED = ("data", "im_info", "gt_boxes", "gt_labels", "gt_valid")


def _twin_grads(g, rois, levels, hws):
    build.reset_launch_counts()
    got = roi_align_multilevel_backward(_t(g), _t(rois), _t(levels), hws, STRIDES)
    assert build.LAUNCH_COUNTS["roi_align_ml_bwd"] == 0           # CPU tensors run the twin
    assert [tuple(t.shape[1:3]) for t in got] == list(hws)
    return [t.numpy() for t in got]


def test_multilevel_backward_twin_matches_jax_vjp():
    rng = np.random.RandomState(20)
    hws = LEVEL_HW[:4]
    feats, rois, levels = _ml_inputs(rng, 16, 37, hws)
    g = rng.randn(2, 37, 7, 7, 16).astype(np.float32)
    got = _twin_grads(g, rois, levels, hws)
    assert not got[2].any() and got[0].any()                      # level 2 empty: dense zeros
    for i in range(2):
        _, vjp = jax.vjp(lambda fs: jax_roi_align_multilevel(
            fs, jnp.asarray(rois[i]), jnp.asarray(levels[i]), STRIDES),
            [jnp.asarray(f[i]) for f in feats])
        (want,) = vjp(jnp.asarray(g[i]))
        for li in range(4):
            assert got[li][i].shape == want[li].shape
            if li == 2:
                assert not np.asarray(want[li]).any()
            else:
                _close(got[li][i], want[li], 1e-5)


def test_multilevel_backward_twin_matches_pallas_interpret_vjp():
    """The TPU kernel K6b (one launch per level over level-sorted rois)
    through the Pallas interpreter: one empty level, 19 rois (off the roi
    tile)."""
    rng = np.random.RandomState(21)
    hws = [(32, 48), (16, 24), (8, 12), (4, 6)]
    feats, rois, levels = _ml_inputs(rng, 128, 19, hws)
    g = rng.randn(2, 19, 7, 7, 128).astype(np.float32)
    got = _twin_grads(g[:1], rois[:1], levels[:1], hws)
    _, vjp = jax.vjp(lambda fs: roi_align_multilevel_pallas(
        fs, jnp.asarray(rois[0]), jnp.asarray(levels[0]), STRIDES, interpret=True),
        [jnp.asarray(f[0]) for f in feats])
    (want,) = vjp(jnp.asarray(g[0]))
    for li in range(4):
        if li == 2:
            assert not got[li].any() and not np.asarray(want[li]).any()
        else:
            _close(got[li][0], want[li], 1e-5)


def test_multilevel_function_passes_gradcheck_f64():
    rng = np.random.RandomState(22)
    feats = [torch.from_numpy(rng.randn(1, h, w, 2)).requires_grad_(True)
             for h, w in ((6, 8), (3, 4), (2, 2))]
    rois = torch.tensor([[[2.0, 3.0, 25.0, 20.0], [-6.0, 4.0, 12.0, 30.0], [1.0, 1.0, 9.0, 9.0]]])
    levels = torch.tensor([[0, 1, 0]], dtype=torch.int32)         # level 2 empty
    assert torch.autograd.gradcheck(
        lambda *fs: RoIAlignMultilevelFunction.apply(rois, levels, [4, 8, 16], 3, 2, *fs),
        tuple(feats))


@pytest.mark.parametrize("empty_level", [True, False])
def test_multilevel_pool_carries_the_twins_gradient(empty_level):
    """Level maps that require grad get dense gradients through
    ``extract_multilevel_features``: the Function's (K6b's twin here),
    autograd of the forward twin ``roi_align_multilevel_reference`` and the
    backward twin agree, with one level empty (its gradient dense zeros) and
    with every level populated; a level out of range adds nothing."""
    rng = np.random.RandomState(23)
    hws = LEVEL_HW[:4]
    feats, rois, levels = _ml_inputs(rng, 8, 21, hws)
    if not empty_level:
        levels[:, 2:6] = 2
    levels[0, :2] = [-1, 4]
    g = rng.randn(2, 21, 7, 7, 8).astype(np.float32)
    want = _twin_grads(g, rois, levels, hws)
    maps = [_t(f).requires_grad_(True) for f in feats]
    out = extract_multilevel_features(maps, _t(rois), _t(levels), STRIDES)
    assert out.grad_fn is not None and not out[0, :2].any()
    out.backward(_t(g))
    plain = [_t(f).requires_grad_(True) for f in feats]
    ref = roi_align_multilevel_reference(plain, _t(rois), _t(levels), STRIDES)
    assert torch.equal(out, ref)
    ref.backward(_t(g))
    for m, p, w in zip(maps, plain, want):
        assert m.grad.shape == m.shape
        tol = 1e-5 * max(np.abs(w).max(), 1)
        np.testing.assert_allclose(m.grad.numpy(), w, rtol=0, atol=tol)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=tol)
    assert maps[2].grad.any() != empty_level


@pytest.mark.parametrize("d", [2, 4])
def test_gather_anchor_rows_equals_jax(d):
    rng = np.random.RandomState(24)
    a_n = 3
    cells = rng.randn(B, K // a_n, d * a_n).astype(np.float32)
    sel = rng.randint(0, K, (B, 96))
    bounds = np.cumsum([a_n * h * w for h, w in LEVEL_HW])        # the level boundaries
    sel[0, :10] = np.concatenate([bounds - 1, bounds])[:10] % K
    sel[1, :3] = [0, K - 1, 1]
    want = np.asarray(jax_gather_anchor_rows(jnp.asarray(cells), jnp.asarray(sel), a_n, d))
    got = gather_anchor_rows(_t(cells), _t(sel), a_n)
    assert got.dtype == torch.float32 and got.shape == (B, 96, d)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), cells.reshape(B, K, d)[np.arange(B)[:, None], sel])   # the dense rows


def _jax_train_parts(mdl, images, im_info):
    pyr = mdl._pyramid(images)
    _, prob, _, cells, _ = mdl._rpn_all_levels(pyr)
    anchors = mdl._anchors(pyr)
    return prob, cells, mdl._propose(pyr, prob, cells, anchors, im_info, train=True)


def _jax_train_step(jmodel, tx, labels):
    """The body of the JAX SolverWrapper.construct_graph's train_step, jitted."""

    def train_step(params, opt_state, data, im_info, gt_boxes, gt_labels, gt_valid, key):
        dkey, skey = jax.random.split(key)

        def loss_fn(p):
            losses, aux = jmodel.apply({"params": stop_frozen_gradients(labels, p)}, data,
                                       im_info, gt_boxes, gt_labels, gt_valid, skey,
                                       method="train_forward", rngs={"dropout": dkey})
            return losses["total_loss"], (losses, aux)

        (_, (losses, aux)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, losses, aux

    return jax.jit(train_step)


@pytest.fixture(scope="module")
def stepped():
    """Two jitted JAX train steps and the port's two steps from the same
    weights, minibatch and draws; and the JAX train proposals."""
    # lr 1.0: see tests/test_torch_train.py
    overrides = OVERRIDES + ["TRAIN.LEARNING_RATE", "1.0"]
    jcfg = jax_cfg_from_list(jax_default_config(), overrides)
    cfg = cfg_from_list(default_config(), overrides)
    roidb, reader = _roidb(np.random.RandomState(1), shapes=((H, W), (H, W - 40)))
    blobs = get_minibatch(roidb, cfg, np.random.RandomState(0), reader=reader)
    assert blobs["data"].shape == (B, H, W, 3) and blobs["im_info"][1, 1] < W

    jmodel = jax_build_model("res50_fpn", NUM_CLASSES, jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((B, H, W, 3)),
                            jnp.zeros((B, 3)))
    params = _numpy_params(shapes["params"])
    tx, _ = jax_make_optimizer(jmodel, params, jcfg)
    labels = _param_labels(jmodel, params)

    step = _jax_train_step(jmodel, tx, labels)
    feed = [jnp.asarray(blobs[k]) for k in FEED]
    keys = (jax.random.PRNGKey(5), jax.random.PRNGKey(6))
    new_params, opt_state, jlosses, jaux = step(params, tx.init(params), *feed, keys[0])
    params2, _, jlosses2, _ = step(new_params, opt_state, *feed, keys[1])
    parts = jax.jit(lambda v, x, i: jmodel.apply(v, x, i, method=_jax_train_parts))(
        {"params": params}, feed[0], feed[1])

    model = build_model("res50_fpn", NUM_CLASSES, cfg)
    model.load_state_dict(convert_fpn_from_jax(params, "res50_fpn"), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    draws = [_jax_draws(jax.random.split(key)[1], K, POST + MAX_GT) for key in keys]
    with torch.no_grad():
        losses, aux = model.train_forward(*[_t(blobs[k]) for k in FEED], draws[0])
    solver = SolverWrapper(model, roidb, cfg, reader=reader, device="cpu")
    step_losses = solver.train_step(blobs, draws[0])
    after = {k: v.clone() for k, v in model.state_dict().items()}
    step2_losses = solver.train_step(blobs, draws[1])
    return {"jax": (params, new_params, jlosses, jaux), "jax2": (params2, jlosses2),
            "parts": jax.tree.map(np.asarray, parts), "labels": labels, "blobs": blobs,
            "before": before, "after": after, "after2": model.state_dict(), "model": model,
            "solver": solver, "losses": losses, "aux": aux, "step_losses": step_losses,
            "step2_losses": step2_losses}


def test_propose_train_matches_jax(stepped):
    """The same RPN outputs (the JAX ones) into both ``_propose``s with the
    TRAIN settings: 708 candidates, NMS at TRAIN.RPN_NMS_THRESH to 64."""
    prob, cells, (w_rois, w_scores, w_valid) = stepped["parts"]
    model = stepped["model"]
    pyr = [torch.zeros(B, 1, h, w) for h, w in LEVEL_HW]
    with torch.no_grad():
        rois, scores, valid = model._propose(
            pyr, torch.tensor(prob), [torch.tensor(c) for c in cells], model._anchors(pyr),
            _t(stepped["blobs"]["im_info"]), train=True)
    assert rois.shape == (B, POST, 4)
    np.testing.assert_array_equal(valid.numpy(), w_valid)
    assert w_valid.sum(1).min() > 10
    np.testing.assert_allclose(rois.numpy(), w_rois, rtol=0, atol=1.3e-4)    # the order too
    np.testing.assert_allclose(scores.numpy(), w_scores, rtol=0, atol=1e-5)


def test_train_forward_losses_match_jax(stepped):
    _, _, jlosses, jaux = stepped["jax"]
    aux = stepped["aux"]
    assert int(jaux["n_fg"]) > 0 and float(jlosses["rpn_loss_box"]) > 0
    levels = stepped["model"]._assign_levels(aux["rois"])[aux["roi_labels"] >= 0]
    assert set(levels.unique().tolist()) == {2, 3, 4, 5}          # sampled rois on P2-P5
    assert int(aux["n_fg"]) == int(jaux["n_fg"])
    np.testing.assert_array_equal(aux["roi_labels"].numpy(), np.asarray(jaux["roi_labels"]))
    np.testing.assert_allclose(aux["rois"].numpy(), np.asarray(jaux["rois"]), atol=1e-3, rtol=0)
    assert set(jlosses) == {"rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box",
                            "total_loss"}
    for name, want in jlosses.items():
        ours, want = float(stepped["losses"][name]), float(want)
        assert abs(ours - want) <= 1e-4 * max(abs(want), 1e-6), (name, ours, want)
        assert float(stepped["step_losses"][name]) == ours


def _assert_updates_match(model, jax_old, jax_new, port_old, port_new):
    """Per tensor: the port's update within 1e-3 of max|JAX update|; frozen
    tensors and buffers exactly unchanged on both sides."""
    old = convert_fpn_from_jax(jax.tree.map(np.asarray, jax_old), "res50_fpn")
    new = convert_fpn_from_jax(jax.tree.map(np.asarray, jax_new), "res50_fpn")
    params = dict(model.named_parameters())
    frozen = {n for n, p in params.items() if not p.requires_grad}
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
    return moved


def test_sgd_step_matches_jax(stepped):
    params, new_params, _, _ = stepped["jax"]
    moved = _assert_updates_match(stepped["model"], params, new_params, stepped["before"],
                                  stepped["after"])
    assert moved > 60          # layer2-4, the neck, the RPN, the box head, the last layers


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


def test_fpn_frozen_tensors_and_optimizer_groups(stepped):
    """``conv1`` and ``layer1`` stay frozen through the detector's
    re-registration of the ResNet's children; the trainable set is the JAX
    label tree's; ``rpn_cls_b`` / ``rpn_box_b`` are not named ``bias``, so
    both sides train them as weights (decay, 1x lr)."""
    model, labels = stepped["model"], stepped["labels"]
    params = dict(model.named_parameters())
    frozen = {n for n, p in params.items() if not p.requires_grad}
    assert frozen == {n for n in params if n.startswith(("conv1.", "layer1."))}
    assert all(p is dict(model.backbone.named_parameters())[n]
               for n, p in params.items() if n.startswith(("conv1.", "layer")))
    assert labels["rpn_cls_b"] == labels["rpn_box_b"] == "weight"
    assert labels["rpn_net"]["bias"] == labels["neck"]["lateral2"]["bias"] == "bias"
    assert labels["stages"]["conv1"]["kernel"] == "frozen"
    assert labels["stages"]["layer1_block0"]["conv1"]["kernel"] == "frozen"
    assert labels["stages"]["layer2_block0"]["conv1"]["kernel"] == "weight"

    optimizer, _ = make_optimizer(model, model.config)
    names = {id(p): n for n, p in params.items()}
    weights, biases = ([names[id(p)] for p in g["params"]] for g in optimizer.param_groups)
    assert {"rpn_cls_b", "rpn_box_b", "rpn_cls_w", "rpn_box_w"} <= set(weights)
    assert all(n.endswith(".bias") for n in biases)
    assert {"rpn_net.bias", "neck.lateral2.bias", "box_head.fc1.bias",
            "cls_score.bias"} <= set(biases)
    assert set(weights) | set(biases) == set(params) - frozen
    groups = stepped["solver"].optimizer.param_groups
    assert [len(g["params"]) for g in groups] == [len(weights), len(biases)]


RPN_HEAD = ("rpn_cls_w", "rpn_cls_b", "rpn_box_w", "rpn_box_b")


def test_bf16_sgd_step_keeps_the_rpn_head_in_the_compute_dtype():
    """The reference creates ``rpn_cls_w/b`` and ``rpn_box_w/b`` in the
    compute dtype, so under bf16 they, their momentum and their updates are
    bf16.  One bf16 SGD step from the same JAX parameters (carried over by
    ``convert_fpn_from_jax``) on each side: the four tensors are bf16 on both
    and agree within one bf16 ulp of max|reference|."""
    overrides = OVERRIDES + ["TRAIN.LEARNING_RATE", "0.01"]
    jcfg = jax_cfg_from_list(jax_default_config(), overrides)
    cfg = cfg_from_list(default_config(), overrides)
    roidb, reader = _roidb(np.random.RandomState(1), shapes=((H, W), (H, W - 40)))
    blobs = get_minibatch(roidb, cfg, np.random.RandomState(0), reader=reader)
    jmodel = jax_build_model("res50_fpn", NUM_CLASSES, jcfg, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((B, H, W, 3)),
                            jnp.zeros((B, 3)))["params"]
    params = jax.tree.map(lambda a, s: np.asarray(jnp.asarray(a, s.dtype)),
                          _numpy_params(shapes), shapes)
    assert all(params[n].dtype == jnp.bfloat16 for n in RPN_HEAD)
    tx, _ = jax_make_optimizer(jmodel, params, jcfg)
    step = _jax_train_step(jmodel, tx, _param_labels(jmodel, params))
    key = jax.random.PRNGKey(5)
    new_params = step(params, tx.init(params), *[jnp.asarray(blobs[k]) for k in FEED], key)[0]

    model = build_model("res50_fpn", NUM_CLASSES, cfg, dtype=torch.bfloat16)
    model.load_state_dict(convert_fpn_from_jax(params, "res50_fpn"), strict=True)
    solver = SolverWrapper(model, roidb, cfg, reader=reader, device="cpu")
    solver.train_step(blobs, _jax_draws(jax.random.split(key)[1], K, POST + MAX_GT))
    moved = 0
    for name in RPN_HEAD:
        got, old = getattr(model, name).detach(), params[name]
        want = np.asarray(new_params[name])
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, name
        want, got = want.astype(np.float32), got.float().numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= ulp, name
        moved += int((want != old.astype(np.float32)).any())
    assert moved == len(RPN_HEAD)                     # the step moved every tensor
