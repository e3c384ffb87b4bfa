"""The GroupNorm FPN (``res50_fpn_gn``) of the port against the JAX
``FasterRCNNFPN`` with ``norm="group"``, on the CPU, f32: one set of seeded
numpy weights in the JAX tree's shapes (GroupNorm scales drawn in [0.5, 1]
and biases ~N(0, 0.05), so that the affine is exercised), carried to the port
by ``convert_fpn_from_jax``; the 128x200 bucket, images and settings of
``tests/test_torch_fpn.py`` and ``tests/test_torch_fpn_train.py``, with
RESNET.FIXED_BLOCKS 0, a GRAD_CLIP that the first step's gradient exceeds,
and a warmup.

  * the converted state_dict loads with ``strict=True`` (GroupNorm has
    weight and bias, no running statistics), also for res101 and res152;
  * the pyramid P2-P6 within 1e-4 of max|level|; ``predict`` rois the same
    set; ``detect`` matched per class;
  * ``train_forward``'s four losses within 1e-4 relative; two SGD steps
    against a jitted JAX ``train_step``, both in f64 (see
    ``test_sgd_steps_match_jax``): the losses within 1e-4 relative, per
    tensor the update within 1e-3 of max|JAX update| and non-zero for every
    tensor, ``conv1`` and every GroupNorm scale and bias included;
  * the trainable set equals the JAX ``frozen_param`` labels, tensor by
    tensor, at FIXED_BLOCKS 0, 1 and 2, and the optimizer's groups equal
    ``_param_labels`` (a GroupNorm scale is a weight, its bias a bias);
  * ``init_reference_`` against a JAX ``model.init``: per tensor, mean and
    std within 10% of the JAX tensor's std, constants equal;
  * ``train_net`` starts a GroupNorm net from ``init_reference_`` seeded with
    RNG_SEED; the K3 gate refuses a GroupNorm block.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from frcnn_tpu import cfg_from_list as jax_cfg_from_list
from frcnn_tpu import default_config as jax_default_config
from frcnn_tpu.engine.train import _param_labels
from frcnn_tpu.engine.train import make_optimizer as jax_make_optimizer
from frcnn_tpu.models import build_model as jax_build_model
from frcnn_tpu_torch import cfg_from_list, default_config
from frcnn_tpu_torch.data.loader import get_minibatch
from frcnn_tpu_torch.engine.serve import Detector, iter_bucket_batches
from frcnn_tpu_torch.engine.train import SolverWrapper, make_optimizer, train_net
from frcnn_tpu_torch.models.backbones import Bottleneck, GroupNorm
from frcnn_tpu_torch.models.fpn import init_reference_
from frcnn_tpu_torch.models.network import build_model
from frcnn_tpu_torch.utils.weight_convert import convert_fpn_from_jax
from tests.test_pipeline_parity import _assert_det_sets_match
from tests.test_torch_fpn import H, NUM_CLASSES, W, _images, _match_per_class, _numpy_params
from tests.test_torch_fpn import OVERRIDES as SERVE_OVERRIDES
from tests.test_torch_fpn_train import B, FEED, K, MAX_GT, POST, _jax_train_step
from tests.test_torch_fpn_train import OVERRIDES as TRAIN_OVERRIDES
from tests.test_torch_train import _jax_draws, _roidb, _t

NET = "res50_fpn_gn"
GRAD_CLIP = 2.0
# lr 1.0: see tests/test_torch_train.py; the warmup starts it at 0.1
OVERRIDES = SERVE_OVERRIDES + TRAIN_OVERRIDES + [
    "RESNET.FIXED_BLOCKS", "0", "TRAIN.GRAD_CLIP", str(GRAD_CLIP), "TRAIN.WARMUP_ITERS", "4",
    "TRAIN.WARMUP_FACTOR", "0.1", "TRAIN.LEARNING_RATE", "1.0"]
MAX_PER_IMAGE = NUM_CLASSES * 64
LABEL_CODE = {"frozen": 0.0, "bias": 1.0, "weight": 2.0}


def _jax_serve(mdl, images, im_info):
    return mdl._pyramid(images), mdl.predict(images, im_info), \
        mdl.detect(images, im_info, MAX_PER_IMAGE)


def _port_model(cfg, sd):
    model = build_model(NET, NUM_CLASSES, cfg)
    model.load_state_dict(sd, strict=True)
    return model


def _jax_losses(mdl, *feed_and_key):
    losses, _ = mdl.train_forward(*feed_and_key)
    return losses


@pytest.fixture(scope="module")
def gn():
    """f32: the JAX model's init (the init test's reference and the tree's
    shapes), its serving outputs and its train_forward losses from seeded
    weights, and the port's from the same weights, minibatch and draws.
    f64 (JAX under ``enable_x64``): two jitted JAX train steps and the
    port's two steps from the same weights, minibatch and draws."""
    jcfg = jax_cfg_from_list(jax_default_config(), OVERRIDES)
    cfg = cfg_from_list(default_config(), OVERRIDES)
    jmodel = jax_build_model(NET, NUM_CLASSES, jcfg)
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((B, H, W, 3)),
                                jnp.zeros((B, 3)))["params"]
    init = jax.tree.map(np.asarray, init)
    params = _numpy_params(jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), init))
    sd = convert_fpn_from_jax(params, NET)

    det = Detector(_port_model(cfg, sd).eval(), max_per_image=MAX_PER_IMAGE, device="cpu")
    (_, data, im_info), = iter_bucket_batches(_images(), det.cfg)
    serve = jax.jit(lambda v, x, i: jmodel.apply(v, x, i, method=_jax_serve))
    want = jax.tree.map(np.asarray, serve({"params": params}, jnp.asarray(data),
                                          jnp.asarray(im_info)))

    roidb, reader = _roidb(np.random.RandomState(1), shapes=((H, W), (H, W - 40)))
    blobs = get_minibatch(roidb, cfg, np.random.RandomState(0), reader=reader)
    keys = (jax.random.PRNGKey(5), jax.random.PRNGKey(6))
    _, skey = jax.random.split(keys[0])
    feed = [jnp.asarray(blobs[k]) for k in FEED]
    jlosses = jax.jit(lambda v, *a: jmodel.apply(v, *a, method=_jax_losses))(
        {"params": params}, *feed, skey)
    with torch.no_grad():
        losses, _ = _port_model(cfg, sd).train_forward(
            *[_t(blobs[k]) for k in FEED], _jax_draws(skey, K, POST + MAX_GT))

    with jax.enable_x64(True):
        jmodel64 = jax_build_model(NET, NUM_CLASSES, jcfg, dtype=jnp.float64)
        params0 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
        tx, _ = jax_make_optimizer(jmodel64, params0, jcfg)
        step = _jax_train_step(jmodel64, tx, _param_labels(jmodel64, params0))
        feed = [jnp.asarray(blobs[k]) for k in FEED]
        params1, opt_state, jlosses1, _ = step(params0, tx.init(params0), *feed, keys[0])
        params2, _, jlosses2, _ = step(params1, opt_state, *feed, keys[1])
        jax_steps = jax.tree.map(np.asarray, (params0, params1, params2))
        draws = [_jax_draws(jax.random.split(key)[1], K, POST + MAX_GT) for key in keys]
    model = build_model(NET, NUM_CLASSES, cfg, dtype=torch.float64)
    model.load_state_dict(sd, strict=True)
    model.double()
    solver = SolverWrapper(model, roidb, cfg, reader=reader, device="cpu")
    states = [{k: v.clone() for k, v in model.state_dict().items()}]
    step_losses = []
    for d in draws:
        step_losses.append(solver.train_step(blobs, d))
        if len(states) == 1:
            clipped = torch.sqrt(sum((p.grad ** 2).sum() for p in model.parameters()))
        states.append({k: v.clone() for k, v in model.state_dict().items()})
    return {"init": init, "params": params, "sd": sd, "cfg": cfg, "det": det, "data": data,
            "im_info": im_info, "want": want, "jlosses": jlosses, "losses": losses,
            "jax_steps": jax_steps, "jax_step_losses": (jlosses1, jlosses2),
            "port_states": states, "step_losses": step_losses, "model": model,
            "clipped_norm": float(clipped)}


@pytest.mark.parametrize("net", ["res50_fpn_gn", "res101_fpn_gn", "res152_fpn_gn"])
def test_converted_state_dict_loads_strict(gn, net):
    if net == NET:
        params = gn["params"]
    else:
        jmodel = jax_build_model(net, NUM_CLASSES, jax_cfg_from_list(jax_default_config(),
                                                                     OVERRIDES))
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                jnp.zeros((1, 3)))["params"]
        params = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = convert_fpn_from_jax(params, net)
    model = build_model(net, NUM_CLASSES, gn["cfg"])
    model.load_state_dict(sd, strict=True)
    assert len(sd) == len(jax.tree.leaves(params)) == len(model.state_dict())
    assert not [n for n in sd if "running" in n]                 # GroupNorm: no statistics
    assert model.bn1.eps == 1e-6 and model.layer4[2].bn3.groups == 32
    assert model.layer1[0].downsample[1].weight.requires_grad


@pytest.mark.parametrize("level", range(5))
def test_pyramid_level_matches_jax(gn, level):
    with torch.no_grad():
        got = gn["det"].model._pyramid(torch.from_numpy(gn["data"]))[level]
    want = gn["want"][0][level]
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_predict_rois_same_set(gn):
    want = gn["want"][1]
    with torch.no_grad():
        got = gn["det"].model.predict(torch.from_numpy(gn["data"]),
                                      torch.from_numpy(gn["im_info"]))
    for i in range(2):
        wv, gv = want["roi_valid"][i], got["roi_valid"][i].numpy()
        assert wv.sum() == gv.sum() > 10
        w_rows = np.concatenate([want["rois"][i][wv], want["roi_scores"][i][wv, None]], 1)
        g_rows = np.concatenate([got["rois"][i].numpy()[gv],
                                 got["roi_scores"][i].numpy()[gv, None]], 1)
        _assert_det_sets_match(w_rows, g_rows, f"image {i} rois", score_atol=1e-5,
                               box_atol=1e-3)


def test_detect_same_detections(gn):
    det_d, det_v = gn["want"][2]
    want = [det_d[i][det_v[i]] for i in range(2)]
    got_d, got_v = gn["det"].detect_blobs(gn["data"], gn["im_info"])
    _match_per_class(want, [got_d[i].numpy()[got_v[i].numpy()] for i in range(2)], "detect")


def test_train_forward_losses_match_jax(gn):
    """f32, from the JAX key's draws: the four losses and their total."""
    jlosses = gn["jlosses"]
    assert float(jlosses["rpn_loss_box"]) > 0 and float(jlosses["loss_box"]) > 0
    assert set(jlosses) == set(gn["losses"])
    for name, want in jlosses.items():
        ours, want = float(gn["losses"][name]), float(want)
        assert abs(ours - want) <= 1e-4 * max(abs(want), 1e-6), (name, ours, want)


def _assert_updates_match(model, jax_old, jax_new, port_old, port_new):
    """Per tensor: the port's update within 1e-3 of max|JAX update|, and
    non-zero on both sides for every tensor (all of them train)."""
    delta = convert_fpn_from_jax(jax.tree.map(np.subtract, jax_new, jax_old), NET)
    params = dict(model.named_parameters())
    assert set(delta) == set(port_new) == set(params)            # all trainable, no buffers
    for name, d_jax in delta.items():
        d_jax, d_port = d_jax.double().numpy(), (port_new[name] - port_old[name]).numpy()
        scale = np.abs(d_jax).max()
        assert scale > 0 and np.abs(d_port).max() > 0, name
        assert np.abs(d_port - d_jax).max() <= 1e-3 * scale, name
    return params


@pytest.mark.parametrize("step", [1, 2])
def test_sgd_steps_match_jax(gn, step):
    """f64 on both sides.  In f32 the trunk's gradients of the two packages
    differ by up to ~1e-1 of a tensor's max: a relu whose input lies within
    the f32 rounding of zero passes the gradient on one side and not on the
    other (of the gradient at layer4.0's bn3 output the f32 port keeps 1e-1
    of max away from an f64 run, while the block output's gradient agrees to
    3e-6), and a GroupNorm trunk at FIXED_BLOCKS 0 trains every such relu.
    Step 1 under a clip that the gradient's global norm exceeds (so the
    norm over exactly the trainable tensors sets the update's scale), at the
    warmup's first lr; step 2 with the momentum of step 1 and the next lr."""
    jlosses = gn["jax_step_losses"][step - 1]
    for name, want in jlosses.items():
        ours, want = float(gn["step_losses"][step - 1][name]), float(want)
        assert abs(ours - want) <= 1e-4 * max(abs(want), 1e-6), (name, ours, want)
    params = _assert_updates_match(gn["model"], gn["jax_steps"][step - 1],
                                   gn["jax_steps"][step], gn["port_states"][step - 1],
                                   gn["port_states"][step])
    names = set(params)
    assert {"conv1.weight", "bn1.weight", "bn1.bias", "layer1.0.bn2.weight",
            "layer1.0.downsample.1.bias", "layer4.2.bn3.weight"} <= names
    norms = [m for m in gn["model"].modules() if isinstance(m, GroupNorm)]
    assert len(norms) == 53                                       # stem + 16 x 3 + 4 downsample
    assert {id(p) for m in norms for p in m.parameters()} <= {id(p) for p in params.values()}
    # the clip was active: the clipped gradients' norm is GRAD_CLIP
    assert abs(gn["clipped_norm"] - GRAD_CLIP) <= 1e-6 * GRAD_CLIP


def _labels_by_port_name(fixed_blocks, shapes):
    """The JAX ``_param_labels`` at ``fixed_blocks``, carried to the port's
    tensor names by the converter (a constant tensor per label)."""
    jcfg = jax_cfg_from_list(jax_default_config(),
                             OVERRIDES + ["RESNET.FIXED_BLOCKS", str(fixed_blocks)])
    jmodel = jax_build_model(NET, NUM_CLASSES, jcfg)
    labels = _param_labels(jmodel, shapes)
    coded = jax.tree.map(lambda lab, s: np.full(s.shape, LABEL_CODE[lab], np.float32),
                         labels, shapes)
    names = {code: lab for lab, code in LABEL_CODE.items()}
    return {n: names[float(t.reshape(-1)[0])]
            for n, t in convert_fpn_from_jax(coded, NET).items()}


@pytest.mark.parametrize("fixed_blocks", [0, 1, 2])
def test_trainable_set_equals_jax_frozen_param(gn, fixed_blocks, capsys):
    want = _labels_by_port_name(fixed_blocks, gn["params"])
    cfg = cfg_from_list(gn["cfg"], ["RESNET.FIXED_BLOCKS", str(fixed_blocks)])
    model = build_model(NET, NUM_CLASSES, cfg)
    warned = "will freeze randomly initialized" in capsys.readouterr().out
    assert warned == (fixed_blocks > 0)
    got = {n: p.requires_grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    assert {n for n, t in got.items() if not t} == {n for n, lab in want.items()
                                                     if lab == "frozen"}
    frozen = {n.split(".")[0] for n, t in got.items() if not t}
    assert frozen == ({"conv1", "bn1"} | {f"layer{i}" for i in range(1, fixed_blocks + 1)}
                      if fixed_blocks else set())


def test_optimizer_groups_equal_param_labels(gn):
    """A GroupNorm scale (the port's ``weight``) trains in the weight group
    (decay, 1x lr), its bias in the bias group (2x lr, no decay)."""
    want = _labels_by_port_name(0, gn["params"])
    model = build_model(NET, NUM_CLASSES, gn["cfg"])
    optimizer, _ = make_optimizer(model, gn["cfg"])
    names = {id(p): n for n, p in model.named_parameters()}
    weights, biases = ({names[id(p)] for p in g["params"]} for g in optimizer.param_groups)
    assert weights == {n for n, lab in want.items() if lab == "weight"}
    assert biases == {n for n, lab in want.items() if lab == "bias"}
    assert {"bn1.weight", "layer2.3.bn3.weight"} <= weights
    assert {"bn1.bias", "layer2.3.bn3.bias"} <= biases
    groups = optimizer.param_groups
    assert (groups[0]["weight_decay"], groups[0]["lr_scale"]) == (gn["cfg"].TRAIN.WEIGHT_DECAY, 1.0)
    assert (groups[1]["weight_decay"], groups[1]["lr_scale"]) == (0.0, 2.0)


def test_reference_init_matches_jax_init(gn):
    """Per tensor of the JAX ``model.init`` (another seed: the distribution
    is compared): |mean - mean_jax| and |std - std_jax| within 10% of
    std_jax; constant tensors (biases 0, GroupNorm scales 1) equal."""
    model = build_model(NET, NUM_CLASSES, gn["cfg"])
    init_reference_(model, torch.Generator().manual_seed(0))
    got = model.state_dict()
    want = convert_fpn_from_jax(gn["init"], NET)
    assert set(got) == set(want)
    for name, w in want.items():
        g, w = got[name].double(), w.double()
        if w.std() == 0:
            assert torch.equal(g, w), name
            continue
        assert abs(g.mean() - w.mean()) <= 0.1 * w.std(), name
        assert abs(g.std() - w.std()) <= 0.1 * w.std(), name
    stds = {n: float(want[n].std()) for n in ("conv1.weight", "box_head.fc1.weight",
                                             "rpn_cls_w", "bbox_pred.weight")}
    np.testing.assert_allclose(list(stds.values()), [(2 / (64 * 49)) ** 0.5, (1 / 12544) ** 0.5,
                                                     0.01, 0.001], rtol=0.1)


def test_train_net_starts_from_the_reference_init(gn, tmp_path, capsys):
    """No ``pretrained``: ``train_net`` draws ``init_reference_`` from
    RNG_SEED and does not warn about a frozen-BN backbone."""
    cfg = gn["cfg"]
    model = build_model(NET, NUM_CLASSES, cfg)
    roidb, reader = _roidb(np.random.RandomState(1), shapes=((H, W), (H, W - 40)))
    sw = train_net(model, None, roidb, None, str(tmp_path), cfg=cfg, max_iters=0,
                   reader=reader, device="cpu")
    assert "frozen-BN" not in capsys.readouterr().out
    want = build_model(NET, NUM_CLASSES, cfg)
    init_reference_(want, torch.Generator().manual_seed(cfg.RNG_SEED))
    for name, t in want.state_dict().items():
        assert torch.equal(sw.model.state_dict()[name], t), name


def test_k3_gate_refuses_group_norm():
    """K3 folds a frozen BN into its weights: a GroupNorm block on a bf16
    card tensor keeps the unfused path."""
    x = types.SimpleNamespace(is_cuda=True, dtype=torch.bfloat16)
    assert Bottleneck(256, 64, fused=True)._use_fused(x)
    assert not Bottleneck(256, 64, fused=True, norm="group")._use_fused(x)
    model = build_model(NET, NUM_CLASSES, cfg_from_list(default_config(), OVERRIDES))
    blocks = [m for m in model.modules() if isinstance(m, Bottleneck)]
    assert len(blocks) == 16 and any(b.fused for b in blocks)
    assert not any(b._use_fused(x) for b in blocks)
