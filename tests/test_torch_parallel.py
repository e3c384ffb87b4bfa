"""The port's data parallelism (``frcnn_tpu_torch/parallel``) on 2 gloo
ranks on the CPU, against its own unsharded runs and the JAX package's
``make_mesh(2)`` runs (conftest's 8 virtual CPU devices).

The ranks run ``frcnn_tpu_torch.parallel.dryrun.run_jobs`` (a function of
the port, so that no rank imports JAX) in one module-scoped spawn; inputs go
in and results come back as numpy arrays:

  * the mesh helpers: ``shard_batch``'s rows, ``replicate`` bit-equal, the
    f32 mean of a bf16 gradient, the ``ValueError`` of an uneven batch;
  * the res50 C4 train step of ``tests/test_torch_train.py`` (weights of
    ``_detector_state_dict``, draws from the JAX key splits, lr 1.0) over
    the mesh: against the JAX step jitted over ``make_mesh(2)`` (losses
    within 1e-4 relative, updates within 1e-3 of max|JAX update|), and
    against the port's unsharded step (rtol 2e-4, atol 2e-5; the gradient
    mean reduces in another order), the replicas bit-equal;
  * ``Detector`` over the mesh on 5 images (the group padded to 6): every
    rank's results match the unsharded port's and JAX's mesh ``Detector``'s;
  * ``train_net`` over the mesh through the CLI (``--data-parallel 2
    --cpu``), the counterpart of ``tests/test_resume_exact.py``'s mesh test:
    stopped at 3 and resumed to 5 bit-equal to the straight run, which is
    within rtol 2e-4 / atol 2e-5 of a mesh-less run on the same global
    batches;
  * ``dryrun_multichip(2)``;
  * without a spawn: a rank's draws and minibatch rows equal those rows of
    the whole batch's, and the device rule under a mesh.
"""

import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from frcnn_tpu import cfg_from_list as jax_cfg_from_list
from frcnn_tpu import default_config as jax_default_config
from frcnn_tpu.engine.serve import Detector as JaxDetector
from frcnn_tpu.engine.train import _param_labels, stop_frozen_gradients
from frcnn_tpu.engine.train import make_optimizer as jax_make_optimizer
from frcnn_tpu.models import build_model as jax_build_model
from frcnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from frcnn_tpu.parallel.mesh import replicate as jax_replicate
from frcnn_tpu.parallel.mesh import shard_batch as jax_shard_batch
from frcnn_tpu.utils.weight_convert import convert_detector
from frcnn_tpu_torch import cfg_from_list, default_config
from frcnn_tpu_torch.data.loader import RoIDataLayer, get_minibatch
from frcnn_tpu_torch.engine import resolve_device
from frcnn_tpu_torch.models.network import build_model
from frcnn_tpu_torch.models.targets import ShardedDraws, uniform_draws
from frcnn_tpu_torch.parallel.dryrun import dryrun_multichip, run_jobs
from frcnn_tpu_torch.parallel.mesh import Mesh, spawn
from frcnn_tpu_torch.tools import trainval_net as trainval_net_cli
from tests.test_pipeline_parity import NUM_CLASSES, _assert_det_sets_match, _detector_state_dict
from tests.test_torch_detect import OVERRIDES as SERVE_OVERRIDES
from tests.test_torch_train import OVERRIDES, H, W, _assert_updates_match, _jax_draws, _roidb

WORLD = 2
NAMES = ("data", "im_info", "gt_boxes", "gt_labels", "gt_valid")
MAX_PER_IMAGE = NUM_CLASSES * 32
# lr 1.0: at the default 1e-3 an update is ~100 ulps of its weight
TRAIN = OVERRIDES + ["TRAIN.LEARNING_RATE", "1.0"]


def _images(n):
    """``n`` images of low-frequency noise with flat rectangles, short side
    128 (the serving scale: no resize), widths 160-192 (one bucket)."""
    rng = np.random.RandomState(12)
    ims = []
    for i in range(n):
        w = (192, 160, 176)[i % 3]
        base = rng.randint(0, 255, (9, w // 16 + 1, 3)).astype(np.float32)
        t = torch.from_numpy(base).permute(2, 0, 1)[None]
        im = torch.nn.functional.interpolate(t, size=(128, w), mode="bilinear",
                                             align_corners=False)[0].permute(1, 2, 0).numpy()
        for _ in range(4):
            y, x = rng.randint(0, 88), rng.randint(0, w - 40)
            im[y:y + rng.randint(16, 40), x:x + rng.randint(16, 40)] = rng.randint(0, 255, 3)
        ims.append(np.clip(im, 0, 255).astype(np.uint8))
    return ims


@pytest.fixture(scope="module")
def case():
    """The inputs: res50 weights as a state_dict and a JAX tree, a global
    batch of 2 and its draws from the JAX key, 5 serving images."""
    sd = _detector_state_dict(np.random.RandomState(0))
    cfg = cfg_from_list(default_config(), TRAIN)
    roidb, reader = _roidb(np.random.RandomState(1))
    blobs = get_minibatch(roidb, cfg, np.random.RandomState(0), reader=reader)
    key = jax.random.PRNGKey(5)
    k = (H // 16) * (W // 16) * cfg.num_anchors
    draws = _jax_draws(jax.random.split(key)[1], k, 64 + cfg.DEVICE.MAX_GT)
    state = {name: t.numpy() for name, t in sd.items()}
    return {"state": state, "params": convert_detector(state, "res50"), "blobs": blobs,
            "draws": {name: t.numpy() for name, t in draws.items()}, "key": key,
            "images": _images(5)}


@pytest.fixture(scope="module")
def ranks(case):
    """One spawn of 2 gloo ranks: [mesh helpers, train step, detect] per
    rank, and the same train step and detect unsharded in this process."""
    train = {"net": "res50", "num_classes": NUM_CLASSES, "overrides": TRAIN,
             "state": case["state"], "blobs": case["blobs"], "draws": case["draws"]}
    detect = {"net": "res50", "num_classes": NUM_CLASSES, "overrides": SERVE_OVERRIDES,
              "state": case["state"], "requests": [case["images"]]}
    # 6 images: the 5 served and the 5th again, as the padded group
    from frcnn_tpu_torch.engine.serve import prep_image

    prepped = [prep_image(im, cfg_from_list(default_config(), SERVE_OVERRIDES))
               for im in case["images"] + case["images"][-1:]]
    detect["data"] = np.stack([blob for blob, _ in prepped])
    detect["im_info"] = np.stack([info for _, info in prepped])
    jobs = [("train_step", train), ("detect", detect)]
    return {"ranks": spawn(run_jobs, WORLD, "gloo", [("mesh", None)] + jobs, device="cpu"),
            "single": run_jobs(None, jobs, "cpu")}


def test_shard_batch_gives_each_rank_its_rows(ranks):
    want = np.arange(2 * WORLD * 3).reshape(2 * WORLD, 3)
    for rank, (mesh, _, _) in enumerate(ranks["ranks"]):
        np.testing.assert_array_equal(mesh["rows"], want[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(mesh["rows_tensor"], want[2 * rank:2 * rank + 2])


def test_shard_batch_refuses_a_batch_the_mesh_does_not_divide(ranks):
    for mesh, _, _ in ranks["ranks"]:
        assert mesh["error"] == ("batch size 5 is not a multiple of the mesh size 2: "
                                 "every rank must hold as many images")


def test_replicate_makes_every_rank_rank_0s_model_bit_for_bit(ranks):
    (m0, _, _), (m1, _, _) = ranks["ranks"]
    assert m1["before"] != m0["before"]                    # seeded apart
    assert m0["digest"] == m1["digest"] == m0["before"]


def test_gradients_and_losses_are_averaged_in_f32(ranks):
    parts = torch.tensor([r + 1.0 / 3.0 for r in range(WORLD)]).bfloat16().float()
    want = (parts.sum() / WORLD).bfloat16().float().numpy()
    for mesh, _, _ in ranks["ranks"]:
        np.testing.assert_array_equal(mesh["grad"], np.full(5, want))
        assert mesh["loss"] == (WORLD + 1) / 2


@pytest.fixture(scope="module")
def jax_step(case):
    """The JAX package's train step jitted over ``make_mesh(2)``: params
    replicated, the batch sharded (the body of ``construct_graph``)."""
    jcfg = jax_cfg_from_list(jax_default_config(), TRAIN)
    jmodel = jax_build_model("res50", NUM_CLASSES, jcfg)
    params = case["params"]
    tx, _ = jax_make_optimizer(jmodel, params, jcfg)
    labels = _param_labels(jmodel, params)

    def train_step(params, opt_state, data, im_info, gt_boxes, gt_labels, gt_valid, key):
        dkey, skey = jax.random.split(key)

        def loss_fn(p):
            losses, _ = jmodel.apply({"params": stop_frozen_gradients(labels, p)}, data,
                                     im_info, gt_boxes, gt_labels, gt_valid, skey,
                                     method="train_forward", rngs={"dropout": dkey})
            return losses["total_loss"], losses

        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), losses

    mesh = jax_make_mesh(WORLD)
    feed = jax_shard_batch([jnp.asarray(case["blobs"][n]) for n in NAMES], mesh)
    new_params, losses = jax.jit(train_step)(jax_replicate(params, mesh),
                                             jax_replicate(tx.init(params), mesh), *feed,
                                             case["key"])
    return jax.tree.map(np.asarray, new_params), {k: float(v) for k, v in losses.items()}


def test_sharded_step_matches_the_jax_sharded_step(case, ranks, jax_step):
    new_params, jlosses = jax_step
    model = build_model("res50", NUM_CLASSES, cfg_from_list(default_config(), TRAIN))
    before = {k: torch.from_numpy(v) for k, v in case["state"].items()}
    for _, step, _ in ranks["ranks"]:
        for name, want in jlosses.items():
            ours = step["losses"][name]
            assert abs(ours - want) <= 1e-4 * max(abs(want), 1e-6), (name, ours, want)
        after = {k: torch.from_numpy(v) for k, v in step["state"].items()}
        _assert_updates_match(model, case["params"], new_params, before, after)


def test_sharded_step_matches_the_unsharded_step(case, ranks):
    single = ranks["single"][0]
    steps = [r[1] for r in ranks["ranks"]]
    assert steps[0]["digest"] == steps[1]["digest"]        # the replicas, bit for bit
    assert steps[0]["losses"] == steps[1]["losses"]
    for name, want in single["losses"].items():
        ours = steps[0]["losses"][name]
        assert abs(ours - want) <= 2e-4 * max(abs(want), 1.0), (name, ours, want)
    assert single["state"].keys() == steps[0]["state"].keys()
    for name, want in single["state"].items():
        np.testing.assert_allclose(steps[0]["state"][name], want, rtol=2e-4, atol=2e-5,
                                   err_msg=name)
    for name in ("rpn_net.weight", "cls_score.weight", "layer3.0.conv1.weight"):
        assert not np.array_equal(single["state"][name], case["state"][name]), name


def _match(want, got, label):
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.shape[1] == 6 and np.isfinite(g).all()
        for j in range(1, NUM_CLASSES):
            _assert_det_sets_match(w[w[:, 5] == j][:, :5], g[g[:, 5] == j][:, :5],
                                   f"{label} image {i} class {j}")


def test_detector_over_the_mesh_serves_the_unsharded_results(ranks):
    (want,) = ranks["single"][1]["results"]
    assert sum(len(d) for d in want) > 5
    for rank, (_, _, det) in enumerate(ranks["ranks"]):
        (got,) = det["results"]
        _match(want, got, f"rank {rank}")


def test_detector_over_the_mesh_matches_the_jax_mesh_detector(case, ranks):
    jcfg = jax_cfg_from_list(jax_default_config(), SERVE_OVERRIDES)
    jdet = JaxDetector(jax_build_model("res50", NUM_CLASSES, jcfg), {"params": case["params"]},
                       mesh=jax_make_mesh(WORLD), max_per_image=MAX_PER_IMAGE)
    want = jdet(case["images"])
    for rank, (_, _, det) in enumerate(ranks["ranks"]):
        _match(want, det["results"][0], f"JAX mesh vs rank {rank}")


def test_detect_blobs_over_the_mesh_returns_the_local_shard(ranks):
    single = ranks["single"][1]
    assert len(single["dets"]) == 6
    for rank, (_, _, det) in enumerate(ranks["ranks"]):
        rows = slice(3 * rank, 3 * rank + 3)
        np.testing.assert_array_equal(det["valid"], single["valid"][rows])
        np.testing.assert_allclose(det["dets"], single["dets"][rows], rtol=1e-5, atol=1e-3)


# -- train_net over the mesh, through the CLI -------------------------------------

def _cli(voc_root, tmp, tag, iters, snapshot_iters, ranks=WORLD):
    """The mobile (width 0.25) recipe of tests/test_resume_exact.py at a
    global batch of 4; returns the final snapshot's state_dict."""
    root, _ = voc_root
    argv = ["--cpu", "--net", "mobile", "--imdb", "voc_2007_trainval", "--imdbval", "",
            "--iters", str(iters), "--tag", tag]
    if ranks:
        argv += ["--data-parallel", str(ranks)]
    argv += ["--set", "DATA_DIR", root, "ROOT_DIR", str(tmp),
             "MOBILENET.DEPTH_MULTIPLIER", "0.25", "TRAIN.SCALES", "(160,)",
             "TRAIN.MAX_SIZE", "320", "TRAIN.IMS_PER_BATCH", "4", "TRAIN.BATCH_SIZE", "32",
             "TRAIN.RPN_BATCHSIZE", "64", "TRAIN.RPN_PRE_NMS_TOP_N", "256",
             "TRAIN.RPN_POST_NMS_TOP_N", "32", "TRAIN.SNAPSHOT_ITERS", str(snapshot_iters),
             "TRAIN.DISPLAY", "100", "TRAIN.STEPSIZE", "(100,)", "TRAIN.LEARNING_RATE", "0.005",
             "TRAIN.SNAPSHOT_KEPT", "5", "TRAIN.USE_FLIPPED", "False",
             "TPU.BUCKETS", "((160, 256),)", "TPU.MAX_GT", "8", "ANCHOR_SCALES", "(2, 4)"]
    out = trainval_net_cli.main(argv)
    if ranks:
        assert [r["rank"] for r in out] == list(range(ranks))
        assert {r["step"] for r in out} == {iters} and {r["device"] for r in out} == {"cpu"}
    path = osp.join(str(tmp), "output", "default", "voc_2007_trainval", tag,
                    f"default_iter_{iters}.pth")
    return torch.load(path, weights_only=True)["model"]


@pytest.fixture(scope="module")
def trained(voc_root, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train_net")
    straight = _cli(voc_root, tmp, "straight", 5, 100)
    _cli(voc_root, tmp, "resumed", 3, 3)
    resumed = _cli(voc_root, tmp, "resumed", 5, 100)
    meshless = _cli(voc_root, tmp, "meshless", 5, 100, ranks=0)
    return straight, resumed, meshless


def test_train_net_over_the_mesh_resumes_bit_exactly(trained):
    straight, resumed, _ = trained
    assert straight.keys() == resumed.keys()
    for name, t in straight.items():
        assert torch.equal(t, resumed[name]), name


def test_train_net_over_the_mesh_matches_the_meshless_run(trained):
    straight, _, meshless = trained
    moved = 0
    for name, t in straight.items():
        np.testing.assert_allclose(t.numpy(), meshless[name].numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=name)
        moved += name == "cls_score.weight"
    assert moved == 1


def test_dryrun_multichip_2(capsys):
    lines = dryrun_multichip(WORLD)
    assert len(lines) == 5 and all(": ok" in line for line in lines)
    assert "mobile DETECT" in lines[2] and "res50_fpn_gn DETECT" in lines[4]
    assert capsys.readouterr().out.count("dryrun_multichip(2)") == 5


# -- a rank's share of the draws and the data, without a spawn --------------------

@pytest.mark.parametrize("dropout", [None, (2, 4 * 3, 5)])
def test_sharded_draws_are_the_rows_of_the_whole_batchs(dropout):
    whole = uniform_draws(torch.Generator().manual_seed(9), 4, 7, 6, dropout)
    end = torch.Generator().manual_seed(9)
    uniform_draws(end, 4, 7, 6, dropout)
    for rank in range(WORLD):
        g = torch.Generator().manual_seed(9)
        part = uniform_draws(ShardedDraws(g, rank, WORLD), 2, 7, 6,
                             None if dropout is None else (2, 2 * 3, 5))
        for name in ("anchor_fg", "anchor_bg", "roi_fg", "roi_bg"):
            assert torch.equal(part[name], whole[name][2 * rank:2 * rank + 2])
        if dropout is not None:     # image-major: a rank's images' 3-row blocks
            assert torch.equal(part["dropout"], whole["dropout"][:, 6 * rank:6 * rank + 6])
        assert torch.equal(g.get_state(), end.get_state())


def _layer_roidb(rng, n=6):
    shapes = [(128, 192), (128, 160), (96, 192), (128, 176), (128, 192), (112, 160)][:n]
    return _roidb(rng, shapes)


@pytest.mark.parametrize("route", ["decoded", "cached"])
def test_a_ranks_minibatch_rows_are_those_of_the_whole_batch(route, tmp_path):
    extra = ["TRAIN.SCALES", "(96, 128)", "TRAIN.IMS_PER_BATCH", "4",
             "DEVICE.BUCKETS", "((96, 160), (128, 192))"]
    cfg = cfg_from_list(default_config(), OVERRIDES + extra)
    roidb, reader = _layer_roidb(np.random.RandomState(2))
    if route == "cached":
        from frcnn_tpu_torch.data.cache import ResizedImageCache

        images = {}
        for e in roidb:     # the cache keys its entries by a file's path, size and mtime
            path = str(tmp_path / e["image"])
            images[path] = reader(e["image"])
            with open(path, "wb") as f:
                np.save(f, images[path])
            e["image"] = path
        reader = ResizedImageCache.build([e["image"] for e in roidb], str(tmp_path / "c"),
                                         targets=cfg.TRAIN.SCALES, max_size=cfg.TRAIN.MAX_SIZE,
                                         buckets=cfg.DEVICE.BUCKETS, reader=images.__getitem__)
    whole = RoIDataLayer(roidb, cfg, reader=reader)
    shards = [RoIDataLayer(roidb, cfg, reader=reader, rows=slice(2 * r, 2 * r + 2))
              for r in range(WORLD)]
    for _ in range(3):
        want = whole.forward()
        for rank, layer in enumerate(shards):
            got = layer.forward()
            for name in NAMES:
                np.testing.assert_array_equal(got[name], want[name][2 * rank:2 * rank + 2],
                                              err_msg=name)
            state, want_state = layer.get_state(), whole.get_state()
            assert state["cur"] == want_state["cur"]
            np.testing.assert_array_equal(state["perm"], want_state["perm"])
            np.testing.assert_array_equal(state["rng"][1], want_state["rng"][1])
            assert state["rng"][2:] == want_state["rng"][2:]


def test_the_device_rule_under_a_mesh():
    mesh = Mesh(1, 2, torch.device("cpu"), "gloo")
    assert resolve_device(None, mesh) == torch.device("cpu")
    assert resolve_device("cpu", mesh) == torch.device("cpu")
    with pytest.raises(ValueError, match="not the mesh's device"):
        resolve_device("cuda:1", mesh)
    assert mesh.rows(6) == slice(3, 6)
    with pytest.raises(ValueError, match="not a multiple of the mesh size"):
        mesh.rows(5)


def test_kernels_refuse_a_tensor_of_another_card(monkeypatch):
    """``check_cuda``'s device guard, without a card: a stand-in for a tensor
    on cuda:1 while the current card is cuda:0 (tests/test_torch_cuda.py
    shows it on the card)."""
    import types

    from frcnn_tpu_torch.ops.cuda import build

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    other = types.SimpleNamespace(is_cuda=True, device=torch.device("cuda", 1))
    with pytest.raises(ValueError, match="lies on cuda:1 but the current card is cuda:0"):
        build.check_cuda("boxes", other)
