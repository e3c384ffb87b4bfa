"""The data-parallel certificate (``__graft_entry__.py::dryrun_multichip``)
and the rank functions it spawns.

``dryrun_multichip(n)`` runs, for a C4 arm (``mobile``) and an FPN arm
(``res50_fpn_gn``, nothing frozen) at the JAX dryrun's tiny shapes, ONE
global-batch train step sharded over ``n`` gloo ranks on the CPU and the
same step unsharded, from the same weights, batch and draws, and asserts
that they agree (losses within 2e-4 relative, parameters at rtol 2e-4 and
atol 2e-5: the gradient mean reduces in another order) and that the
replicas are bit-equal across the ranks; then one detect batch sharded and
unsharded (valid masks equal, detections within 2e-4 absolute and 1e-5
relative).  The detect tolerance is twice the JAX dryrun's 1e-4: the CPU's
convolutions sum in an order that depends on the batch size (a 3x3 conv of
256 channels at 8x8 differs by 2e-5 between batch 1 and 2), and through the
GroupNorm FPN's trunk that moves a box corner by up to 1.5e-4 pixels.  It
prints one line an arm and a mode with the largest errors:

    python -c "from frcnn_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(2)"

``run_jobs`` is the rank function: it runs a list of jobs (``train_step``,
``detect``, ``mesh``) on one rank, or unsharded with no mesh, and returns
numpy results, so a caller's inputs and outputs cross the process boundary
as numpy arrays.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from frcnn_tpu_torch.parallel.mesh import (all_reduce_grads_, all_reduce_mean, replicate,
                                           shard_batch, spawn)

# the JAX dryrun's config (``__graft_entry__.py:_small_cfg`` and its cuts)
TINY = ["TEST.RPN_PRE_NMS_TOP_N", "1024", "TEST.RPN_POST_NMS_TOP_N", "128",
        "TEST.MAX_PER_IMAGE", "100", "TRAIN.RPN_PRE_NMS_TOP_N", "64",
        "TRAIN.RPN_POST_NMS_TOP_N", "32", "TRAIN.BATCH_SIZE", "16", "TRAIN.RPN_BATCHSIZE", "32",
        "DEVICE.BUCKETS", "((128, 128),)", "DEVICE.MAX_GT", "4", "ANCHOR_SCALES", "(2, 4)"]
ARMS = (("mobile", []), ("res50_fpn_gn", ["RESNET.FIXED_BLOCKS", "0"]))
NUM_CLASSES = 21


def state_numpy(model) -> dict:
    """The state_dict as f32 (floating) or native numpy arrays."""
    return {k: (v.detach().cpu().float() if v.is_floating_point() else v.detach().cpu()).numpy()
            for k, v in model.state_dict().items()}


def state_digest(state: dict) -> str:
    """sha256 of every tensor's bytes of a state_dict: equal digests,
    bit-equal replicas."""
    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _model(spec, device):
    from frcnn_tpu_torch import cfg_from_list, default_config
    from frcnn_tpu_torch.models.network import build_model

    cfg = cfg_from_list(default_config(), spec["overrides"])
    dtype = torch.bfloat16 if spec.get("dtype") == "bfloat16" else torch.float32
    model = build_model(spec["net"], spec.get("num_classes", NUM_CLASSES), cfg, dtype=dtype)
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in spec["state"].items()}
    model.load_state_dict(state)
    return model.to(device), cfg


def train_step_job(mesh, spec, device):
    """One ``SolverWrapper.train_step`` on the global batch ``spec["blobs"]``
    (this rank's rows under a mesh), with the solver's draws or the global
    ``spec["draws"]``: the losses, the state after the step and the
    replica's digest."""
    from frcnn_tpu_torch.engine.train import SolverWrapper
    from frcnn_tpu_torch.models.targets import shard_draws

    model, cfg = _model(spec, device)
    solver = SolverWrapper(model, [], cfg, device=device, mesh=mesh)
    blobs, draws = spec["blobs"], spec.get("draws")
    if draws is not None:
        draws = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in draws.items()}
    if mesh is not None:
        blobs = shard_batch(blobs, mesh)
        if draws is not None:
            draws = shard_draws(draws, mesh.rank, mesh.size)
    losses = solver.train_step(blobs, draws)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "digest": state_digest(model.state_dict()), "state": state_numpy(model)}


def detect_job(mesh, spec, device):
    """``Detector(model, mesh=mesh)`` on the requests ``spec["requests"]``
    (lists of BGR images; every rank returns every image's detections) and
    ``detect_blobs`` on the global batch ``spec["data"]``, ``spec["im_info"]``
    (this rank's rows under a mesh)."""
    from frcnn_tpu_torch.engine.serve import Detector

    model, cfg = _model(spec, device)
    det = Detector(model.eval(), cfg, device=device, mesh=mesh)
    out = {"results": [det(images) for images in spec.get("requests", ())]}
    if "data" in spec:
        dets, valid = det.detect_blobs(spec["data"], spec["im_info"])
        out["dets"], out["valid"] = dets.float().cpu().numpy(), valid.cpu().numpy()
    return out


def mesh_job(mesh, spec, device):
    """The mesh helpers on this rank: ``shard_batch``'s rows of an arange
    batch, a rank-seeded model's digest after ``replicate``, the f32 mean of
    a bf16 gradient of rank + 1/3 and of a loss of rank + 1, and the error
    of a batch that is no multiple of the mesh size."""
    batch = np.arange(2 * mesh.size * 3).reshape(2 * mesh.size, 3)
    rows = shard_batch({"a": batch, "b": (torch.from_numpy(batch),)}, mesh)
    torch.manual_seed(100 + mesh.rank)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4)).to(device)
    before = state_digest(model.state_dict())
    replicate(model, mesh)
    p = torch.nn.Parameter(torch.zeros(5, dtype=torch.bfloat16, device=device))
    p.grad = torch.full((5,), mesh.rank + 1.0 / 3.0, dtype=torch.bfloat16, device=device)
    all_reduce_grads_([p], mesh)
    mean = all_reduce_mean({"loss": torch.tensor(mesh.rank + 1.0, device=device)}, mesh)
    try:
        shard_batch(np.zeros((2 * mesh.size + 1, 2)), mesh)
        error = None
    except ValueError as e:
        error = str(e)
    return {"rows": rows["a"], "rows_tensor": rows["b"][0].numpy(), "before": before,
            "digest": state_digest(model.state_dict()), "grad": p.grad.float().cpu().numpy(),
            "loss": float(mean["loss"]), "error": error}


JOBS = {"train_step": train_step_job, "detect": detect_job, "mesh": mesh_job}


def run_jobs(mesh, jobs, device=None):
    """Run ``jobs``, a list of (kind, spec), on this rank of ``mesh`` (or
    unsharded on ``device`` with no mesh); returns their results in order."""
    device = mesh.device if mesh is not None else torch.device(device or "cuda")
    return [JOBS[kind](mesh, spec, device) for kind, spec in jobs]


# -- the certificate ------------------------------------------------------------

def _arm_inputs(net, extra, b):
    """(spec of the arm's model, train blobs, detect data, im_info): seeded
    weights (a GroupNorm net the JAX package's from-scratch init, else
    ``init_random_``), the JAX dryrun's gt boxes, seeded noise images."""
    from frcnn_tpu_torch import cfg_from_list, default_config
    from frcnn_tpu_torch.models.fpn import init_reference_
    from frcnn_tpu_torch.models.network import build_model, init_random_

    overrides = TINY + ["TRAIN.IMS_PER_BATCH", str(b)] + extra
    model = build_model(net, NUM_CLASSES, cfg_from_list(default_config(), overrides))
    init = init_reference_ if net.endswith("_gn") else init_random_
    init(model, torch.Generator().manual_seed(0))
    spec = {"net": net, "overrides": overrides, "state": state_numpy(model)}
    rng = np.random.RandomState(4)
    im_info = np.tile(np.asarray([[128.0, 128.0, 1.0]], np.float32), (b, 1))
    blobs = {"data": rng.uniform(0, 255, (b, 128, 128, 3)).astype(np.float32),
             "im_info": im_info,
             "gt_boxes": np.tile(np.asarray([[[8, 8, 96, 100], [30, 20, 120, 90], [0] * 4,
                                              [0] * 4]], np.float32), (b, 1, 1)),
             "gt_labels": np.tile(np.asarray([[3, 7, 0, 0]], np.int32), (b, 1)),
             "gt_valid": np.tile(np.asarray([[True, True, False, False]]), (b, 1))}
    data = rng.uniform(0, 255, (b, 128, 128, 3)).astype(np.float32)
    return spec, blobs, data, im_info


def dryrun_multichip(n: int) -> list:
    """The certificate on ``n`` gloo CPU ranks (module docstring); raises on
    a disagreement, returns the printed lines."""
    b = n  # one image a rank, as the JAX dryrun
    arms, jobs = [], [("mesh", None)]
    for net, extra in ARMS:
        spec, blobs, data, im_info = _arm_inputs(net, extra, b)
        arms.append((net, spec, blobs, data, im_info))
        jobs += [("train_step", {**spec, "blobs": blobs}),
                 ("detect", {**spec, "data": data, "im_info": im_info})]
    ranks = spawn(run_jobs, n, "gloo", jobs, device="cpu")
    single = run_jobs(None, jobs[1:], "cpu")

    check = [r[0] for r in ranks]
    want_rows = np.arange(2 * n * 3).reshape(2 * n, 3)
    for rank, c in enumerate(check):
        np.testing.assert_array_equal(c["rows"], want_rows[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(c["rows_tensor"], c["rows"])
        if c["digest"] != check[0]["before"] or c["loss"] != (n + 1) / 2 or c["error"] is None:
            raise AssertionError(f"dryrun_multichip({n}) mesh helpers on rank {rank}: {c}")
    lines = [f"dryrun_multichip({n}) mesh: ok, shard_batch rows, replicate bit-equal, "
             f"f32 gradient mean {check[0]['grad'][0]:.6f}"]
    for i, (net, _, _, _, _) in enumerate(arms):
        got = [r[1 + 2 * i] for r in ranks]
        want = single[2 * i]
        lines.append(_check_train(n, net, got, want))
        lines.append(_check_detect(n, net, [r[2 + 2 * i] for r in ranks], single[2 * i + 1]))
    for line in lines:
        print(line)
    return lines


def _check_train(n, net, got, want):
    digests = {g["digest"] for g in got}
    if len(digests) != 1:
        raise AssertionError(f"{net}: the replicas differ after the step ({len(digests)} states)")
    total = got[0]["losses"]["total_loss"]
    if not np.isfinite(total) or total >= 50.0:
        raise AssertionError(f"{net}: loss {total} outside the sane init regime")
    for k, c in want["losses"].items():
        a = got[0]["losses"][k]
        if abs(a - c) > 2e-4 * max(abs(c), 1.0):
            raise AssertionError(f"{net}: loss {k} sharded {a} vs unsharded {c}")
    max_rel = 0.0
    for k, pc in want["state"].items():
        pa = got[0]["state"][k]
        np.testing.assert_allclose(pa, pc, rtol=2e-4, atol=2e-5, err_msg=f"{net} {k}")
        if pa.dtype.kind == "f":
            max_rel = max(max_rel, float(np.max(np.abs(pa - pc) / np.maximum(np.abs(pc), 1e-3),
                                                initial=0.0)))
    return (f"dryrun_multichip({n}) {net}: ok, total_loss={total:.4f}, sharded-vs-unsharded "
            f"param max_rel_err={max_rel:.2e} (loss deltas <= 2e-4 rel), replicas bit-equal")


def _check_detect(n, net, got, want):
    dets = np.concatenate([g["dets"] for g in got])
    valid = np.concatenate([g["valid"] for g in got])
    np.testing.assert_array_equal(valid, want["valid"], err_msg=f"{net} detect valid")
    np.testing.assert_allclose(dets, want["dets"], rtol=1e-5, atol=2e-4,
                               err_msg=f"{net} detect")
    err = float(np.max(np.abs(dets - want["dets"])))
    return (f"dryrun_multichip({n}) {net} DETECT: ok, sharded-vs-unsharded "
            f"max_abs_err={err:.2e} (valid masks equal)")
