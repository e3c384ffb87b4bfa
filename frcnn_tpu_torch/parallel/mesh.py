"""Data parallelism over ``torch.distributed`` (``frcnn_tpu/parallel/mesh.py``):
one process per device, parameters replicated, the global batch sharded on
axis 0 in equal parts.

The JAX package gets the gradient reduction from ``jit`` over a sharded
array; here the solver reduces explicitly (``all_reduce_grads_``) after
``backward()``: ``train_forward`` is a method, not ``forward``, so
``DistributedDataParallel``'s hooks would never run.  A rank's losses are
the mean over its own images, and the mean of the ranks' means equals the
global batch mean only when every rank holds as many images: hence the
divisibility rule of ``shard_batch``/``Mesh.rows`` and the padding of
``Detector``.

    results = spawn(fn, 2, "gloo", *args, device="cpu")   # fn(mesh, *args) on 2 ranks

``spawn`` starts one process a rank ("spawn" start method), gives each its
card (``cuda:rank % device_count``) before anything touches CUDA, and joins
an existing ``torchrun`` world where ``WORLD_SIZE`` is set.  NCCL needs a
card a rank; on one card the ranks share it over gloo, which all-reduces and
broadcasts CUDA tensors but gathers only host objects (``gather_rows``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import socket
import tempfile

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 1800.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh over the default process group: this process's place
    in it and its device."""

    rank: int
    size: int
    device: torch.device
    backend: str

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch``."""
        if batch % self.size:
            raise ValueError(f"batch size {batch} is not a multiple of the mesh size "
                             f"{self.size}: every rank must hold as many images")
        n = batch // self.size
        return slice(self.rank * n, (self.rank + 1) * n)


def make_mesh(n: int | None = None, device=None) -> Mesh:
    """The mesh over every rank of the initialised default process group;
    ``n`` (default: the world size) must equal it.  ``device``: this rank's
    device; None means its current card (``spawn`` sets it) and raises
    without one; ``"cpu"`` is an explicit request (gloo only)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (spawn, or "
                           "torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"need {n} ranks, the process group has {world}: a mesh spans "
                         "every rank")
    backend = dist.get_backend()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' for a CPU mesh")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {device}")
    return Mesh(dist.get_rank(), world, device, backend)


def _comm_device(mesh: Mesh) -> torch.device:
    """Where small collectives' tensors live: NCCL moves only CUDA tensors,
    gloo any."""
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


@torch.no_grad()
def replicate(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, bit for bit
    (one broadcast of their bytes, whatever their dtypes)."""
    tensors = list(model.parameters()) + list(model.buffers())
    flat = torch.cat([t.detach().reshape(-1).view(torch.uint8) for t in tensors])
    flat = flat.to(mesh.device)
    dist.broadcast(flat, src=0)
    offset = 0
    for t in tensors:
        n = t.numel() * t.element_size()
        t.copy_(flat[offset:offset + n].clone().view(t.dtype).view(t.shape))
        offset += n
    return model


def shard_batch(blobs, mesh: Mesh):
    """This rank's rows of every array of ``blobs`` (a dict, tuple, list or
    one array or tensor, batch on axis 0); raises ``ValueError`` unless the
    batch divides the mesh size.  Rows are views where the input allows."""
    if isinstance(blobs, dict):
        return {k: shard_batch(v, mesh) for k, v in blobs.items()}
    if isinstance(blobs, (tuple, list)):
        return type(blobs)(shard_batch(v, mesh) for v in blobs)
    return blobs[mesh.rows(blobs.shape[0])]


@torch.no_grad()
def all_reduce_grads_(params, mesh: Mesh) -> None:
    """Replace every gradient by its mean over the ranks: one flat f32
    buffer, all-reduced, then divided by the world size (a bf16 gradient is
    summed in f32 and rounded once).  Every rank runs the same graph, so the
    parameters with a gradient are the same on every rank."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    flat.div_(mesh.size)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@torch.no_grad()
def all_reduce_mean(values: dict, mesh: Mesh) -> dict:
    """The mean over the ranks of a dict of scalar tensors, in f32."""
    names = list(values)
    flat = torch.stack([values[k].detach().float().reshape(()) for k in names])
    flat = flat.to(_comm_device(mesh))
    dist.all_reduce(flat)
    flat = (flat / mesh.size).to(mesh.device)
    return dict(zip(names, flat.unbind()))


def gather_rows(rows: list, mesh: Mesh) -> list:
    """Every rank's list of host objects (numpy arrays) concatenated in rank
    order, on every rank: the rows of a sharded batch, gathered after
    readback."""
    parts = [None] * mesh.size
    dist.all_gather_object(parts, rows)
    return [row for part in parts for row in part]


def broadcast_flag(flag: bool, mesh: Mesh) -> bool:
    """Rank 0's ``flag`` on every rank: a decision every rank must share."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=_comm_device(mesh))
    dist.broadcast(t, src=0)
    return bool(t.item())


def barrier(mesh: Mesh) -> None:
    # NCCL's barrier picks a device by rank unless told; a rank's device is its own
    if mesh.backend == "nccl":
        dist.barrier(device_ids=[mesh.device.index])
    else:
        dist.barrier()


def rank0_first(fn, mesh: Mesh | None):
    """``fn()`` on rank 0, then on the other ranks: for work that writes a
    shared file (a dataset's roidb cache, the resized-image cache), which the
    others then read."""
    if mesh is None:
        return fn()
    if mesh.rank == 0:
        out = fn()
        barrier(mesh)
        return out
    barrier(mesh)
    return fn()


# -- the launcher --------------------------------------------------------------

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_for_rank(n, device) -> Mesh:
    """The mesh of a rank the launcher started; on a card, the kernel
    library is built by rank 0 before the others load it (one nvcc run, not
    one a rank)."""
    mesh = make_mesh(n, None if device == "cuda" else device)
    if mesh.device.type == "cuda":
        from frcnn_tpu_torch.ops.cuda import build

        rank0_first(build.library, mesh)
    return mesh


def _run_rank(rank, n, backend, device, init_method, timeout_s, fn, args):
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: no CUDA device")
        # before anything touches CUDA: the kernels launch on the current card
        torch.cuda.set_device(rank % torch.cuda.device_count())
    elif backend == "nccl":
        raise ValueError("the nccl backend needs device='cuda'")
    else:
        # n ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        return fn(_mesh_for_rank(n, device), *args)
    finally:
        dist.destroy_process_group()


def _worker(rank, n, backend, device, init_method, timeout_s, fn, args, out_dir):
    out = _run_rank(rank, n, backend, device, init_method, timeout_s, fn, args)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn, n: int, backend: str, *args, device: str = "cuda",
          timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(mesh, *args)`` on ``n`` ranks over ``backend`` ("nccl" or
    "gloo") and return each rank's result (picklable) in rank order.

    ``device``: "cuda" (rank r on ``cuda:r % device_count``) or "cpu" (gloo
    only).  The ranks meet on a free port of 127.0.0.1, ``timeout_s`` bounds
    the rendezvous and every collective, and a rank that raises fails the
    run with that rank's traceback (``torch.multiprocessing``'s
    ``ProcessRaisedException``).  ``fn`` and ``args`` are pickled: ``fn``
    must be importable by name.  Where ``WORLD_SIZE`` is set (``torchrun``),
    this process is one rank of that world: ``fn`` runs here and the
    results are gathered from every rank."""
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    if os.environ.get("WORLD_SIZE"):
        world = int(os.environ["WORLD_SIZE"])
        if world != n:
            raise ValueError(f"torchrun started {world} ranks, the run asks for {n}")
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        if device == "cuda":
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(backend, init_method="env://",
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            mesh = _mesh_for_rank(n, device)
            return gather_rows([fn(mesh, *args)], mesh)
        finally:
            dist.destroy_process_group()
    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(prefix="frcnn_spawn_")
    try:
        mp.start_processes(_worker, nprocs=n, join=True, start_method="spawn",
                           args=(n, backend, device, f"tcp://127.0.0.1:{_free_port()}",
                                 timeout_s, fn, args, out_dir))
        results = []
        for rank in range(n):
            with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
