"""Serving as captured CUDA graphs: the port's counterpart of the JAX
engine's ``jax.jit(detect)`` (``frcnn_tpu/engine/serve.py:41``), which
compiles the whole detector once per input shape and replays it.

``DetectGraphs`` captures ``model.detect`` once per key and replays it.
The key is (B, bh, bw, input dtype, max_per_image): the shapes and the
static argument ``jax.jit`` keys ``detect`` on; the model is fixed per
executor.  A key's first call allocates static input buffers (outside the
graphs' pool), runs ``detect`` eagerly on a side stream (the kernels are
built, their attributes set, cuDNN and cuBLAS pick their workspaces), then
captures one ``detect`` of the static inputs under inference mode.  Every
call copies the batch into the static inputs, replays, and returns clones
of (dets, valid), made on the same stream before anything else is
enqueued.

The copy-in (``_copy_in``) takes its route from the input.  A batch on the
device, a page-locked host batch, or any batch of an executor on the CPU is
copied straight into the static inputs (a host batch ``non_blocking``).  A
pageable host batch on a card, every request a server receives as numpy, is
staged (``stage``): the host copies it into a page-locked block, and as soon
as each chunk of ``STAGE_CHUNK_BYTES`` is in, enqueues that chunk's copy to
the card on the current stream, so chunk i's DMA runs while the host fills
chunk i+1, and no pageable copy (a driver's staging copy that blocks the
host, at a rate set by the host's state) is left.  The host's copy is
``native/stage_fill``'s: the calling thread and a pool of helpers claim
small pieces in order, so a helper that is slow to wake holds up nothing,
where torch's CPU copy gives each of its threads a fixed share and waits
for the slowest.  The static inputs are one device buffer laid out as the
block (``stage_plan``): the batch, then im_info, which rides in the last
chunk.  One block a bucket and dtype (bh, bw, dtype), shared by its keys
and grown to the largest B at that key's first call; sharing is safe
because ``Detector.__call__`` makes one group a bucket.  A CUDA event
recorded after a block's last chunk guards its reuse: the host waits on it
before it writes the block again.  ``staged[key]`` counts the calls that
took the staged route, ``stage_waits[key]`` those whose event was not done
when the fill began.

Memory: the graphs of one executor share one pool.  That is safe because
replays are ordered on one stream, the static inputs live outside the
pool, and each replay's outputs are cloned before the next replay.
The copy-in runs on the same stream, so it follows every earlier replay
that reads the static inputs.
``Detector.__call__`` keeps every bucket group's outputs pending until it
reads them back: without the clone, a later replay of the same key would
overwrite an earlier group's detections.  A graph of another key reuses
only the pool's intermediates, which no replay reads after it ends, never
a graph's static outputs, which stay allocated.

A graph holds raw addresses: those of the parameters and buffers (the
kernels take ``data_ptr()``s), of the model's cached anchors and device
constants (``ops/constants.py``), of its static tensors and its pool.
Weights copied in place (``load_state_dict``, ``copy_``) reach the next
replay.  Anything that rebinds a parameter or buffer (``.to`` another dtype
or device, ``.data =``, ``load_state_dict(assign=True)``) or replaces
``model.config`` drops every graph, and the next call captures anew.  An
edit of the config object in place, or a submodule replaced, is not seen:
build a new model, or a new executor.

Launch counts: the kernel wrappers count when Python calls them
(``ops/cuda/build.LAUNCH_COUNTS``): at the eager warm-up and at the capture,
never at a replay.  ``launches[key]`` keeps each key's capture-time counts,
the kernels one replay launches; ``replays[key]`` counts the replays and
``captures[key]`` the captures.

A capture that fails raises, naming the key and the failing line; nothing
retries eagerly.

Under a profiler each call records the spans ``frcnn.graphs.lookup``,
``frcnn.graphs.capture`` (a key's first call), ``frcnn.graphs.copy_in`` and
``frcnn.graphs.replay`` (``utils/trace.py``).
"""

from __future__ import annotations

import collections
import os
import time
import traceback

import torch

from frcnn_tpu_torch.native import stage_fill
from frcnn_tpu_torch.ops.cuda import build
from frcnn_tpu_torch.utils.trace import span

_TORCH = os.path.dirname(os.path.abspath(torch.__file__))
_streams: dict = {}


def _side_stream(device: torch.device):
    """One stream a device for every warm-up and capture, as
    ``torch.cuda.graph``'s default capture stream: captures that share a
    pool share their stream."""
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


class CUDAGraph:
    """One ``torch.cuda.CUDAGraph`` behind the calls ``DetectGraphs`` makes:
    ``new_pool``, ``warm_up(fn)``, ``capture(fn, pool)`` → fn's outputs,
    whose memory the replays rewrite, and ``replay()``.  A stand-in with the
    same calls runs the executor without a card."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()

    @staticmethod
    def new_pool():
        return torch.cuda.graph_pool_handle()

    def warm_up(self, fn) -> None:
        stream = _side_stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream(self.device).wait_stream(stream)

    def capture(self, fn, pool):
        """Capture ``fn()`` on the side stream ("thread_local": a call this
        thread must not make under capture fails it; other threads' calls do
        not).  If ``fn`` raises, its error is the one raised: the capture
        is ended first and whatever ending it reports is dropped."""
        stream = _side_stream(self.device)
        torch.cuda.synchronize(self.device)
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass
                raise
            self.graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        return out

    def replay(self) -> None:
        self.graph.replay()


def _failing_site(exc: BaseException) -> str:
    """The innermost line of ``exc``'s traceback outside PyTorch's own
    files and dispatch modes: the call at which the capture failed."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if not f.filename.startswith(_TORCH) and f.name != "__torch_dispatch__"]
    return f"{frames[-1].filename}:{frames[-1].lineno} ({frames[-1].line})" if frames else "?"


# Bytes of a pageable host batch staged at a time: each chunk's copy to the
# card runs while the host fills the next (the sweep: PERF.md §6, copy-in)
STAGE_CHUNK_BYTES = 4 << 20
# im_info's place after the batch, in a block and in the static inputs
STAGE_ALIGN = 512


def stage_plan(data_bytes: int, info_bytes: int):
    """The staged layout of a batch of ``data_bytes`` and its im_info of
    ``info_bytes``, in a page-locked block and in the static inputs alike →
    (chunks, info_offset, total): the batch at byte 0, im_info at
    ``info_offset`` (the next multiple of ``STAGE_ALIGN``), ``total`` bytes;
    ``chunks`` the (start, stop) byte ranges copied in turn, each
    ``STAGE_CHUNK_BYTES`` of the batch but the last, which holds the rest
    of the batch and runs on to ``total``."""
    info_offset = -(-data_bytes // STAGE_ALIGN) * STAGE_ALIGN
    total = info_offset + info_bytes
    chunks = [(a, min(a + STAGE_CHUNK_BYTES, data_bytes))
              for a in range(0, data_bytes, STAGE_CHUNK_BYTES)]
    chunks[-1] = (chunks[-1][0], total)
    return chunks, info_offset, total


def stage(dst, block, data, im_info) -> None:
    """Copy the host tensors ``data`` and ``im_info`` (float32) through
    ``block`` (bytes, page-locked) into ``dst`` (the static inputs' bytes)
    as ``stage_plan`` lays them out: the batch filled into the block by the
    calling thread and the helpers of ``native/stage_fill``, each chunk's
    ``non_blocking`` copy enqueued on the current stream once its bytes are
    in, im_info written with the last."""
    src = data.reshape(-1).view(torch.uint8)
    info = im_info.reshape(-1).view(torch.uint8)
    chunks, info_offset, total = stage_plan(src.numel(), info.numel())
    with stage_fill.filling(block, src) as fill:
        for start, stop in chunks:
            fill(stop)
            if stop == total:
                block[info_offset:total].copy_(info)
            dst[start:stop].copy_(block[start:stop], non_blocking=True)


class DetectGraphs:
    """``model.detect`` on ``device`` replayed from one captured graph per
    key (module docstring).  ``graph`` is the graph class (``CUDAGraph``; a
    stand-in in the tests).  Called with data (B, bh, bw, 3) and im_info
    (B, 3), numpy or tensors → (dets (B, D, 6), valid (B, D)) on the device,
    fresh tensors of their own."""

    def __init__(self, model, max_per_image: int, device, graph=CUDAGraph):
        self.model = model
        self.max_per_image = max_per_image
        self.device = torch.device(device)
        self.graph = graph
        self.pool = None
        self.launches: dict = {}
        self.replays: collections.Counter = collections.Counter()
        self.captures: collections.Counter = collections.Counter()
        self.staged: collections.Counter = collections.Counter()
        self.stage_waits: collections.Counter = collections.Counter()
        self.capture_seconds: dict = {}
        self._entries: dict = {}      # key -> (graph, static inputs, outputs)
        self._blocks: dict = {}       # (bh, bw, dtype) -> (page-locked block, its event)
        self._slots: list = []
        self._fingerprint = None

    def _addresses(self) -> tuple:
        """The config's identity and every parameter's and buffer's data
        address, through the dicts the modules held at the first capture."""
        ptrs = [id(self.model.config)]
        for d, name in self._slots:
            t = d.get(name)
            ptrs.append(None if t is None else t.data_ptr())
        return tuple(ptrs)

    def _static_inputs(self, data):
        """(bytes, data, im_info) on the device: one buffer in ``stage_plan``'s
        layout for ``data``'s shape and dtype, and its two views."""
        data_bytes = data.numel() * data.element_size()
        _, info_offset, total = stage_plan(data_bytes, data.shape[0] * 3 * 4)
        buf = torch.empty(total, dtype=torch.uint8, device=self.device)
        return (buf, buf[:data_bytes].view(data.dtype).view(data.shape),
                buf[info_offset:].view(torch.float32).view(data.shape[0], 3))

    def _copy_in(self, key, static, data, im_info) -> None:
        """The batch into the static inputs, by the route its device and
        page-locking give (module docstring)."""
        buf, static_data, static_info = static
        with span("frcnn.graphs.copy_in"):
            if self.device.type == "cuda" and data.device.type == "cpu" and not data.is_pinned():
                self._stage(key, buf, data, im_info)
            else:
                static_data.copy_(data, non_blocking=True)
                static_info.copy_(im_info, non_blocking=True)

    def _stage(self, key, buf, data, im_info) -> None:
        """``stage`` through the block of the batch's bucket and dtype, made
        (or grown) here when it is smaller than the batch, after waiting on
        the event of the block's last use."""
        bucket = (*data.shape[1:3], data.dtype)
        need = stage_plan(data.numel() * data.element_size(), im_info.numel() * 4)[2]
        block, done = self._blocks.get(bucket, (None, None))
        if block is None or block.numel() < need:
            block, done = torch.empty(need, dtype=torch.uint8, pin_memory=True), torch.cuda.Event()
            self._blocks[bucket] = (block, done)
        elif not done.query():
            self.stage_waits[key] += 1
            done.synchronize()
        stage(buf, block, data, im_info)
        done.record(torch.cuda.current_stream(self.device))
        self.staged[key] += 1

    def _capture(self, key, data, im_info):
        if not self._entries:
            self._slots = [(d, name) for m in self.model.modules()
                           for d in (m._parameters, m._buffers) for name in d]
        t0 = time.perf_counter()
        static = self._static_inputs(data)
        self._copy_in(key, static, data, im_info)
        static_data, static_info = static[1:]

        def run():
            return self.model.detect(static_data, static_info, self.max_per_image)

        graph = self.graph(self.device)
        if self.pool is None:
            self.pool = graph.new_pool()
        before = collections.Counter(build.LAUNCH_COUNTS)
        try:
            graph.warm_up(run)
            warm = collections.Counter(build.LAUNCH_COUNTS)
            out = graph.capture(run, self.pool)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of detect for key {key} (B, bh, bw, "
                               f"dtype, max_per_image) failed at {_failing_site(e)}: "
                               f"{type(e).__name__}: {e}") from e
        self.launches[key] = dict(collections.Counter(build.LAUNCH_COUNTS) - warm)
        if self.launches[key] != dict(warm - before):
            raise RuntimeError(f"key {key}: the capture called the kernels "
                               f"{self.launches[key]}, the eager warm-up {dict(warm - before)}")
        self._entries[key] = (graph, static, tuple(out))
        self.captures[key] += 1
        self.capture_seconds[key] = time.perf_counter() - t0
        self._fingerprint = self._addresses()
        return self._entries[key]

    @torch.inference_mode()
    def __call__(self, data, im_info):
        with span("frcnn.graphs.lookup"):
            data = torch.as_tensor(data)
            im_info = torch.as_tensor(im_info, dtype=torch.float32)
            key = (*data.shape[:3], data.dtype, self.max_per_image)
            if self._entries and self._addresses() != self._fingerprint:
                # a parameter or buffer rebound, or the config replaced: drop
                # every graph and the pool
                self._entries.clear()
                self.pool = None
            entry = self._entries.get(key)
        if entry is None:
            with span("frcnn.graphs.capture"):
                graph, _, out = self._capture(key, data, im_info)
        else:
            graph, static, out = entry
            self._copy_in(key, static, data, im_info)
        with span("frcnn.graphs.replay"):
            graph.replay()
            self.replays[key] += 1
            return tuple(t.clone() for t in out)
