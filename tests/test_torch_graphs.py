"""Serving as captured CUDA graphs (``frcnn_tpu_torch/engine/graphs.py``),
on the CPU.

(a) ``model.detect`` is capture-safe: after one eager call (the executor's
warm-up), a second call dispatches no op that reads a device tensor back to
the host or makes a tensor from host values (on the card a synchronous copy:
both fail a capture), for every serving family at a small size.
(b) The executor's bookkeeping through a stand-in for the graph, which
records the captured function and, like a CUDA graph, computes into the
captured outputs only at a replay, refusing a host read at capture as CUDA
does; the staged copy-in's byte plan and fill, and the straight copy of an
executor on the CPU.  (c) Through that stand-in, a two-bucket request of mixed sizes gives
the JAX ``Detector``'s detections.  (d) ``Detector(device="cpu")`` never
builds a graph.  (e) The FPN's device counters: valid rois a level and
valid proposals, added in place by ``detect`` (so by a replay), read and
zeroed by ``Detector.counters``; no other serving family's ``detect``
writes any model state, so no other graph gains an op.  The card's own
graphs: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 51."""

import collections
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from frcnn_tpu import cfg_from_list as jax_cfg_from_list
from frcnn_tpu import default_config as jax_default_config
from frcnn_tpu.engine.serve import Detector as JaxDetector
from frcnn_tpu.models import build_model as jax_build_model
from frcnn_tpu.utils.weight_convert import convert_detector
from frcnn_tpu_torch import cfg_from_list, default_config
from frcnn_tpu_torch.engine import graphs as graphs_mod
from frcnn_tpu_torch.engine import serve
from frcnn_tpu_torch.engine.graphs import DetectGraphs
from frcnn_tpu_torch.engine.serve import Detector
from frcnn_tpu_torch.models.backbones import VGG16
from frcnn_tpu_torch.models.fpn import init_reference_
from frcnn_tpu_torch.models.network import FasterRCNN, build_model, init_random_
from frcnn_tpu_torch.ops.cuda import build
from tests.test_pipeline_parity import (NUM_CLASSES, _assert_det_sets_match,
                                        _detector_state_dict)

# ops that read a device tensor back to the host (a capture refuses the
# wait), or make a tensor from host values (on the card a copy that waits)
HOST_OPS = ("_local_scalar_dense", "item", "is_nonzero", "nonzero", "masked_select",
            "unique", "lift_fresh", "equal")

SMALL = ["TEST.SCALES", "(128,)", "TEST.MAX_SIZE", "192", "TEST.RPN_PRE_NMS_TOP_N", "400",
         "TEST.RPN_POST_NMS_TOP_N", "32", "DEVICE.BUCKETS", "((128, 192),)",
         "TEST.SCORE_THRESH", "0.0"]


class HostOps(TorchDispatchMode):
    """Records every dispatched op named in ``HOST_OPS``; with ``refuse``
    raises at the first, as CUDA refuses a host read under capture."""

    def __init__(self, refuse: bool = False):
        super().__init__()
        self.refuse, self.hits = refuse, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name().split("::")[-1]
        if any(name.startswith(op) for op in HOST_OPS):
            if self.refuse:
                raise RuntimeError(f"operation not permitted when stream is capturing: {name}")
            self.hits.append(name)
        return func(*args, **(kwargs or {}))


class StandInGraph:
    """The graph calls ``DetectGraphs`` makes, without a card: ``capture``
    runs the function once under ``HostOps(refuse=True)`` and keeps it and
    its outputs, which it fills with NaN (a captured graph computes nothing
    until replayed); ``replay`` runs the function again and copies its
    results into those outputs, calling no kernel wrapper's count (a replay
    calls no Python)."""

    made: list = []

    def __init__(self, device):
        self.fn, self.out, self.pool, self.replayed = None, None, None, 0
        StandInGraph.made.append(self)

    @staticmethod
    def new_pool():
        return object()

    def warm_up(self, fn):
        fn()

    def capture(self, fn, pool):
        with HostOps(refuse=True):
            out = fn()
        self.fn, self.pool = fn, pool
        self.out = tuple(t.fill_(float("nan")) if t.is_floating_point() else t.zero_()
                         for t in out)
        return self.out

    def replay(self):
        counts = collections.Counter(build.LAUNCH_COUNTS)
        for dst, src in zip(self.out, self.fn()):
            dst.copy_(src)
        build.LAUNCH_COUNTS.clear()
        build.LAUNCH_COUNTS.update(counts)
        self.replayed += 1


@pytest.fixture(autouse=True)
def fresh_stand_ins():
    StandInGraph.made.clear()
    build.reset_launch_counts()
    yield


# ---------------------------------------------------------------------------
# (a) the capture-safety scan
# ---------------------------------------------------------------------------

# (net, classes, config) of every serving family, at 128x192
FAMILIES = [
    ("res50", 21, ()),
    ("res50_fpn", 21, ()),
    ("res50_fpn_gn", 21, ("RESNET.FIXED_BLOCKS", "0")),
    ("vgg16", 21, ()),
    ("mobile", 21, ("MOBILENET.DEPTH_MULTIPLIER", "0.25")),
    ("res50", 21, ("TEST.MODE", "top", "TEST.RPN_TOP_N", "64")),
    ("res50", 21, ("POOLING_MODE", "pool")),
    ("res50", 21, ("POOLING_MODE", "crop")),
    ("res101", 81, ("ANCHOR_SCALES", "(4, 8, 16, 32)")),       # the COCO recipe
]


def _family_model(net, classes, extra):
    cfg = cfg_from_list(default_config(), [*SMALL, *extra])
    if net == "vgg16":      # the 256-wide tail of tests/test_torch_vgg_mobile.py
        model = FasterRCNN(VGG16(tail_dim=256), classes, cfg)
    else:
        model = build_model(net, classes, cfg)
    init = init_reference_ if net.endswith("_gn") else init_random_
    init(model, torch.Generator().manual_seed(0))
    return model.eval()


def _batch(seed=0, b=2):
    rng = np.random.RandomState(seed)
    data = torch.from_numpy(rng.uniform(0, 255, (b, 128, 192, 3)).astype(np.float32))
    im_info = torch.tensor([[128.0, 192.0, 1.0], [100.0, 160.0, 1.0]][:b])
    return data, im_info


@pytest.mark.parametrize("net,classes,extra", FAMILIES,
                         ids=[f"{n}{''.join('-' + str(v) for v in e[1::2])}"
                              for n, _, e in FAMILIES])
def test_detect_reads_nothing_back_after_one_call(net, classes, extra):
    model = _family_model(net, classes, extra)
    data, im_info = _batch()
    with torch.inference_mode():
        want = model.detect(data, im_info, 100)         # the warm-up: caches filled
        scan = HostOps()
        with scan:
            got = model.detect(data, im_info, 100)
    assert scan.hits == [], f"{net} {extra}: host reads or host-made tensors {scan.hits}"
    assert all(torch.equal(w, g) for w, g in zip(want, got))


# ---------------------------------------------------------------------------
# (b) the executor's bookkeeping
# ---------------------------------------------------------------------------

class ToyModel(torch.nn.Module):
    """``detect`` of a toy: (data summed per image times a weight, in a (B,
    2, 6) dets, valid (B, 2)); each call counts ``kernel_calls`` launches of
    a pretend kernel as a wrapper would; with ``host_read`` it reads a value
    back (``.item()``), which a capture refuses."""

    def __init__(self, kernel_calls=2, host_read=False):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.ones(()))
        self.config = object()
        self.kernel_calls, self.host_read, self.calls = kernel_calls, host_read, 0

    def detect(self, data, im_info, max_per_image):
        self.calls += 1
        build.LAUNCH_COUNTS["toy"] += self.kernel_calls
        s = data.float().sum(dim=(1, 2, 3)) * self.weight + im_info[:, 0]
        if self.host_read:
            s = s + float(s[0].item() > 0)
        dets = s[:, None, None].expand(-1, 2, 6).contiguous()
        return dets, s[:, None].expand(-1, 2) > 0


def _toy_batch(b, value, h=4, w=6, dtype=torch.float32):
    return torch.full((b, h, w, 3), value, dtype=dtype), torch.ones((b, 3))


def test_one_capture_per_key_then_only_replays():
    model = ToyModel()
    graphs = DetectGraphs(model, 100, "cpu", graph=StandInGraph)
    for value in (1.0, 2.0, 3.0):
        dets, _ = graphs(*_toy_batch(2, value))
        assert torch.equal(dets, torch.full((2, 2, 6), 72.0 * value + 1.0))
    key = (2, 4, 6, torch.float32, 100)
    assert graphs.captures == {key: 1} and graphs.replays == {key: 3}
    assert len(StandInGraph.made) == 1 and StandInGraph.made[0].replayed == 3
    # the warm-up and the capture call detect; each replay reruns it in the stand-in
    assert model.calls == 2 + 3
    # uint8 input is a key of its own
    graphs(*_toy_batch(2, 1, dtype=torch.uint8))
    assert graphs.captures[(2, 4, 6, torch.uint8, 100)] == 1 and len(StandInGraph.made) == 2


def test_returned_outputs_are_copies_not_the_captured_buffers():
    graphs = DetectGraphs(ToyModel(), 100, "cpu", graph=StandInGraph)
    first = graphs(*_toy_batch(2, 1.0))
    second = graphs(*_toy_batch(2, 5.0))             # the same key, replayed again
    assert torch.equal(first[0], torch.full((2, 2, 6), 73.0))
    assert torch.equal(second[0], torch.full((2, 2, 6), 361.0))
    captured = StandInGraph.made[0].out
    for got, static in zip(first + second, captured * 2):
        assert got.data_ptr() != static.data_ptr()


def test_two_keys_replayed_in_reverse_order_give_their_own_results():
    graphs = DetectGraphs(ToyModel(), 100, "cpu", graph=StandInGraph)
    a, b = _toy_batch(3, 1.0), _toy_batch(2, 2.0, h=6, w=4)
    graphs(*a)
    graphs(*b)                                       # captured in the order a, b
    assert len({id(g.pool) for g in StandInGraph.made}) == 1      # one pool for both
    got_b, got_a = graphs(*b), graphs(*a)            # replayed b, a: both pending
    assert torch.equal(got_b[0], torch.full((2, 2, 6), 145.0))
    assert torch.equal(got_a[0], torch.full((3, 2, 6), 73.0))


def test_a_capture_error_propagates_with_no_eager_retry():
    model = ToyModel(host_read=True)
    graphs = DetectGraphs(model, 100, "cpu", graph=StandInGraph)
    with pytest.raises(RuntimeError, match=r"key \(2, 4, 6, torch.float32, 100\).*"
                                           r"test_torch_graphs.py.*item"):
        graphs(*_toy_batch(2, 1.0))
    assert model.calls == 2                          # the warm-up and the capture, no retry
    assert graphs.captures == {} and graphs.replays == {}
    with pytest.raises(RuntimeError, match="capture of detect"):
        graphs(*_toy_batch(2, 1.0))                  # captured again, refused again
    assert model.calls == 4


def test_capture_time_launch_counts_are_kept_per_key():
    graphs = DetectGraphs(ToyModel(kernel_calls=3), 100, "cpu", graph=StandInGraph)
    for b in (2, 2, 5, 2):
        graphs(*_toy_batch(b, 1.0))
    assert graphs.launches == {(2, 4, 6, torch.float32, 100): {"toy": 3},
                               (5, 4, 6, torch.float32, 100): {"toy": 3}}
    # the warm-up and the capture of each key; replays call no wrapper
    assert build.LAUNCH_COUNTS["toy"] == 2 * 2 * 3


def test_a_capture_whose_kernels_differ_from_the_warm_up_raises():
    model = ToyModel()
    plain = model.detect

    def detect(*args):
        model.kernel_calls = 2 if model.calls == 0 else 1     # the capture calls fewer
        return plain(*args)

    model.detect = detect
    with pytest.raises(RuntimeError, match="the capture called the kernels"):
        DetectGraphs(model, 100, "cpu", graph=StandInGraph)(*_toy_batch(2, 1.0))


def test_rebound_weights_drop_the_graphs_and_copied_weights_reach_the_replay():
    model = ToyModel()
    graphs = DetectGraphs(model, 100, "cpu", graph=StandInGraph)
    key = (2, 4, 6, torch.float32, 100)
    graphs(*_toy_batch(2, 1.0))
    model.load_state_dict({"weight": torch.tensor(2.0)})   # copied in place: same address
    assert torch.equal(graphs(*_toy_batch(2, 1.0))[0], torch.full((2, 2, 6), 145.0))
    assert graphs.captures[key] == 1
    model.weight.data = torch.tensor(3.0)                  # rebound
    assert torch.equal(graphs(*_toy_batch(2, 1.0))[0], torch.full((2, 2, 6), 217.0))
    assert graphs.captures[key] == 2 and len(StandInGraph.made) == 2
    model.config = object()                                # a new config
    graphs(*_toy_batch(2, 1.0))
    assert graphs.captures[key] == 3


# (B, bh, bw, dtype): both cells' buckets, the raw route's f32 at B 1, a batch
# smaller than one chunk, and odd sizes whose bytes divide neither the chunk
# nor STAGE_ALIGN
PLANS = [(8, 800, 1344, np.uint8), (8, 1344, 800, np.uint8), (8, 608, 1024, np.uint8),
         (1, 800, 1216, np.float32), (1, 128, 192, np.uint8), (3, 517, 771, np.uint8),
         (2, 7, 5, np.float32)]


@pytest.mark.parametrize("b,bh,bw,dtype", PLANS,
                         ids=[f"{b}x{h}x{w}-{np.dtype(t).name}" for b, h, w, t in PLANS])
def test_the_stage_plan_covers_the_batch_once_in_order_then_im_info(b, bh, bw, dtype):
    data_bytes, info_bytes = b * bh * bw * 3 * np.dtype(dtype).itemsize, b * 3 * 4
    chunks, info_offset, total = graphs_mod.stage_plan(data_bytes, info_bytes)
    step = graphs_mod.STAGE_CHUNK_BYTES
    assert info_offset % graphs_mod.STAGE_ALIGN == 0
    assert data_bytes <= info_offset < data_bytes + graphs_mod.STAGE_ALIGN
    assert total == info_offset + info_bytes
    assert len(chunks) == -(-data_bytes // step)
    assert [a for a, _ in chunks] == list(range(0, data_bytes, step))
    assert [a for a, _ in chunks[1:]] == [z for _, z in chunks[:-1]]   # no gap, no overlap
    assert all(z - a == step for a, z in chunks[:-1])
    assert chunks[-1][1] == total            # the rest of the batch and im_info, last
    assert 0 < data_bytes - chunks[-1][0] <= step


def test_a_staged_copy_lands_the_batch_and_im_info_bit_for_bit(monkeypatch):
    """``stage`` with ordinary CPU tensors for the block and the static
    inputs (on the card: page-locked and device memory), in chunks of 4 KB:
    every byte of the batch and of im_info where ``stage_plan`` puts them, a
    partial last chunk, and a non-contiguous source."""
    monkeypatch.setattr(graphs_mod, "STAGE_CHUNK_BYTES", 4096)
    rng = np.random.RandomState(0)
    for data in (torch.from_numpy(rng.randint(0, 256, (3, 17, 41, 3)).astype(np.uint8)),
                 torch.from_numpy(rng.standard_normal((2, 3, 23, 19)).astype(np.float32))
                 .permute(0, 2, 3, 1)):
        im_info = torch.from_numpy(rng.uniform(1, 900, (data.shape[0], 3)).astype(np.float32))
        data_bytes = data.numel() * data.element_size()
        chunks, info_offset, total = graphs_mod.stage_plan(data_bytes, im_info.numel() * 4)
        assert len(chunks) > 1 and data_bytes % 4096
        block = torch.zeros(total + 100, dtype=torch.uint8)
        dst = torch.zeros(total, dtype=torch.uint8)
        graphs_mod.stage(dst, block, data, im_info)
        assert torch.equal(dst[:data_bytes].view(data.dtype).view(data.shape), data)
        assert torch.equal(dst[info_offset:].view(torch.float32).view(-1, 3), im_info)


def test_a_cpu_executor_copies_straight_and_stages_nothing():
    graphs = DetectGraphs(ToyModel(), 100, "cpu", graph=StandInGraph)
    for b, value in ((2, 1.0), (2, 3.0), (5, 2.0)):
        dets, _ = graphs(*_toy_batch(b, value, dtype=torch.uint8))
        assert torch.equal(dets, torch.full((b, 2, 6), 72.0 * value + 1.0))
    assert graphs.staged == {} and graphs.stage_waits == {} and graphs._blocks == {}
    # the static inputs: one buffer in the staged layout, whichever the route
    _, (buf, data, info), _ = graphs._entries[(5, 4, 6, torch.uint8, 100)]
    assert data.data_ptr() == buf.data_ptr() and info.shape == (5, 3)
    assert info.data_ptr() - buf.data_ptr() == graphs_mod.stage_plan(5 * 72, 60)[1]


# bytes: none, one, about one piece of stage_fill.cc (256 KB) and many pieces
# with a partial last one
FILLS = [0, 1, (256 << 10) - 1, (256 << 10) + 1, 3 * (256 << 10) - 5, 2_500_001]


@pytest.mark.parametrize("n", FILLS)
def test_the_native_fill_has_every_prefix_in_when_its_wait_returns(n):
    """``stage_fill.filling`` on its pool of helpers: after each ``fill(upto)``
    bytes [0, upto) of the block equal the source's, waits past the end
    stop at it, the whole source is in when the block exits, and nothing
    after it is written."""
    from frcnn_tpu_torch.native import stage_fill

    src = torch.from_numpy(np.random.RandomState(n % 97).randint(0, 256, n).astype(np.uint8))
    block = torch.zeros(n + 4096, dtype=torch.uint8)
    with stage_fill.filling(block, src) as fill:
        for upto in sorted({0, n // 3, n // 3 + 1, n, n + 100}):
            fill(upto)
            assert torch.equal(block[:min(upto, n)], src[:min(upto, n)])
    assert torch.equal(block[:n], src) and not block[n:].any()


def test_native_fills_from_more_threads_than_cores_each_land_whole():
    """Fills of one pool from more Python threads than cores, each in turn
    (the pool takes one fill at a time) into its own block, some left at
    their first wait: every block ends equal to its source."""
    import sys
    import threading

    from frcnn_tpu_torch.native import stage_fill

    rng = np.random.RandomState(3)
    workers = 2 * (os.cpu_count() or 1) + 1
    sources = [torch.from_numpy(rng.randint(0, 256, 300_001 + 999 * i).astype(np.uint8))
               for i in range(3 * workers)]
    blocks = [torch.zeros(s.numel(), dtype=torch.uint8) for s in sources]

    def run(ids):
        for i in ids:
            with stage_fill.filling(blocks[i], sources[i]) as fill:
                fill(sources[i].numel() // 2 if i % 2 else 1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(range(k, len(sources), workers),))
                   for k in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert all(torch.equal(b, s) for b, s in zip(blocks, sources))
    for block, src in ((blocks[0][:10], sources[0]), (blocks[0], sources[0].float()),
                       (blocks[0], sources[0][::2])):
        with pytest.raises(ValueError):
            with stage_fill.filling(block, src):
                pass


def test_a_fill_with_no_helpers_is_the_callers_alone():
    from frcnn_tpu_torch.native import stage_fill

    stage_fill._pool()
    lib = stage_fill._lib
    pool = lib.frcnn_stage_pool(0)
    src = torch.from_numpy(np.arange(1_000_003, dtype=np.int64).astype(np.uint8))
    block = torch.zeros_like(src)
    assert lib.frcnn_stage_wait(pool, 10) == -1            # no fill open
    lib.frcnn_stage_begin(pool, block.data_ptr(), src.data_ptr(), src.numel())
    assert lib.frcnn_stage_wait(pool, 300_000) == 0
    assert torch.equal(block[:300_000], src[:300_000])
    assert lib.frcnn_stage_wait(pool, src.numel()) == 0 and torch.equal(block, src)
    assert lib.frcnn_stage_wait(pool, 1) == -1              # the last wait closed it


def test_the_fill_library_signatures_match_its_source():
    import re

    from frcnn_tpu_torch.native import build as native_build
    from frcnn_tpu_torch.native import stage_fill

    with open(os.path.join(native_build.NATIVE, "stage_fill.cc")) as f:
        text = f.read()
    text = text[text.index('extern "C" {'):]
    declared = {fn: len(params.split(",")) for fn, params in
                re.findall(r"^(?:int|void\*?) (frcnn_\w+)\(([^)]*)\)", text, re.M)}
    assert declared == {name: len(args) for name, (_, args) in stage_fill._SIGNATURES.items()}


def test_a_fill_whose_library_does_not_build_raises_and_is_retried(monkeypatch):
    from frcnn_tpu_torch.native import stage_fill

    def no_compiler(*args, **kwargs):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(stage_fill, "build_library", no_compiler)
    monkeypatch.setattr(stage_fill, "_lib", None)
    monkeypatch.setattr(stage_fill, "_pools", {})
    src = torch.arange(10, dtype=torch.uint8)
    for _ in range(2):
        with pytest.raises(FileNotFoundError):
            with stage_fill.filling(torch.zeros(10, dtype=torch.uint8), src):
                pass
    assert stage_fill._lib is None and stage_fill._pools == {}


# ---------------------------------------------------------------------------
# (c) a two-bucket request against the JAX Detector
# ---------------------------------------------------------------------------

TWO_BUCKETS = ["TEST.SCALES", "(128,)", "TEST.MAX_SIZE", "192",
               "TEST.RPN_PRE_NMS_TOP_N", "400", "TEST.RPN_POST_NMS_TOP_N", "32",
               "TPU.BUCKETS", "((128, 192), (192, 128))"]
MAX_PER_IMAGE = NUM_CLASSES * 32      # every per-class survivor


def _image(rng, h, w):
    """Low-frequency noise with flat rectangles (tests/test_torch_detect.py's
    images), at a size whose resize scale is 1."""
    base = rng.randint(0, 255, (h // 16 + 1, w // 16 + 1, 3)).astype(np.float32)
    t = torch.from_numpy(base).permute(2, 0, 1)[None]
    im = torch.nn.functional.interpolate(t, size=(h, w), mode="bilinear",
                                         align_corners=False)[0].permute(1, 2, 0).numpy()
    for _ in range(4):
        y, x = rng.randint(0, h - 40), rng.randint(0, w - 40)
        bh, bw = rng.randint(16, 40, 2)
        im[y:y + bh, x:x + bw] = rng.randint(0, 255, 3)
    return np.clip(im, 0, 255).astype(np.uint8)


def test_graphed_detector_serves_the_jax_detectors_results_over_two_buckets():
    sd = _detector_state_dict(np.random.RandomState(0))
    jmodel = jax_build_model("res50", NUM_CLASSES,
                             jax_cfg_from_list(jax_default_config(), TWO_BUCKETS))
    params = convert_detector({k: v.numpy() for k, v in sd.items()}, "res50")
    jdet = JaxDetector(jmodel, {"params": params}, max_per_image=MAX_PER_IMAGE)

    model = build_model("res50", NUM_CLASSES, cfg_from_list(default_config(), TWO_BUCKETS))
    model.load_state_dict(sd)
    det = Detector(model.eval(), max_per_image=MAX_PER_IMAGE, device="cpu")
    det.graphs = DetectGraphs(det.model, det.max_per_image, "cpu", graph=StandInGraph)
    rng = np.random.RandomState(11)
    ims = [_image(rng, h, w) for h, w in ((128, 192), (192, 128), (128, 160), (176, 128),
                                           (112, 192))]
    # landscape first, then the same request with the portrait images first:
    # the second replays the two keys in the reverse of their capture order
    for order in ([0, 1, 2, 3, 4], [1, 3, 0, 2, 4]):
        request = [ims[i] for i in order]
        for i, (w, g) in enumerate(zip(jdet(request), det(request))):
            assert g.shape[1] == 6 and np.isfinite(g).all()
            for j in range(1, NUM_CLASSES):
                _assert_det_sets_match(w[w[:, 5] == j][:, :5], g[g[:, 5] == j][:, :5],
                                       f"order {order} image {i} class {j}")
    keys = {(3, 128, 192, torch.float32, MAX_PER_IMAGE), (2, 192, 128, torch.float32,
                                                           MAX_PER_IMAGE)}
    assert set(det.graphs.captures) == keys and set(det.graphs.captures.values()) == {1}
    assert det.graphs.replays == {k: 2 for k in keys}


# ---------------------------------------------------------------------------
# (d) the CPU runs eagerly
# ---------------------------------------------------------------------------

def test_a_cpu_detector_never_builds_a_graph(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a graph executor was made for a CPU Detector")

    monkeypatch.setattr(serve, "DetectGraphs", refuse)
    model = _family_model("res50", 21, ())
    det = Detector(model, device="cpu")
    assert det.graphs is None
    rng = np.random.RandomState(3)
    results = det([rng.randint(0, 255, (128, 192, 3)).astype(np.uint8)])
    assert results[0].shape[1] == 6
    data, im_info = _batch()
    dets, valid = det.detect_blobs(data, im_info)
    assert dets.device.type == "cpu" and valid.shape == dets.shape[:2]


# ---------------------------------------------------------------------------
# (e) the FPN's device counters
# ---------------------------------------------------------------------------

# every level P2-P5 takes rois at 128x192 once the canonical roi is 24 px;
# the second image's 30x40 leaves it fewer valid proposals than slots
COUNTED = ("TEST.RPN_POST_NMS_TOP_N", "64", "FPN.ROI_CANONICAL_SCALE", "24")
PADDED_INFO = torch.tensor([[128.0, 192.0, 1.0], [30.0, 40.0, 1.0]])


class StateWrites(TorchDispatchMode):
    """Records every dispatched op that writes into one of ``storages``
    (the data pointers of a model's parameters and buffers)."""

    def __init__(self, storages):
        super().__init__()
        self.storages, self.hits = storages, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            t = args[i] if i < len(args) else kwargs.get(arg.name)
            if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() in self.storages:
                self.hits.append((func.name().split("::")[-1], t.untyped_storage().data_ptr()))
        return func(*args, **kwargs)


@pytest.mark.parametrize("net,classes,extra", [FAMILIES[i] for i in (0, 1, 8)],
                         ids=["res50", "res50_fpn", "res101-coco"])
def test_detect_writes_no_model_state_but_the_fpns_counters(net, classes, extra):
    model = _family_model(net, classes, extra)
    data, im_info = _batch()
    state = dict(model.named_parameters())
    state.update(model.named_buffers())
    storages = {t.untyped_storage().data_ptr(): name for name, t in state.items()}
    with torch.inference_mode():
        model.detect(data, im_info, 100)                # the warm-up: caches filled
        writes = StateWrites(set(storages))
        with writes:
            model.detect(data, im_info, 100)
    written = [(op, storages[ptr]) for op, ptr in writes.hits]
    if net.endswith("_fpn"):
        # the three in-place adds of ``FasterRCNNFPN._count``, nothing else
        assert written == [("index_add_", "roi_counts"), ("add_.Tensor", "roi_counts"),
                           ("add_.Tensor", "roi_counts")]
    else:
        assert written == [] and "roi_counts" not in storages.values()
        assert Detector(model, device="cpu").counters() == {}


def test_fpn_counters_are_the_valid_rois_a_level_and_the_valid_proposals():
    model = _family_model("res50_fpn", 21, COUNTED)
    data, _ = _batch()
    assert "roi_counts" not in model.state_dict()
    with torch.inference_mode():
        out = model.predict(data, PADDED_INFO)
    counts = model.read_counters()
    valid = out["roi_valid"]
    levels = model._assign_levels(out["rois"])
    assert (~valid).any() and (levels[~valid] == 2).all()      # padding sits at P2
    want = {f"rois_p{k}": int((levels[valid] == k).sum()) for k in (2, 3, 4, 5)}
    assert all(want.values())                                    # every level takes rois
    assert counts == {**want, "proposals": int(valid.sum()), "batches": 1}
    assert sum(counts[f"rois_p{k}"] for k in (2, 3, 4, 5)) == counts["proposals"]
    assert set(model.read_counters().values()) == {0}           # zeroed by the read


def test_fpn_counters_add_at_each_replay_and_reading_them_moves_no_detection():
    model = _family_model("res50_fpn", 21, COUNTED)
    det = Detector(model, device="cpu")
    det.graphs = DetectGraphs(det.model, det.max_per_image, "cpu", graph=StandInGraph)
    data, _ = _batch()
    first = det.detect_blobs(data, PADDED_INFO)          # warm-up, capture, replay
    assert det.counters()["batches"] == 3                # the stand-in runs detect thrice
    assert set(det.counters().values()) == {0}
    second = det.detect_blobs(data, PADDED_INFO)         # a replay, counters read before
    third = det.detect_blobs(data, PADDED_INFO)          # a replay, counters not read
    two = det.counters()
    assert two["batches"] == 2 and StandInGraph.made[0].replayed == 3
    with torch.inference_mode():
        model.predict(data, PADDED_INFO)
    single = model.read_counters()
    assert two == {k: 2 * v for k, v in single.items()}
    for got in (second, third):
        assert all(torch.equal(a, b) for a, b in zip(first, got))
