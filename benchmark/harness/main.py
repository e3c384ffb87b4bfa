"""One run of one cell: set-up, the measured (or traced) window, the check
against the reference, the result line.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``, its configuration file, ``benchmark/traffic/<traffic>.json``,
``benchmark/limits/<cell>.json`` and ``benchmark/metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field

FORBIDDEN = ("jax", "jaxlib", "flax", "frcnn_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: str = ""
    units: dict = field(default_factory=dict)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])

    def read(path):
        with open(os.path.join(root, path)) as f:
            return json.load(f)

    return Cell(name=name, chips=w["chips"], config=read(conf["file"]),
                traffic=read(f"benchmark/traffic/{w['traffic']}.json"),
                limits=read(f"benchmark/limits/{name}.json"),
                end_to_end=[m["name"] for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m["name"] for m in bench["per_layer"] if _applies(m, name)],
                root=root,
                units={m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]})


def reader(root: str, metric: str):
    """``read(ctx)`` of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(root, "benchmark", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Spans:
    """Host spans that the traced window's wrappers record at a layer's
    boundary: seconds and calls by name, and the shape of each training batch."""

    seconds: dict = field(default_factory=dict)
    calls: dict = field(default_factory=dict)
    shapes: list = field(default_factory=list)

    def add(self, name: str, seconds: float):
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds
        self.calls[name] = self.calls.get(name, 0) + 1


@contextlib.contextmanager
def wrapped(spans: Spans, kind: str):
    """Time the layer boundary the cell's kind crosses on the host, from
    outside the program: ``engine.serve.prep_image`` (serving's host prep)
    or ``data.loader.RoIDataLayer.forward`` (training's data layer, in the
    prefetch thread); restored on exit."""
    import torch

    if kind == "serve":
        from frcnn_tpu_torch.engine import serve as owner
        attr = "prep_image"
    else:
        from frcnn_tpu_torch.data.loader import RoIDataLayer as owner
        attr = "forward"
    inner = getattr(owner, attr)

    def timed(*args, **kwargs):
        with torch.profiler.record_function(f"benchmark.{attr}"):
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            spans.add(attr, time.perf_counter() - t0)
        if kind == "train":
            b, h, w = out["data"].shape[:3]
            spans.shapes.append((b, (h, w)))
        return out

    setattr(owner, attr, timed)
    try:
        yield
    finally:
        setattr(owner, attr, inner)


@dataclass
class Context:
    """What a per-layer reader reads."""

    kind: str
    platform: str
    trace: object
    spans: Spans
    batches: list
    flops_per_image: dict

    def flops(self) -> float:
        return sum(b * self.flops_per_image[tuple(sorted(bk))] for b, bk in self.batches)


def count_flops(cell: Cell, kind: str, c: dict, batches) -> dict:
    from benchmark.reference.flops import detect_flops, train_flops

    fn = detect_flops if kind == "serve" else train_flops
    out = {}
    for _, bk in batches:
        key = tuple(sorted(bk))
        if key not in out:
            out[key] = fn(cell.config["net"], cell.config["num_classes"], c, tuple(bk))
    return out


def make_runner(cell: Cell, seed: int, device, workdir=None):
    from benchmark.harness.serve import ServeCell
    from benchmark.harness.train import TrainCell

    if cell.traffic["kind"] == "serve":
        return ServeCell(cell, seed, device)
    return TrainCell(cell, seed, device, workdir)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
             workdir=None, log=None) -> dict:
    """One run → the result object (without the import guard)."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    runner = make_runner(cell, seed, dev, workdir)
    runner.setup()
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    units = cell.units
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from benchmark.harness.trace import from_profiler

        spans = Spans()
        runner.spans = spans
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with wrapped(spans, runner.kind), profile(activities=acts) as prof:
            with record_function("benchmark.window"):
                recs = runner.window(0.0, count=cell.traffic["trace_count"])
        tr = from_profiler(prof, "benchmark.window")
        batches = runner.batches(recs)
        ctx = Context(runner.kind, "gpu" if cuda else dev.type, tr, spans, batches,
                      count_flops(cell, runner.kind, runner.c, batches))
        for name in cell.per_layer:
            v = reader(cell.root, name)(ctx)
            if v is not None:
                result["metrics"][name] = {"value": v, "unit": units[name]}
            else:
                log(f"per-layer metric {name}: nothing to read in this run")
    else:
        recs = runner.window(seconds)
        e2e = runner.end_to_end(recs)
        e2e["setup_s"] = setup_s
        for name in cell.end_to_end:
            result["metrics"][name] = {"value": e2e[name], "unit": units[name]}
    result["attempted"] = sum(r[0] for r in recs) if runner.kind == "train" else len(recs)
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": cell.chips,
                   "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0}
    result["device"] = device_info
    if trace:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_by_host()}
    _log_counts(runner, log)
    runner.free()
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    from benchmark.harness.check import judge

    readings = runner.readings(recs)
    log("readings " + json.dumps(readings, sort_keys=True))
    correct, checks = judge(readings, cell.limits)
    result["correct"] = bool(correct)
    result["checks"] = checks
    return result


def _log_counts(runner, log):
    """The program's own counters, on earlier lines: graph captures and
    replays per key, kernel launches per key, the host libraries."""
    det = getattr(runner, "detector", None)
    graphs = getattr(det, "graphs", None)
    if graphs is not None:
        log("graphs " + json.dumps({str(k): {"captures": graphs.captures[k],
                                             "replays": graphs.replays[k],
                                             "launches": dict(graphs.launches[k])}
                                         for k in graphs.captures}, default=str))
    if runner.kind == "train":
        from frcnn_tpu_torch.native import data_prep

        log(f"train data: TRAIN.IMAGE_CACHE {runner.c['TRAIN.IMAGE_CACHE']}, the reader serves "
            f"decoded images from memory; native prep library (opencv4) "
            f"{'found' if data_prep.have_native() else 'not found'}")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv, t0: float, root: str) -> int:
    p = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(root, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t0)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules loaded that the run must not load: {found}", file=sys.stderr)
        return 4
    for name, chk in result["checks"].items():
        print(f"check {name} {chk['value']!r} limit {chk['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
