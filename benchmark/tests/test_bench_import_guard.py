"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package
``frcnn_tpu``, compared by whole top-level module names (the port's name,
``frcnn_tpu_torch``, begins with the JAX package's).  Each cell's set-up,
window and check run in a fresh interpreter, at a tiny size on the CPU."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness.main import FORBIDDEN, forbidden_modules
from benchmark.tests.tiny import CELLS, ROOT

SCRIPT = """
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark.tests.tiny import tiny_cell
from benchmark.harness.main import run_cell, forbidden_modules
cell = tiny_cell({name!r})
run_cell(cell, 3, 0.2, {trace}, "cpu", time.perf_counter(), workdir={work!r}, log=lambda m: None)
print(json.dumps(sorted(sys.modules)))
"""


@pytest.mark.parametrize("name", CELLS)
def test_no_jax_in_a_run(name, tmp_path):
    code = SCRIPT.format(root=ROOT, name=name, trace=name.endswith("serve_raw"),
                         work=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(tmp_path), env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in modules}
    assert "frcnn_tpu_torch" in tops and "torch" in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


def test_the_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "frcnn_tpu_torch_extra", sys)
    assert "frcnn_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "frcnn_tpu.models", sys)
    assert "frcnn_tpu" in forbidden_modules()


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                          "--workload", CELLS[0], "--seed", "2147483659", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
