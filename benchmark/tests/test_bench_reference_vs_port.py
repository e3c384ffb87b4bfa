"""The reference holds the port's plain path: at tiny sizes on the CPU, with
the configuration's compute type set to float32 (the port then runs its
plain twins in float32), every cell's check reads nought to rounding.  So
the reference redoes what the program does (the data layer's order, the
cache's views, the draws, the targets, the SGD groups), and only precision
separates the two on the card."""

import time

import pytest

from benchmark.harness.main import run_cell
from benchmark.tests.tiny import CELLS, tiny_cell


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_ports_f32_path(name, tmp_path):
    cell = tiny_cell(name)
    cell.config["cfg"]["DEVICE.DTYPE"] = "float32"
    readings = []
    cell.limits = {}
    run_cell(cell, 2**31 + 5, 0.5, False, "cpu", time.perf_counter(), workdir=str(tmp_path),
             log=lambda m: readings.append(m) if m.startswith("readings") else None)
    import json

    r = json.loads(readings[-1][len("readings "):])
    if "unmatched" in r:
        assert r["detections"] > 0
        assert r["unmatched"] == 0 and r["score_gap"] == 0 and r["box_gap"] == 0
    else:
        assert r["loss_gap"] < 1e-5 and r["grad_gap"] < 1e-5
        assert r["update_gap"] < 1e-3 and r["update_gap_median"] < 1e-4
