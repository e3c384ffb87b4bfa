"""K6's roofline share in the traced serve window, at the shapes of the cell
this metric lists (``benchmark/harness/k6_roofline.py``)."""

import os

from benchmark.harness.k6_roofline import k6_roofline

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def read(ctx):
    return k6_roofline(ctx, ROOT, "k6_roofline.serve")
