"""K3's roofline share in the traced train window (``benchmark/harness/readers.py``)."""

from benchmark.harness.readers import k3_roofline as read  # noqa: F401
