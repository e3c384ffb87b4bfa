"""mfu of the traced serve window (``benchmark/harness/readers.py``)."""

from benchmark.harness.readers import mfu as read  # noqa: F401
