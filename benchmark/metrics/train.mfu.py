"""mfu of the traced train window (``benchmark/harness/readers.py``)."""

from benchmark.harness.readers import mfu as read  # noqa: F401
