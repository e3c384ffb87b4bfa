"""mfu of the traced raw window (``benchmark/harness/readers.py``)."""

from benchmark.harness.readers import mfu as read  # noqa: F401
