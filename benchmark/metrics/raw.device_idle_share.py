"""idle_share of the traced raw window (``benchmark/harness/readers.py``)."""

from benchmark.harness.readers import idle_share as read  # noqa: F401
