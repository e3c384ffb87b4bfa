"""The device's idle milliseconds a request while the program's own ``frcnn.``
spans are open (``benchmark/harness/spans.py``)."""

from benchmark.harness.spans import program_idle_ms as read  # noqa: F401
