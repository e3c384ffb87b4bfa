"""Host milliseconds a request inside the program: the ``frcnn.serve.detect_blobs``
spans of the traced window (``Detector.detect_blobs``: the graph lookup,
the copy-in, the replay) summed / their count (``benchmark/harness/spans.py``)."""

from benchmark.harness.spans import REQUEST, span_ms_per_request


def read(ctx):
    return span_ms_per_request(ctx, REQUEST)
