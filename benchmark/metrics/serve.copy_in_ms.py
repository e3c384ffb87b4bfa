"""Host milliseconds a request of the batch's copy into the graph's static
inputs: the ``frcnn.graphs.copy_in`` spans of the traced window summed / the
requests (``frcnn.serve.detect_blobs`` spans; ``benchmark/harness/spans.py``)."""

from benchmark.harness.spans import span_ms_per_request


def read(ctx):
    return span_ms_per_request(ctx, "frcnn.graphs.copy_in")
