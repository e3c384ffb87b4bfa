"""Named spans of the port on the profiler's clock.

``span(name)`` marks a layer boundary of serving or training as a
``torch.profiler`` range, so that it lands in the same trace, on the same
clock, as the CUDA runtime calls and the device's kernels and copies: every
idle gap of the device can be put down to the port's own span that was open
at the time.  While a profiler is recording, ``span`` returns
``torch.profiler.record_function(name)``; otherwise it returns one shared
``contextlib.nullcontext()``, and a span costs one read of the profiler's
process-wide flag.  There is no switch and no exporter of its own: the
spans are written wherever a ``torch.profiler`` session writes its trace.

How an operator sees them:

* serving: wrap the calls in a ``torch.profiler.profile`` session of your
  own (``activities=[CPU, CUDA]``) and export it
  (``prof.export_chrome_trace``);
* training: ``--set DEVICE.PROFILE_DIR <dir>`` (with PROFILE_START and
  PROFILE_STEPS) writes ``<dir>/trace_iter_<start>.json`` with the spans of
  every thread, the data layer's prefetch thread included.

Nesting gives the parent: each thread holds one request or step at a time.
The names, outermost first:

=========================== ================================================
``frcnn.serve.detect_blobs`` ``Detector.detect_blobs``, the whole call
``frcnn.serve.call``         ``Detector.__call__``, the whole call
``frcnn.serve.prep``         one image's resize and pad (``prep_image``)
``frcnn.serve.readback``     the detections' copy to the host in ``__call__``
``frcnn.graphs.lookup``      ``DetectGraphs``: the inputs as tensors, the
                             key, the weights' address check, the lookup
``frcnn.graphs.capture``     a key's first call: warm-up and capture
``frcnn.graphs.copy_in``     the batch's copy into the static inputs; for a
                             pageable host batch the chunked fill of its
                             page-locked block and each chunk's enqueued
                             copy to the card (``engine/graphs.stage``)
``frcnn.graphs.replay``      the graph's replay and the outputs' clones
``frcnn.train.data_wait``    ``train_model``'s wait for the next batch
``frcnn.train.step``         ``train_step``: the host's launches of a step
``frcnn.train.loss_readback`` the losses to floats (the step's sync)
``frcnn.data.forward``       ``RoIDataLayer.forward``, a batch made (in the
                             prefetch thread while training)
=========================== ================================================
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler`` range named ``name`` while a profiler records
    (in any thread), else the shared null context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
