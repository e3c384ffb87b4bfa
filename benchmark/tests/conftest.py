"""The benchmark's CPU tests: ``python -m pytest benchmark/tests`` from the
root of the repository.  They import the port (``frcnn_tpu_torch``) and the
benchmark, never jax."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

torch.set_num_threads(2)    # several workers share the CPU
