"""Run one cell of the benchmark of ``frcnn_tpu_torch`` once, on this
machine's CUDA device:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (JSON); the numbers the check compared, each beside its limit, are
the last lines of standard error.  Exits non-zero, with no result, where
there is no CUDA device for the cell, or where jax, jaxlib, flax or the
JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    # kernel caches at fixed paths inside the checkout: only a checkout's
    # first run builds (the port's nvcc and g++ libraries go to
    # frcnn_tpu_torch/_build/ by themselves)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, ".bench_cache", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, ".bench_cache", "triton"))
    sys.path.insert(0, ROOT)
    from benchmark.harness.main import main

    sys.exit(main(sys.argv[1:], T0, ROOT))
