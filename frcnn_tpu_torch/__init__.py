"""frcnn_tpu_torch — the Faster R-CNN detector of ``frcnn_tpu`` in PyTorch,
with hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

The JAX package ``frcnn_tpu`` is the reference this package is held
against; module names mirror it so each counterpart is easy to find.  This
package imports torch and never jax (``import frcnn_tpu`` pulls jax in).
"""

__version__ = "0.1.0"

from frcnn_tpu_torch.config import cfg, default_config, cfg_from_file, cfg_from_list  # noqa: E402,F401
