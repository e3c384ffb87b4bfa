"""frcnn_tpu_torch — the Faster R-CNN detector of ``frcnn_tpu`` in PyTorch,
with hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

The JAX package ``frcnn_tpu`` is the reference this package is held
against; module names mirror it so each counterpart is easy to find.  This
package imports torch and never jax (``import frcnn_tpu`` pulls jax in).

Devices: the entry points (``engine.serve.Detector``,
``engine.train.SolverWrapper``) move the model to the card (``cuda:0``) and
run there unless the caller passes ``device``; without a card they raise
rather than run on the CPU.  ``device="cpu"`` is the explicit request the
CPU tests make.  A kernel wrapper takes its plain twin only for a tensor
that lies on the CPU; on a CUDA tensor it launches its kernel or raises.
"""

__version__ = "0.1.0"

from frcnn_tpu_torch.config import cfg, default_config, cfg_from_file, cfg_from_list  # noqa: E402,F401
