"""The port's native host libraries (C++ through ctypes, built with ``g++``
at first use): ``host_ops`` (greedy NMS and pairwise IoU, numpy fallbacks)
and ``data_prep`` (the threaded decode, flip, resize and pad of a batch)."""

from frcnn_tpu_torch.native.host_ops import bbox_overlaps_cpu, have_native, nms_cpu  # noqa: F401
