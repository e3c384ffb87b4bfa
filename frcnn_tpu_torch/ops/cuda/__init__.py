"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

K1 ``nms_kernel`` (batched greedy NMS), K2 ``roi_align_kernel`` (RoIAlign
forward), K3 ``fused_block`` (fused stride-1 bottleneck).  Sources live in
``frcnn_tpu_torch/csrc``; ``build`` compiles them at first use.  Importing
these modules needs neither a card nor ``nvcc``.
"""
