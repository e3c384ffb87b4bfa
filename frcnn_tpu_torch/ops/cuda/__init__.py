"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

K1 ``nms_kernel`` (batched greedy NMS), K2/K2b and K6/K6b
``roi_align_kernel`` (RoIAlign forward and backward, one level and the FPN
pyramid), K3 ``fused_block`` (fused stride-1
bottleneck), K4 ``overlap_kernel`` (anchor-overlap statistics), K5
``select_kernel`` (threshold top-k), ``bn_epilogue`` (frozen BN, the
residual and the ReLU after an unfused bottleneck's convolutions; no TPU
counterpart).  Sources live in
``frcnn_tpu_torch/csrc``; ``build`` compiles them at first use.  Importing
these modules needs neither a card nor ``nvcc``.
"""
