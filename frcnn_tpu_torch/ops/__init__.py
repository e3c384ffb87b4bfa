"""Detection ops: boxes, anchors, NMS, RoIAlign; kernels under ``ops.cuda``."""
