from frcnn_tpu_torch.models.network import FasterRCNN, build_model  # noqa: F401
