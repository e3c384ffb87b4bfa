"""Configuration: the same frozen dataclass tree, keys and defaults as
``frcnn_tpu/config.py``.

Differences from the JAX package:

  * the ``TPU`` section is ``DEVICE``; its knobs (buckets, padded sizes,
    compute dtype, sampling ratio) are device-neutral.  The YAML/``--set``
    loaders still accept ``TPU.*`` keys and route them here, so the
    ``experiments/cfgs/*.yml`` files load unchanged;
  * ``TPU.USE_PALLAS`` becomes ``DEVICE.USE_KERNELS``: True runs the
    hand-written CUDA kernels on CUDA tensors (and their plain twins on CPU
    tensors); False runs the plain PyTorch versions everywhere.  It never
    selects a fallback: a kernel that cannot run raises.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass(frozen=True)
class TrainConfig:
    LEARNING_RATE: float = 0.001
    MOMENTUM: float = 0.9
    WEIGHT_DECAY: float = 0.0001
    GAMMA: float = 0.1
    STEPSIZE: Tuple[int, ...] = (30000,)
    DISPLAY: int = 10
    DOUBLE_BIAS: bool = True
    BIAS_DECAY: bool = False
    USE_GT: bool = False
    ASPECT_GROUPING: bool = False
    SNAPSHOT_KEPT: int = 3
    SUMMARY_INTERVAL: int = 180
    SCALES: Tuple[int, ...] = (600,)
    MAX_SIZE: int = 1000
    IMS_PER_BATCH: int = 1
    SNAPSHOT_ITERS: int = 5000
    SNAPSHOT_PREFIX: str = "default"
    BATCH_SIZE: int = 128
    FG_FRACTION: float = 0.25
    FG_THRESH: float = 0.5
    BG_THRESH_HI: float = 0.5
    BG_THRESH_LO: float = 0.0
    USE_FLIPPED: bool = True
    BBOX_REG: bool = True
    BBOX_THRESH: float = 0.5
    BBOX_NORMALIZE_TARGETS: bool = True
    BBOX_NORMALIZE_TARGETS_PRECOMPUTED: bool = True
    BBOX_INSIDE_WEIGHTS: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    BBOX_NORMALIZE_MEANS: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    BBOX_NORMALIZE_STDS: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    PROPOSAL_METHOD: str = "gt"
    TRIM_HEIGHT: int = 600
    TRIM_WIDTH: int = 600
    RPN_POSITIVE_OVERLAP: float = 0.7
    RPN_NEGATIVE_OVERLAP: float = 0.3
    RPN_CLOBBER_POSITIVES: bool = False
    RPN_FG_FRACTION: float = 0.5
    RPN_BATCHSIZE: int = 256
    RPN_NMS_THRESH: float = 0.7
    RPN_PRE_NMS_TOP_N: int = 12000
    RPN_POST_NMS_TOP_N: int = 2000
    RPN_POSITIVE_WEIGHT: float = -1.0
    USE_ALL_GT: bool = True
    GRAD_CLIP: float = 0.0
    WARMUP_ITERS: int = 0
    WARMUP_FACTOR: float = 0.1
    IMAGE_CACHE: bool = False
    NATIVE_PREP: bool = True


@dataclass(frozen=True)
class TestConfig:
    SCALES: Tuple[int, ...] = (600,)
    MAX_SIZE: int = 1000
    NMS: float = 0.3
    SVM: bool = False
    BBOX_REG: bool = True
    HAS_RPN: bool = True
    PROPOSAL_METHOD: str = "gt"
    RPN_NMS_THRESH: float = 0.7
    RPN_PRE_NMS_TOP_N: int = 6000
    RPN_POST_NMS_TOP_N: int = 300
    RPN_TOP_N: int = 5000
    MODE: str = "nms"
    MAX_PER_IMAGE: int = 100
    SCORE_THRESH: float = 0.05


@dataclass(frozen=True)
class ResNetConfig:
    MAX_POOL: bool = False
    FIXED_BLOCKS: int = 1


@dataclass(frozen=True)
class MobileNetConfig:
    REGU_DEPTH: bool = False
    FIXED_LAYERS: int = 5
    WEIGHT_DECAY: float = 0.00004
    DEPTH_MULTIPLIER: float = 1.0


@dataclass(frozen=True)
class FPNConfig:
    OUT_CHANNELS: int = 256
    MIN_LEVEL: int = 2
    MAX_LEVEL: int = 5
    ANCHOR_SCALE: float = 8.0
    ROI_CANONICAL_SCALE: float = 224.0
    ROI_CANONICAL_LEVEL: int = 4
    PRE_NMS_PER_LEVEL_TRAIN: int = 2000
    PRE_NMS_PER_LEVEL_TEST: int = 1000


@dataclass(frozen=True)
class DeviceConfig:
    """Fixed-shape execution knobs (the JAX package's ``TPU`` section)."""

    # Image buckets (H, W) after aspect-preserving resize + zero pad.
    BUCKETS: Tuple[Tuple[int, int], ...] = ((608, 1024), (1024, 608))
    MAX_GT: int = 64
    NUM_DETECTIONS: int = 100
    DTYPE: str = "bfloat16"
    PIXEL_SCALE: float = 1.0
    ROI_SAMPLING_RATIO: int = 2
    USE_KERNELS: bool = True        # hand-written CUDA kernels on CUDA tensors
    THRESHOLD_SELECT: bool = True
    FUSED_RESNET_BLOCKS: bool = True
    MESH_AXIS: str = "data"
    REMAT: bool = False
    PROFILE_DIR: str = ""
    PROFILE_START: int = 10
    PROFILE_STEPS: int = 5
    DEBUG_NANS: bool = False


@dataclass(frozen=True)
class Config:
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    RESNET: ResNetConfig = field(default_factory=ResNetConfig)
    MOBILENET: MobileNetConfig = field(default_factory=MobileNetConfig)
    FPN: FPNConfig = field(default_factory=FPNConfig)
    DEVICE: DeviceConfig = field(default_factory=DeviceConfig)

    DEDUP_BOXES: float = 1.0 / 16.0
    PIXEL_MEANS: Tuple[float, ...] = (102.9801, 115.9465, 122.7717)  # BGR
    RNG_SEED: int = 3
    EPS: float = 1e-14
    EXP_DIR: str = "default"
    USE_GPU_NMS: bool = True
    POOLING_MODE: str = "align"
    POOLING_SIZE: int = 7
    ANCHOR_SCALES: Tuple[float, ...] = (8.0, 16.0, 32.0)
    ANCHOR_RATIOS: Tuple[float, ...] = (0.5, 1.0, 2.0)
    FEAT_STRIDE: Tuple[int, ...] = (16,)
    ROOT_DIR: str = osp.abspath(osp.join(osp.dirname(__file__), ".."))
    DATA_DIR: str = ""
    MATLAB: str = "matlab"

    def __post_init__(self):
        if not self.DATA_DIR:
            object.__setattr__(self, "DATA_DIR", osp.join(self.ROOT_DIR, "data"))

    @property
    def num_anchors(self) -> int:
        return len(self.ANCHOR_SCALES) * len(self.ANCHOR_RATIOS)


cfg = Config()


def default_config() -> Config:
    return Config()


# JAX-package key names that live under another name here.
_RENAMED = {"TPU": "DEVICE", "DEVICE.USE_PALLAS": "DEVICE.USE_KERNELS"}


def _canonical_key(dotted_key: str) -> str:
    head, _, rest = dotted_key.partition(".")
    key = f"{_RENAMED.get(head, head)}.{rest}" if rest else dotted_key
    return _RENAMED.get(key, key)


def _coerce(old: Any, new: Any, key: str) -> Any:
    """Type-checked coercion (reference ``_merge_a_into_b``)."""
    if isinstance(old, bool):
        if isinstance(new, bool):
            return new
        if isinstance(new, str):
            if new.lower() in ("true", "1", "yes"):
                return True
            if new.lower() in ("false", "0", "no"):
                return False
        raise ValueError(f"cannot coerce {new!r} to bool for key {key}")
    if isinstance(old, int):
        if isinstance(new, float) and new != int(new):
            raise ValueError(f"refusing float→int narrowing for key {key}: {new}")
        return int(new)
    if isinstance(old, float):
        return float(new)
    if isinstance(old, str):
        return str(new)
    if isinstance(old, tuple):
        if isinstance(new, str):
            import ast

            try:
                new = ast.literal_eval(new)
            except (ValueError, SyntaxError):
                raise ValueError(f"cannot parse {new!r} as a sequence for key {key}")
        if not isinstance(new, (list, tuple)):
            raise ValueError(f"cannot coerce {new!r} to tuple for key {key}")
        if old and isinstance(old[0], tuple):  # tuple of tuples (BUCKETS)
            return tuple(tuple(int(v) for v in item) for item in new)
        elem = type(old[0]) if old else float
        return tuple(elem(v) for v in new)
    raise ValueError(f"unsupported config field type {type(old)} for key {key}")


def _parse_scalar(s: str) -> Any:
    for conv in (int, float):
        try:
            return conv(s)
        except ValueError:
            pass
    return s


def set_by_path(config: Config, dotted_key: str, value: Any) -> Config:
    """Return a new Config with ``dotted_key`` (e.g. 'TRAIN.LEARNING_RATE',
    or a JAX-package name such as 'TPU.BUCKETS') set."""
    key = _canonical_key(dotted_key)

    def rec(node, parts):
        name = parts[0]
        if not hasattr(node, name):
            raise KeyError(f"unknown config key: {dotted_key}")
        old = getattr(node, name)
        if len(parts) == 1:
            return dataclasses.replace(node, **{name: _coerce(old, value, dotted_key)})
        return dataclasses.replace(node, **{name: rec(old, parts[1:])})

    return rec(config, key.split("."))


def cfg_from_list(config: Config, kv_list) -> Config:
    """Reference ``cfg_from_list`` (--set K V pairs on the CLI)."""
    if len(kv_list) % 2 != 0:
        raise ValueError("--set expects K V pairs")
    for k, v in zip(kv_list[0::2], kv_list[1::2]):
        config = set_by_path(config, k, _parse_scalar(v) if isinstance(v, str) else v)
    return config


def cfg_from_file(config: Config, filename: str) -> Config:
    """Reference ``cfg_from_file``: deep-merge a YAML file of overrides."""
    import yaml

    with open(filename) as f:
        data = yaml.safe_load(f) or {}

    def rec(config, prefix, node):
        for k, v in node.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                config = rec(config, key + ".", v)
            else:
                config = set_by_path(config, key, v)
        return config

    return rec(config, "", data)


def get_output_dir(config: Config, imdb_name: str, tag: str | None = None) -> str:
    """ROOT_DIR/output/EXP_DIR/<imdb>/<tag or default>, created (reference
    ``get_output_dir``): snapshots, the train log and test detections."""
    out = osp.join(config.ROOT_DIR, "output", config.EXP_DIR, imdb_name, tag or "default")
    os.makedirs(out, exist_ok=True)
    return out


def get_output_tb_dir(config: Config, imdb_name: str, tag: str | None = None) -> str:
    """ROOT_DIR/tensorboard/EXP_DIR/<imdb>/<tag or default>, created."""
    out = osp.join(config.ROOT_DIR, "tensorboard", config.EXP_DIR, imdb_name, tag or "default")
    os.makedirs(out, exist_ok=True)
    return out
