"""Weights: ``convert_from_jax`` inverts ``convert_detector`` exactly, the
port loads the lineage's torchvision-named state_dict as it is, and the
port's ResNet-50 trunk gives the JAX trunk's features with those weights."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from frcnn_tpu.models.backbones import ResNetV1 as JaxResNetV1
from frcnn_tpu.utils.weight_convert import convert_detector
from frcnn_tpu_torch import default_config
from frcnn_tpu_torch.models.network import build_model
from frcnn_tpu_torch.utils.weight_convert import convert_from_jax
from tests.test_pipeline_parity import NUM_CLASSES, _detector_state_dict


def test_round_trip_and_direct_load():
    sd = _detector_state_dict(np.random.RandomState(0))
    converted = convert_detector({k: v.numpy() for k, v in sd.items()}, "res50",
                                 num_anchors=9)
    back = convert_from_jax(converted, "res50", num_anchors=9)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    model = build_model("res50", NUM_CLASSES, default_config())
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd)  # strict: lineage names and layouts load as they are


def test_trunk_features_match_jax(rng):
    sd = _detector_state_dict(np.random.RandomState(0))
    converted = convert_detector({k: v.numpy() for k, v in sd.items()}, "res50")
    jax_model = JaxResNetV1(depth=50)
    x = rng.randn(1, 64, 96, 3).astype(np.float32) * 50
    want = np.asarray(jax.jit(lambda p, v: jax_model.apply(
        p, v, method="extract_features"))({"params": converted["backbone"]}, jnp.asarray(x)))

    model = build_model("res50", NUM_CLASSES, default_config())
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model.backbone.extract_features(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 4, 6, 1024)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-4
