"""Each shipped YAML of the single-image model zoo (four swin, two
hamburger, the RVT) builds in the port's registry at its full width with
exactly the JAX model's parameters and BN statistics, by name and shape."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.config import load_config as jax_load_config
from hrnet_hand_pose_estimation_tpu.models import build_model as jax_build_model
from hrnet_hand_pose_estimation_tpu_torch.config import load_config
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables

RHD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments",
                   "RHD")

torch.set_num_threads(1)

# (YAML, parameters in millions as the JAX model counts them)
YAMLS = [("RHD_SwinTransformer_trainable_softmax_pose2dloss_v1", 27.53),
         ("RHD_HRNet_SwinTransformer_trainable_softmax_pose2dloss_v1", 48.85),
         ("RHD_HRNet_SwinTransformer_trainable_softmax_pose2dloss_v2", 48.85),
         ("RHD_HRNet_SwinTransformer_trainable_softmax_pose2dloss_v3", 48.85),
         ("RHD_HRNet_MatrixDecomp_trainable_softmax_pose2dloss_v1", 30.04),
         ("RHD_HRNet_MatrixDecomp_trainable_softmax_pose2dloss_v2", 30.04),
         ("RHD_Resnet50_RVT_v1", 106.02)]


@pytest.mark.parametrize("yaml,millions", YAMLS)
def test_shipped_yaml_builds_at_full_width(yaml, millions):
    """The registry's model of each shipped zoo YAML has the JAX model's
    parameters and BN statistics, by name and shape: the strict bridge maps
    a zero tree of the JAX model's ``eval_shape`` onto it."""
    path = os.path.join(RHD, yaml + ".yaml")
    cfg = load_config(path)
    model = build_model(cfg)
    jm = jax_build_model(jax_load_config(path))
    size = int(cfg.MODEL.IMAGE_SIZE[0])
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, size, size, 3)),
                                            False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    sd = from_jax_variables(zeros, model)
    assert set(sd) == set(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert n_params == n_jax and abs(n_params / 1e6 - millions) < 0.01
