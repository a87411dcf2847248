"""Port config (hrnet_hand_pose_estimation_tpu_torch.config) against the JAX
package's: the same defaults, presets and experiment trees."""

import glob
import os
import subprocess
import sys

import pytest
import torch

from hrnet_hand_pose_estimation_tpu import config as jax_config
from hrnet_hand_pose_estimation_tpu_torch import config as port_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = sorted(glob.glob(os.path.join(REPO, "experiments", "**", "*.yaml"),
                               recursive=True))


def test_experiments_found():
    assert len(EXPERIMENTS) >= 60


@pytest.mark.parametrize("chunk", range(4))
def test_experiment_yamls_load_to_equal_trees(chunk):
    for path in EXPERIMENTS[chunk::4]:
        want = jax_config.load_config(path).to_dict()
        got = port_config.load_config(path).to_dict()
        assert got == want, path


def test_defaults_and_presets_equal():
    assert port_config.default_config().to_dict() == jax_config.default_config().to_dict()
    assert port_config.POSE_HIGH_RESOLUTION_NET_EXTRA == jax_config.POSE_HIGH_RESOLUTION_NET_EXTRA
    assert port_config.POSE_RESNET_EXTRA == jax_config.POSE_RESNET_EXTRA


def test_overrides_and_freeze():
    cfg = port_config.load_config(opts=["TRAIN.LR", "3e-4", "MODEL.NUM_JOINTS", 17])
    assert cfg.TRAIN.LR == 3e-4 and cfg.MODEL.NUM_JOINTS == 17
    with pytest.raises(AttributeError):
        cfg.TRAIN.LR = 1.0
    with pytest.raises(KeyError):
        port_config.config_from_dict({"NOT_A_KEY": 1})


def test_config_without_yaml_module():
    """The card's machine may lack PyYAML: the defaults must not need it."""
    code = ("import sys; sys.modules['yaml'] = None\n"
            "from hrnet_hand_pose_estimation_tpu_torch.config import load_config\n"
            "assert load_config().MODEL.NUM_JOINTS == 21\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
