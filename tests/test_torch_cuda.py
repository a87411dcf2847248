"""The port's CUDA kernels against their plain PyTorch twins, on a card.

Every test here is marked ``cuda`` and skips without a card: a CUDA kernel
has no CPU mode.  The file imports neither JAX nor the test conftest's
fixtures, so it also runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu_torch.config import load_config
from hrnet_hand_pose_estimation_tpu_torch.core.fast_infer import make_fast_infer, precast_variables
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_bottleneck import (
    fused_bottleneck_chain, layer1_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_head_decode import (
    HeadParams, fused_head_decode_v2, head_decode_reference)
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import init_variables

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 twins
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def bf16(a, device):
    return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=torch.bfloat16)


def f32(a, device):
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


@pytest.mark.parametrize("hw", [(64, 64), (20, 36), (7, 19)])
def test_layer1_kernel_matches_twin(cuda, hw):
    """Full layer1 widths; ragged spatial sizes exercise the tile edges."""
    rng = np.random.default_rng(hw[0])
    flags = (True, False, False, False)
    params, cin = [], 64
    for has_sc in flags:
        params += [bf16(rng.normal(size=(cin, 64)) * 0.1, cuda), f32(rng.normal(size=64) * 0.1, cuda),
                   bf16(rng.normal(size=(3, 3, 64, 64)) * 0.05, cuda), f32(rng.normal(size=64) * 0.1, cuda),
                   bf16(rng.normal(size=(64, 256)) * 0.1, cuda), f32(rng.normal(size=256) * 0.1, cuda)]
        if has_sc:
            params += [bf16(rng.normal(size=(cin, 256)) * 0.1, cuda), f32(rng.normal(size=256) * 0.1, cuda)]
        cin = 256
    x = bf16(np.abs(rng.normal(size=(3, *hw, 64))), cuda)
    before = fused_bottleneck_chain.launches
    got = fused_bottleneck_chain(x, tuple(params), flags)
    torch.cuda.synchronize()
    assert fused_bottleneck_chain.launches == before + len(flags)    # one per block
    want = layer1_reference(x, tuple(params), flags)
    limit = 0.02 * max(1.0, want.float().abs().max().item())
    assert got.shape == want.shape == (3, *hw, 256)
    assert (got.float() - want.float()).abs().max().item() <= limit


@pytest.mark.parametrize("size,batch", [(64, 2), (16, 4)])
def test_head_kernel_matches_twin(cuda, size, batch):
    rng = np.random.default_rng(size)
    widths = (32, 64, 128, 256)
    xs = [bf16(rng.normal(size=(batch, size >> i, size >> i, c)), cuda) for i, c in enumerate(widths)]
    n, k = sum(widths), 21
    params = HeadParams(f32(rng.normal(size=(n, n)) * 0.05, cuda), f32(rng.normal(size=n) * 0.1, cuda),
                        f32(rng.normal(size=(n, k)) * 0.1, cuda), f32(rng.normal(size=k) * 0.1, cuda),
                        f32(np.float32(1.3), cuda))
    before = fused_head_decode_v2.launches
    got = fused_head_decode_v2(xs, params)
    torch.cuda.synchronize()
    assert fused_head_decode_v2.launches == before + 3
    want = head_decode_reference(xs, params)
    assert got.shape == (batch, k, 2) and want.std().item() > 0.5
    assert (got - want).abs().max().item() <= 0.05


def test_small_slice_on_card_launches_both_kernels(cuda):
    cfg = load_config(opts=["MODEL.NAME", "pose_hrnet_softmax", "MODEL.IMAGE_SIZE", [64, 64],
                            "MODEL.HEATMAP_SIZE", [16, 16]], freeze=False)
    cfg.MODEL.EXTRA.merge_from_mapping(dict(
        FINAL_CONV_KERNEL=1,
        STAGE2=dict(NUM_MODULES=1, NUM_BRANCHES=2, BLOCK="BASIC", NUM_BLOCKS=[1, 1],
                    NUM_CHANNELS=[16, 32], FUSE_METHOD="SUM"),
        STAGE3=dict(NUM_MODULES=1, NUM_BRANCHES=3, BLOCK="BASIC", NUM_BLOCKS=[1, 1, 1],
                    NUM_CHANNELS=[16, 32, 48], FUSE_METHOD="SUM"),
        STAGE4=dict(NUM_MODULES=1, NUM_BRANCHES=4, BLOCK="BASIC", NUM_BLOCKS=[1, 1, 1, 1],
                    NUM_CHANNELS=[16, 32, 48, 64], FUSE_METHOD="SUM")))
    cfg.freeze()
    state = init_variables(cfg, seed=3)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 64, 64, 3)).astype(np.float32))
    weights = precast_variables(cfg, state)
    before = (fused_bottleneck_chain.launches, fused_head_decode_v2.launches)
    got = make_fast_infer(cfg)(weights, x.to(cuda))
    assert (fused_bottleneck_chain.launches, fused_head_decode_v2.launches) == (
        before[0] + 4, before[1] + 3)
    # the same forward on the card with both plain twins (the same cuDNN
    # convs around them, so only the kernels differ)
    with torch.inference_mode():
        xin = x.to(cuda, torch.bfloat16).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        xs = weights.model.forward_backbone(xin, layer1=lambda t: layer1_reference(
            t.permute(0, 2, 3, 1).contiguous(), *weights.layer1).permute(0, 3, 1, 2))
        want = head_decode_reference([t.permute(0, 2, 3, 1).contiguous() for t in xs],
                                     weights.head)
    assert got.shape == (4, 21, 2) and (got - want).abs().max().item() <= 0.25
