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
from hrnet_hand_pose_estimation_tpu_torch.core import quant_infer as Q
from hrnet_hand_pose_estimation_tpu_torch.core.fast_infer import make_fast_infer, precast_variables
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.conv_int8 import (
    SiteQ, conv_int8, conv_int8_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_bottleneck import (
    fused_bottleneck_chain, layer1_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_head_decode import (
    HeadParams, fused_head_decode_v2, head_decode_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.int8_chain import (
    bottleneck_chain_int8_reference, fused_bottleneck_chain_int8)
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


def small_cfg(widths=(16, 32, 48, 64)):
    cfg = load_config(opts=["MODEL.NAME", "pose_hrnet_softmax", "MODEL.IMAGE_SIZE", [64, 64],
                            "MODEL.HEATMAP_SIZE", [16, 16]], freeze=False)
    stage = lambda n: dict(NUM_MODULES=1, NUM_BRANCHES=n, BLOCK="BASIC", NUM_BLOCKS=[1] * n,
                           NUM_CHANNELS=list(widths[:n]), FUSE_METHOD="SUM")
    cfg.MODEL.EXTRA.merge_from_mapping(dict(FINAL_CONV_KERNEL=1, STAGE2=stage(2),
                                            STAGE3=stage(3), STAGE4=stage(4)))
    return cfg.freeze()


def test_small_slice_on_card_launches_both_kernels(cuda):
    cfg = small_cfg()
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


def site_q(rng, cout, k, cin, device):
    kernel = rng.normal(size=(cout, cin, k, k)).astype(np.float32) * 0.1
    kq, wscale = Q.quantize_weight(kernel)
    sa = np.float32(0.05)
    return SiteQ(kq=torch.from_numpy(np.ascontiguousarray(kq.transpose(0, 2, 3, 1))).to(device),
                 wscale=f32(wscale, device), sa=torch.tensor(sa, device=device),
                 scale=f32(sa * wscale, device), bias=f32(rng.normal(size=cout) * 0.3, device))


@pytest.mark.parametrize("k,stride,relu,cin,cout,hw", [
    (3, 1, True, 32, 32, (13, 21)),
    (3, 1, False, 256, 256, (5, 6)),
    (3, 2, True, 64, 64, (33, 17)),
    (3, 2, False, 32, 128, (9, 9)),
    (1, 1, False, 256, 32, (7, 9)),
    (3, 1, True, 256, 32, (20, 36)),
])
def test_conv_int8_kernel_matches_twin(cuda, k, stride, relu, cin, cout, hw):
    """Every site class of the int8 trunk, at ragged sizes; the kernel's
    arithmetic is the twin's, so the outputs agree to the bit."""
    rng = np.random.default_rng(cin + cout + k + stride)
    q = site_q(rng, cout, k, cin, cuda)
    x = bf16(np.abs(rng.normal(size=(3, *hw, cin))) * 3, cuda)
    before = conv_int8.launches
    got = conv_int8(x, q, stride=stride, relu=relu)
    torch.cuda.synchronize()
    assert conv_int8.launches == before + 1
    want = conv_int8_reference(x, q, stride=stride, relu=relu)
    assert got.shape == want.shape and want.float().abs().max().item() > 1.0
    assert torch.equal(got, want)


@pytest.mark.parametrize("hw", [(64, 64), (20, 36), (7, 19)])
def test_int8_chain_kernel_matches_twin(cuda, hw):
    rng = np.random.default_rng(hw[1])
    i8 = lambda *shape: torch.from_numpy(rng.integers(-127, 128, size=shape).astype(np.int8)).to(cuda)
    pos = lambda n: f32(np.abs(rng.normal(size=n)) * 2e-3 + 2e-4, cuda)
    flags, params, cin = (True, False, False, False), [], 64
    for has_sc in flags:
        params += [f32(np.full((1, 1), 9.7), cuda), i8(cin, 64), pos(64), f32(rng.normal(size=64), cuda),
                   i8(9 * 64, 64), pos(64), f32(rng.normal(size=64), cuda),
                   i8(64, 256), pos(256) * 0.1, f32(rng.normal(size=256) * 0.1, cuda)]
        if has_sc:
            params += [i8(cin, 256), pos(256) * 0.1, f32(rng.normal(size=256) * 0.1, cuda)]
        cin = 256
    x = bf16(np.abs(rng.normal(size=(2, *hw, 64))), cuda)
    before = fused_bottleneck_chain_int8.launches
    got = fused_bottleneck_chain_int8(x, tuple(params), flags)
    torch.cuda.synchronize()
    assert fused_bottleneck_chain_int8.launches == before + len(flags)
    want = bottleneck_chain_int8_reference(x, tuple(params), flags)
    assert got.shape == want.shape == (2, *hw, 256) and want.float().abs().max().item() > 1.0
    assert torch.equal(got, want)


def test_head_int8_kernel_matches_twin(cuda):
    rng = np.random.default_rng(5)
    widths, size, batch = (32, 64, 128, 256), 64, 2
    xs = [torch.from_numpy(rng.integers(0, 128, size=(batch, size >> i, size >> i, c)).astype(
        np.int8)).to(cuda) for i, c in enumerate(widths)]
    scales = tuple(torch.tensor(s, device=cuda) for s in (0.011, 0.023, 0.017, 0.029))
    n, k = sum(widths), 21
    params = HeadParams(f32(rng.normal(size=(n, n)) * 0.05, cuda), f32(rng.normal(size=n) * 0.1, cuda),
                        f32(rng.normal(size=(n, k)) * 0.1, cuda), f32(rng.normal(size=k) * 0.1, cuda),
                        f32(np.float32(1.3), cuda))
    before = fused_head_decode_v2.launches
    got = fused_head_decode_v2(xs, params, input_scales=scales)
    torch.cuda.synchronize()
    assert fused_head_decode_v2.launches == before + 3
    want = head_decode_reference(xs, params, input_scales=scales)
    assert got.shape == (batch, k, 2) and want.std().item() > 0.5
    assert (got - want).abs().max().item() <= 0.1


def test_small_int8_slice_on_card(cuda, monkeypatch):
    """The int8 serving path on the card launches every kernel (one
    conv_int8 launch per int8 site) and agrees with the same forward on
    the card through the plain twins."""
    cfg = small_cfg((32, 64, 96, 128))
    state = init_variables(cfg, seed=3)
    weights = precast_variables(cfg, state)
    rng = np.random.default_rng(0)
    u8 = torch.from_numpy(rng.integers(0, 256, size=(4, 64, 64, 3)).astype(np.uint8)).to(cuda)
    norm = (Q.IMAGENET_MEAN, Q.IMAGENET_STD)
    mean, std = (torch.tensor(v, device=cuda) for v in norm)
    amax = Q.calibrate(cfg, weights, [(u8.float() / 255 - mean) / std])
    infer = Q.make_quant_infer(cfg, input_norm=norm)
    for int8_head in (False, True):
        qparams = Q.prepare_serving_qparams(cfg, {k: v.to(cuda) for k, v in state.items()}, amax,
                                            int8_head=int8_head)
        counts = (conv_int8.launches, fused_bottleneck_chain_int8.launches,
                  fused_head_decode_v2.launches)
        got = infer(weights, qparams, u8)
        torch.cuda.synchronize()
        sites = len(Q.quant_sites(cfg, "exchange", stem2=True))
        assert (conv_int8.launches, fused_bottleneck_chain_int8.launches,
                fused_head_decode_v2.launches) == (counts[0] + sites, counts[1] + 4, counts[2] + 3)
        with monkeypatch.context() as m:
            m.setattr(Q, "conv_int8", conv_int8_reference)
            m.setattr(Q, "fused_bottleneck_chain_int8", bottleneck_chain_int8_reference)
            m.setattr(Q, "fused_head_decode_v2", head_decode_reference)
            want = infer(weights, qparams, u8)
        assert got.shape == (4, 21, 2) and (got - want).abs().max().item() <= 0.25
