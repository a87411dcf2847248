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
from hrnet_hand_pose_estimation_tpu_torch.core.trainer import Trainer
from hrnet_hand_pose_estimation_tpu_torch.data.pipeline import DataLoader
from hrnet_hand_pose_estimation_tpu_torch.data.synthetic import SyntheticDataset
from hrnet_hand_pose_estimation_tpu_torch.models import build_model
from hrnet_hand_pose_estimation_tpu_torch.ops import s2d
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.conv_int8 import (
    SiteQ, conv_int8, conv_int8_reference, pad_kq)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_bottleneck import (
    basic_chain_reference, fused_basic_chain, fused_bottleneck_chain, fused_stem_layer1,
    layer1_reference, stem_layer1_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_head_decode import (
    HeadParams, fused_head_decode, fused_head_decode_v2, head_decode_reference,
    head_decode_v1_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.gaussian_targets import (
    fused_gaussian_targets, gaussian_targets_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.int8_chain import (
    basic_chain_int8_reference, bottleneck_chain_int8_reference, fused_basic_chain_int8,
    fused_bottleneck_chain_int8)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.softmax_decode import (
    decode_plan, fused_softmax_decode, softmax_decode_reference, softmax_decode_split_reference)
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS
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


@pytest.mark.parametrize("batch,hw", [(3, (64, 64)), (3, (20, 36)), (3, (7, 19)),
                                      (1, (64, 64)), (128, (64, 64))])
def test_layer1_kernel_matches_twin(cuda, batch, hw):
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
    x = bf16(np.abs(rng.normal(size=(batch, *hw, 64))), cuda)
    before = fused_bottleneck_chain.launches
    got = fused_bottleneck_chain(x, tuple(params), flags)
    torch.cuda.synchronize()
    assert fused_bottleneck_chain.launches == before + len(flags)    # one per block
    want = layer1_reference(x, tuple(params), flags)
    limit = 0.02 * max(1.0, want.float().abs().max().item())
    assert got.shape == want.shape == (batch, *hw, 256)
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
    assert fused_head_decode_v2.launches == before + 1
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
        before[0] + 4, before[1] + 1)
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


@pytest.mark.parametrize("k,stride,relu,cin,cout,hw,batch", [
    (3, 1, True, 32, 32, (13, 21), 3),
    (3, 1, False, 256, 256, (5, 6), 3),
    (3, 2, True, 64, 64, (33, 17), 3),
    (3, 2, False, 32, 128, (9, 9), 3),
    (1, 1, False, 256, 32, (7, 9), 3),
    (3, 1, True, 256, 32, (20, 36), 3),
    # the w48 widths: Cin % 32 == 16 takes a 16-channel last K slice
    (3, 1, True, 48, 48, (13, 21), 3),
    (3, 2, True, 48, 96, (17, 17), 3),
    (1, 1, False, 96, 48, (9, 7), 3),          # a ring of 3 weight slabs
    (3, 1, False, 96, 96, (8, 8), 3),
    # the edges of the tiles: Wo past one 64-column tile, Ho not a multiple of
    # the tile rows, B = 1, three channel blocks, 48 channels in a 64-wide
    # block, a ring of 2 slabs (1x1, Cin 64)
    (3, 1, True, 32, 32, (5, 70), 1),
    (3, 2, True, 64, 64, (129, 131), 1),
    (3, 1, False, 256, 256, (8, 8), 1),
    (3, 1, True, 384, 384, (8, 8), 2),
    (1, 1, False, 384, 48, (8, 8), 2),
    (1, 1, True, 64, 32, (11, 13), 2),
    (3, 1, True, 128, 128, (16, 16), 1),
])
def test_conv_int8_kernel_matches_twin(cuda, k, stride, relu, cin, cout, hw, batch):
    """Every site class of the int8 trunk, at ragged sizes and at the edges
    of the kernel's tiles; the kernel's arithmetic is the twin's, so the
    outputs agree to the bit."""
    rng = np.random.default_rng(cin + cout + k + stride)
    q = site_q(rng, cout, k, cin, cuda)
    x = bf16(np.abs(rng.normal(size=(batch, *hw, cin))) * 3, cuda)
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


def int8_layer1_params(rng, device, n_major):
    """A W8A8 layer1 chain's flat params (64 -> 256 with a projection, then
    three 256 -> 256 blocks), each kq a plain (K, N) tensor or, with
    ``n_major``, the (K, N) view of (N, K) storage that prepare_layer1_int8
    makes."""
    def i8(k, n):
        a = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
        return torch.from_numpy(a.T.copy()).to(device).t() if n_major else \
            torch.from_numpy(a).to(device)
    pos = lambda n: f32(np.abs(rng.normal(size=n)) * 2e-3 + 2e-4, device)
    flags, params, cin = (True, False, False, False), [], 64
    for has_sc in flags:
        params += [f32(np.full((1, 1), 9.7), device), i8(cin, 64), pos(64),
                   f32(rng.normal(size=64), device), i8(9 * 64, 64), pos(64),
                   f32(rng.normal(size=64), device), i8(64, 256), pos(256) * 0.1,
                   f32(rng.normal(size=256) * 0.1, device)]
        if has_sc:
            params += [i8(cin, 256), pos(256) * 0.1, f32(rng.normal(size=256) * 0.1, device)]
        cin = 256
    return tuple(params), flags


@pytest.mark.parametrize("n_major", [False, True])
@pytest.mark.parametrize("batch,hw", [(1, (64, 64)), (2, (64, 64)), (2, (20, 36)), (2, (7, 19)),
                                      (2, (13, 16)), (2, (16, 21)), (3, (8, 8)), (1, (3, 5))])
def test_int8_chain_kernel_tile_edges_and_layouts(cuda, n_major, batch, hw):
    """The W8A8 layer1 chain bit-equal to its twin at B = 1, at the existing
    shapes, where W is not a multiple of the 16-column tile, H not one of
    its 8 rows, on an 8 x 8 map and on a map smaller than a tile, with the
    kq's N-major views (the serving layout) or plain tensors (copied per
    call); one launch per block."""
    rng = np.random.default_rng(hw[0] * 100 + hw[1] + batch)
    params, flags = int8_layer1_params(rng, cuda, n_major)
    x = bf16(np.abs(rng.normal(size=(batch, *hw, 64))), cuda)
    before = fused_bottleneck_chain_int8.launches
    got = fused_bottleneck_chain_int8(x, params, flags)
    torch.cuda.synchronize()
    assert fused_bottleneck_chain_int8.launches == before + len(flags)
    want = bottleneck_chain_int8_reference(x, params, flags)
    assert got.shape == want.shape == (batch, *hw, 256) and want.float().abs().max().item() > 1.0
    assert torch.equal(got, want)


@pytest.mark.parametrize("cin,cout,flags", [(64, 128, (True, False)), (128, 128, (False,)),
                                            (96, 256, (True,))])
def test_int8_chain_kernel_refuses_widths_it_cannot_take(cuda, cin, cout, flags):
    """The kernel takes layer1's blocks only (Cin 64 or 256, Cout 256): any
    other chain raises ValueError before its first launch."""
    rng = np.random.default_rng(cin + cout)
    i8 = lambda k, n: torch.from_numpy(rng.integers(-127, 128, size=(k, n)).astype(np.int8)).to(cuda)
    pos = lambda n: f32(np.abs(rng.normal(size=n)) * 2e-3 + 2e-4, cuda)
    params, c = [], cin
    for has_sc in flags:
        params += [f32(np.full((1, 1), 9.7), cuda), i8(c, 64), pos(64), f32(rng.normal(size=64), cuda),
                   i8(576, 64), pos(64), f32(rng.normal(size=64), cuda), i8(64, cout),
                   pos(cout) * 0.1, f32(rng.normal(size=cout) * 0.1, cuda)]
        if has_sc:
            params += [i8(c, cout), pos(cout) * 0.1, f32(rng.normal(size=cout) * 0.1, cuda)]
        c = cout
    x = bf16(np.abs(rng.normal(size=(2, 11, 21, cin))), cuda)
    before = fused_bottleneck_chain_int8.launches
    with pytest.raises(ValueError, match="layer1's blocks"):
        fused_bottleneck_chain_int8(x, tuple(params), flags)
    assert fused_bottleneck_chain_int8.launches == before


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
    assert fused_head_decode_v2.launches == before + 1
    want = head_decode_reference(xs, params, input_scales=scales)
    assert got.shape == (batch, k, 2) and want.std().item() > 0.5
    assert (got - want).abs().max().item() <= 0.1


def test_small_int8_slice_on_card(cuda, monkeypatch):
    """The int8 serving path on the card launches every kernel (one
    conv_int8 launch per int8 site) and agrees with the same forward on
    the card through the plain twins."""
    int8_slice_on_card(cuda, monkeypatch, small_cfg((32, 64, 96, 128)))


def test_small_w48_int8_slice_on_card(cuda, monkeypatch):
    """The same at the w48 stage widths (48/96/192/384), whose sites read
    tensors with Cin % 32 == 16."""
    int8_slice_on_card(cuda, monkeypatch, small_cfg((48, 96, 192, 384)))


def int8_slice_on_card(cuda, monkeypatch, cfg, batch=4):
    state = init_variables(cfg, seed=3)
    weights = precast_variables(cfg, state)
    rng = np.random.default_rng(0)
    u8 = torch.from_numpy(rng.integers(0, 256, size=(batch, 64, 64, 3)).astype(np.uint8)).to(cuda)
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
                fused_head_decode_v2.launches) == (counts[0] + sites, counts[1] + 4, counts[2] + 1)
        with monkeypatch.context() as m:
            m.setattr(Q, "conv_int8", conv_int8_reference)
            m.setattr(Q, "fused_bottleneck_chain_int8", bottleneck_chain_int8_reference)
            m.setattr(Q, "fused_head_decode_v2", head_decode_reference)
            want = infer(weights, qparams, u8)
        assert got.shape == (batch, 21, 2) and (got - want).abs().max().item() <= 0.25


def basic_params(rng, c, n_blocks, device):
    params = []
    for _ in range(n_blocks):
        for _ in range(2):
            params += [bf16(rng.normal(size=(3, 3, c, c)) * (0.6 / np.sqrt(9 * c)), device),
                       f32(rng.normal(size=c) * 0.1, device)]
    return tuple(params)


@pytest.mark.parametrize("batch,h,w,c", [
    (2, 64, 64, 32), (2, 32, 32, 64), (2, 16, 16, 128), (2, 8, 8, 256),      # w32 branches
    (2, 64, 64, 48), (2, 32, 32, 96), (2, 16, 16, 192), (2, 8, 8, 384),      # w48 branches
    (3, 8, 8, 256), (5, 16, 16, 32),                                         # ragged batches
    (2, 13, 21, 64), (1, 37, 70, 32),                                        # ragged tiles
    # the edges of the tiles: B = 1, H and W not multiples of the 8 x 32
    # tile, 16- and 48-channel warps (16-channel weight slabs), one-row
    # tiles (384 channels at 16 x 16), a ring of 2 weight slabs (512 at 8 x 8)
    (1, 8, 8, 256), (2, 19, 45, 32), (2, 11, 9, 16), (1, 12, 40, 48),
    (1, 16, 16, 384), (2, 8, 8, 512),
])
def test_basic_chain_kernel_matches_twin(cuda, batch, h, w, c):
    """Every branch shape of w32 and w48, ragged batches and ragged spatial
    sizes, and the edges of the kernel's tiles; one launch per block."""
    rng = np.random.default_rng(c + h)
    params = basic_params(rng, c, 2, cuda)
    x = bf16(np.abs(rng.normal(size=(batch, h, w, c))), cuda)
    before = fused_basic_chain.launches
    got = fused_basic_chain(x, params, 2)
    torch.cuda.synchronize()
    assert fused_basic_chain.launches == before + 2
    want = basic_chain_reference(x, params, 2)
    limit = 0.02 * max(1.0, want.float().abs().max().item())
    assert got.shape == want.shape == (batch, h, w, c) and want.float().std().item() > 0.1
    assert (got.float() - want.float()).abs().max().item() <= limit


def test_tiled_kernels_refuse_untaken_shapes(cuda):
    """A shape the launch plans do not take raises before any launch; no
    fallback runs."""
    rng = np.random.default_rng(80)
    params = basic_params(rng, 640, 1, cuda)
    x = bf16(np.abs(rng.normal(size=(1, 8, 8, 640))), cuda)
    before = fused_basic_chain.launches
    with pytest.raises(ValueError, match="C = 640"):
        fused_basic_chain(x, params, 1)
    q = site_q(rng, 20, 3, 32, cuda)
    before_int8 = conv_int8.launches
    with pytest.raises(ValueError, match="stride"):
        conv_int8(bf16(np.ones((1, 8, 8, 32)), cuda), q, stride=3)
    assert (fused_basic_chain.launches, conv_int8.launches) == (before, before_int8)


def layer1_params(rng, device):
    flags, params, cin = (True, False, False, False), [], 64
    for has_sc in flags:
        params += [bf16(rng.normal(size=(cin, 64)) * 0.1, device), f32(rng.normal(size=64) * 0.1, device),
                   bf16(rng.normal(size=(3, 3, 64, 64)) * 0.05, device), f32(rng.normal(size=64) * 0.1, device),
                   bf16(rng.normal(size=(64, 256)) * 0.1, device), f32(rng.normal(size=256) * 0.1, device)]
        if has_sc:
            params += [bf16(rng.normal(size=(cin, 256)) * 0.1, device),
                       f32(rng.normal(size=256) * 0.1, device)]
        cin = 256
    return tuple(params), flags


@pytest.mark.parametrize("batch,hs,ws", [(2, 64, 64), (2, 20, 36), (2, 6, 38), (1, 128, 128),
                                         (128, 128, 128)])
def test_stem_layer1_kernel_matches_twin(cuda, batch, hs, ws):
    """The s2d stem kernel + the layer1 launches against their twin, with
    ragged tiles; one stem launch and one per layer1 block."""
    rng = np.random.default_rng(hs + ws)
    stem = (bf16(rng.normal(size=(4, 12, 64)) * 0.3, cuda), f32(rng.normal(size=64) * 0.1, cuda),
            bf16(rng.normal(size=(576, 64)) * 0.06, cuda), f32(rng.normal(size=64) * 0.1, cuda))
    params, flags = layer1_params(rng, cuda)
    x = bf16(rng.normal(size=(batch, hs, ws, 12)), cuda)
    before = fused_stem_layer1.launches
    got = fused_stem_layer1(x, stem, params, flags)
    torch.cuda.synchronize()
    assert fused_stem_layer1.launches == before + 5
    want = stem_layer1_reference(x, stem, params, flags)
    limit = 0.02 * max(1.0, want.float().abs().max().item())
    assert got.shape == want.shape == (batch, hs // 2, ws // 2, 256)
    assert (got.float() - want.float()).abs().max().item() <= limit


def twin_parts(weights, fuse: bool, branches: bool):
    """forward_backbone hooks of make_fast_infer's kernels, through their twins."""
    nhwc = lambda fn: lambda t: fn(t.permute(0, 2, 3, 1).contiguous()).permute(0, 3, 1, 2)
    parts = {}
    if fuse:
        parts["stem"] = nhwc(lambda t: stem_layer1_reference(
            s2d.space_to_depth(t), weights.stem_flat, *weights.layer1))
        parts["layer1"] = torch.nn.Identity()
    else:
        parts["layer1"] = nhwc(lambda t: layer1_reference(t, *weights.layer1))
    if branches:
        parts["branch"] = lambda name, t: nhwc(lambda u: basic_chain_reference(
            u, weights.branches[name], len(weights.branches[name]) // 4))(t)
    return parts


def test_small_slice_new_configurations_on_card(cuda):
    """make_fast_infer(pallas_branches=True, fuse_stem_layer1=True) launches
    the branch and stem kernels (and no stand-alone layer1 chain) and agrees
    with the same forward through the twins; s2d_stem=True and
    pallas_layer1=False run."""
    cfg = small_cfg()
    state = init_variables(cfg, seed=3)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 64, 64, 3)).astype(np.float32))
    weights = precast_variables(cfg, state)
    kernels = (fused_basic_chain, fused_stem_layer1, fused_bottleneck_chain, fused_head_decode_v2)
    for fn in kernels:
        fn.launches = 0
    got = make_fast_infer(cfg, pallas_branches=True, fuse_stem_layer1=True)(weights, x.to(cuda))
    torch.cuda.synchronize()
    blocks = sum(len(p) // 4 for p in weights.branches.values())
    assert blocks == 9 and [fn.launches for fn in kernels] == [blocks, 5, 0, 1]
    with torch.inference_mode():
        xin = x.to(cuda, torch.bfloat16).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        xs = weights.model.forward_backbone(xin, **twin_parts(weights, True, True))
        want = head_decode_reference([t.permute(0, 2, 3, 1).contiguous() for t in xs],
                                     weights.head)
    assert got.shape == (4, 21, 2) and (got - want).abs().max().item() <= 0.25
    for kwargs in (dict(s2d_stem=True), dict(pallas_layer1=False), dict(pallas_branches=True)):
        out = make_fast_infer(cfg, **kwargs)(weights, x.to(cuda))
        assert out.shape == (4, 21, 2) and torch.isfinite(out).all()


SMOKE_WIDTHS = (8, 16, 32, 64)    # experiments/synthetic_smoke.yaml: head 120, 2x2 at 64x64


@pytest.mark.parametrize("batch", [1, 4])
def test_smoke_model_served_on_card(cuda, monkeypatch, batch):
    """The smoke model's widths through both serving paths on the card, at
    B = 1 (one image, as tools.inference serves) and B = 4: every kernel
    launches (the branch chains at 8 channels padded to 16, the head at 120
    wide over a 2x2 coarsest map, conv_int8 at 8 input channels and 8
    output channels) and each path agrees with its twin path."""
    cfg = small_cfg(SMOKE_WIDTHS)
    state = init_variables(cfg, seed=3)
    weights = precast_variables(cfg, state)
    x = torch.from_numpy(np.random.default_rng(batch).normal(
        size=(batch, 64, 64, 3)).astype(np.float32)).to(cuda)
    kernels = (fused_basic_chain, fused_stem_layer1, fused_bottleneck_chain, fused_head_decode_v2)
    for fuse in (False, True):
        for fn in kernels:
            fn.launches = 0
        got = make_fast_infer(cfg, pallas_branches=fuse, fuse_stem_layer1=fuse)(weights, x)
        torch.cuda.synchronize()
        assert [fn.launches for fn in kernels] == ([9, 5, 0, 1] if fuse else [0, 0, 4, 1])
        with torch.inference_mode():
            xin = x.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            xs = weights.model.forward_backbone(xin, **twin_parts(weights, fuse, fuse))
            want = head_decode_reference([t.permute(0, 2, 3, 1).contiguous() for t in xs],
                                         weights.head)
        assert got.shape == (batch, 21, 2) and (got - want).abs().max().item() <= 0.25
    int8_slice_on_card(cuda, monkeypatch, cfg, batch)


@pytest.mark.parametrize("c", [8, 18, 36, 40, 72, 80, 120, 144, 160])
def test_basic_chain_kernel_serves_any_width(cuda, c):
    """Widths no kernel instance takes run zero-padded to one that does, and
    agree with the unpadded twin."""
    rng = np.random.default_rng(c)
    params = basic_params(rng, c, 2, cuda)
    x = bf16(np.abs(rng.normal(size=(2, 16, 16, c))), cuda)
    before = fused_basic_chain.launches
    got = fused_basic_chain(x, params, 2)
    torch.cuda.synchronize()
    assert fused_basic_chain.launches == before + 2
    want = basic_chain_reference(x, params, 2)
    limit = 0.02 * max(1.0, want.float().abs().max().item())
    assert got.shape == want.shape == (2, 16, 16, c)
    assert (got.float() - want.float()).abs().max().item() <= limit


@pytest.mark.parametrize("cin,cout,k,stride", [(8, 8, 3, 1), (18, 36, 3, 2), (36, 18, 1, 1),
                                               (40, 80, 3, 1), (120, 20, 3, 1), (256, 8, 3, 1),
                                               (72, 144, 3, 2), (160, 21, 1, 1)])
def test_conv_int8_kernel_serves_any_width(cuda, cin, cout, k, stride):
    """Any Cin and Cout, bit-equal to the twin (weights at a pitch of Cin
    rounded up to 16, x staged element by element where Cin % 8 != 0)."""
    rng = np.random.default_rng(cin * cout)
    q = site_q(rng, cout, k, cin, cuda)
    x = bf16(np.abs(rng.normal(size=(3, 11, 13, cin))) * 3, cuda)
    before = conv_int8.launches
    got = conv_int8(x, q, stride=stride)
    torch.cuda.synchronize()
    assert conv_int8.launches == before + 1
    want = conv_int8_reference(x, q, stride=stride)
    assert got.shape == want.shape and want.float().abs().max().item() > 1.0
    assert torch.equal(got, want)
    got = conv_int8(x, q._replace(kq=pad_kq(q.kq)), stride=stride)   # prepared layout
    assert torch.equal(got, want)


@pytest.mark.parametrize("widths,k,batch", [((8, 16, 32, 64), 21, 1), ((18, 36, 72, 144), 21, 4),
                                            ((40, 80, 160, 320), 128, 2), ((8, 16, 32, 64), 42, 4)])
def test_head_kernel_serves_any_width(cuda, widths, k, batch):
    """Any branch width, head width and B*h*w (a 2x2 coarsest map at B=1),
    K up to 128, bf16 and int8 inputs."""
    rng = np.random.default_rng(sum(widths) + k)
    size = 16
    n = sum(widths)
    params = HeadParams(f32(rng.normal(size=(n, n)) * 0.05, cuda), f32(rng.normal(size=n) * 0.1, cuda),
                        f32(rng.normal(size=(n, k)) * 0.3, cuda), f32(rng.normal(size=k) * 0.1, cuda),
                        f32(np.float32(1.3), cuda))
    xs = [bf16(rng.normal(size=(batch, size >> i, size >> i, c)), cuda) for i, c in enumerate(widths)]
    before = fused_head_decode_v2.launches
    got = fused_head_decode_v2(xs, params)
    torch.cuda.synchronize()
    assert fused_head_decode_v2.launches == before + 1
    want = head_decode_reference(xs, params)
    assert got.shape == (batch, k, 2) and want.std().item() > 0.5
    assert (got - want).abs().max().item() <= 0.05
    xq = [torch.from_numpy(rng.integers(-127, 128, size=t.shape).astype(np.int8)).to(cuda) for t in xs]
    scales = tuple(torch.tensor(s, device=cuda) for s in (0.011, 0.023, 0.017, 0.029))
    got = fused_head_decode_v2(xq, params, input_scales=scales)
    want = head_decode_reference(xq, params, input_scales=scales)
    assert (got - want).abs().max().item() <= 0.1
    with pytest.raises(ValueError, match="K <= 128"):
        fused_head_decode_v2(xs, params._replace(w_final=torch.zeros(n, 129, device=cuda),
                                                 b_final=torch.zeros(129, device=cuda)))
    assert fused_head_decode_v2.launches == before + 2


def halved(h, w, n=4):
    """A branch map and its three halvings, as HRNet's stride-2 convs make them."""
    out = [(h, w)]
    for _ in range(n - 1):
        h, w = -(-h // 2), -(-w // 2)
        out.append((h, w))
    return out


@pytest.mark.parametrize("widths,hw,k,batch", [
    ((32, 64, 128, 256), (20, 36), 21, 2),          # non-square, W0 not a multiple of 16
    ((64, 128, 256, 512), (64, 64), 21, 2),         # w64: a 960-wide head, two passes a band
    ((32, 64, 128, 256), (20, 64), 21, 3),          # H0 = 20: bands of 7, 7 and 6 rows
    ((8, 16, 32, 64), (16, 16), 21, 1),             # B = 1 at a 2x2 coarsest map
    ((48, 96, 192, 384), (64, 64), 128, 2),         # w48 at K = 128: four joint groups
    ((96, 192, 384, 768), (64, 64), 21, 1)])        # 1440 wide: past the old ~1080 limit
def test_head_kernel_shapes(cuda, widths, hw, k, batch):
    """The one-launch head (bands in a cluster, passes, joint groups) at the
    shapes its plan splits differently, bf16 (<= 0.05 px) and int8 inputs
    (<= 0.1 px) against the twin.  On 64 x 64 maps the final conv's weights
    are drawn at 0.1, as in test_head_kernel_matches_twin: at 0.3 the
    softmax is so peaked that the twin alone moves 0.025 px between the
    CPU's and the card's float32 summation order (w48, K = 128)."""
    rng = np.random.default_rng(sum(widths) + hw[1] + k)
    n = sum(widths)
    wf = 0.1 if hw == (64, 64) else 0.3
    params = HeadParams(f32(rng.normal(size=(n, n)) * 0.05, cuda), f32(rng.normal(size=n) * 0.1, cuda),
                        f32(rng.normal(size=(n, k)) * wf, cuda), f32(rng.normal(size=k) * 0.1, cuda),
                        f32(np.float32(1.3), cuda))
    shapes = halved(*hw)
    xs = [bf16(rng.normal(size=(batch, *s, c)), cuda) for s, c in zip(shapes, widths)]
    before = fused_head_decode_v2.launches
    got = fused_head_decode_v2(xs, params)
    torch.cuda.synchronize()
    assert fused_head_decode_v2.launches == before + 1
    want = head_decode_reference(xs, params)
    assert got.shape == (batch, k, 2) and want.std().item() > 0.5
    assert (got - want).abs().max().item() <= 0.05
    xq = [torch.from_numpy(rng.integers(-127, 128, size=t.shape).astype(np.int8)).to(cuda) for t in xs]
    scales = tuple(torch.tensor(s, device=cuda) for s in (0.011, 0.023, 0.017, 0.029))
    got = fused_head_decode_v2(xq, params, input_scales=scales)
    torch.cuda.synchronize()
    want = head_decode_reference(xq, params, input_scales=scales)
    assert (got - want).abs().max().item() <= 0.1
    assert fused_head_decode_v2.launches == before + 2


# -- the 2D training slice ---------------------------------------------------

def edge_joints(rng, b, k, res):
    """Joints across the map plus the edge cases: -0.5 (valid), res, beyond
    res, negative; one invisible joint per sample."""
    joints = rng.uniform(0, res, size=(b, k, 2)).astype(np.float32)
    joints[0, 0] = (-0.5, -0.5)
    joints[0, 1] = (res, 1.0)
    joints[-1, 2] = (res + 3.5, -2.0)
    vis = np.ones((b, k), np.float32)
    vis[np.arange(b), rng.integers(0, k, b)] = 0.0
    return joints, vis


@pytest.mark.parametrize("res", [16, 64])
@pytest.mark.parametrize("sigma", [1.0, 1.5, 2.0])
@pytest.mark.parametrize("batch", [3, 32])
def test_gaussian_targets_kernel_matches_twin(cuda, res, sigma, batch):
    rng = np.random.default_rng(res * 100 + batch)
    joints, vis = edge_joints(rng, batch, 21, res)
    j, v = f32(joints, cuda), f32(vis, cuda)
    before = fused_gaussian_targets.launches
    got = fused_gaussian_targets(j, v, res, sigma)
    torch.cuda.synchronize()
    want = gaussian_targets_reference(j, v, res, sigma)
    assert fused_gaussian_targets.launches == before + 1
    assert got.shape == (batch, res, res, 21) and (want > 0).any()
    assert (got - want).abs().max().item() <= 1e-6
    assert torch.equal(got == 0, want == 0)          # exactly 0 outside the windows


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("res,k,sigma", [(63, 17, 2.0), (63, 21, 1.5), (64, 17, 2.0),
                                         (61, 21, 30.0)])
def test_gaussian_targets_kernel_ragged_shapes(cuda, batch, res, k, sigma):
    """Rows of res * K % 4 != 0 floats reach the scalar head and tail of
    every band; sigma 30 has no room for the exp table (expf per element)."""
    from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.gaussian_targets import targets_plan

    rng = np.random.default_rng(res * 10 + k + batch)
    joints, vis = edge_joints(rng, batch, k, res)
    j, v = f32(joints, cuda), f32(vis, cuda)
    before = fused_gaussian_targets.launches
    got = fused_gaussian_targets(j, v, res, sigma)
    torch.cuda.synchronize()
    want = gaussian_targets_reference(j, v, res, sigma)
    assert fused_gaussian_targets.launches == before + 1
    assert targets_plan(batch, k, res, sigma).table == (sigma < 10)
    assert (got - want).abs().max().item() <= 1e-6
    assert torch.equal(got == 0, want == 0)


def test_gaussian_targets_kernel_refuses_bad_input(cuda):
    j = torch.zeros(2, 21, 2, device=cuda)
    v = torch.ones(2, 21, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fused_gaussian_targets(j.double(), v, 16)
    with pytest.raises(ValueError, match="visibility"):
        fused_gaussian_targets(j, v.cpu(), 16)


def train_small_cfg(**opts):
    cfg = small_cfg().clone()
    cfg.defrost()
    cfg.merge_from_list(["MODEL.HEATMAP_SOFTMAX", True, "LOSS.WITH_POSE2D_LOSS", True]
                        + [x for kv in opts.items() for x in kv])
    return cfg.freeze()


def small_batch(device, b=4, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"images": f32(rng.normal(size=(b, 64, 64, 3)), device),
             "pose2d": f32(rng.uniform(1, 15, size=(b, 21, 2)), device),
             "visibility": f32(np.ones((b, 21)), device)}
    batch["target_heatmaps"] = gaussian_targets_reference(batch["pose2d"], batch["visibility"],
                                                          16, 2.0)
    return batch


def test_anomaly_guard_on_card(cuda):
    """A NaN pixel leaves parameters, optimizer state and BN statistics
    bit-identical on the card; the next clean step trains."""
    cfg = train_small_cfg()
    model = build_model(cfg)
    state, tx = TS.create_train_state(cfg, model, device=cuda)
    step = TS.make_train_step(cfg, model, tx)
    batch = small_batch(cuda)
    state, _ = step(state, batch)
    bad = dict(batch, images=batch["images"].clone())
    bad["images"][1, 3, 3, 0] = float("nan")
    before = [t.clone() for t in (state.params, state.stats, state.counts,
                                  *state.opt_state.values())]
    state, losses = step(state, bad)
    after = (state.params, state.stats, state.counts, *state.opt_state.values())
    assert losses["nonfinite_grads"].item() == 1.0 and int(state.step) == 2
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    state, losses = step(state, batch)
    assert losses["nonfinite_grads"].item() == 0.0
    assert not torch.equal(before[0], state.params)


def test_float32_train_step_card_matches_cpu(cuda):
    """One float32 sgd step on the card and on the CPU (TF32 off), on
    ``chip_smoke.py``'s parity case (w32 widths, one module and one block
    per branch, 256x256, B=4): the loss at rtol 1e-4; the parameters, in
    units of LR max(1, max|g|), within 2e-5 on average.  A ReLU input
    within rounding of 0 can take the other side on the two and move a few
    parameters far more, so the max is not held; on a narrower net those
    few move the mean as well."""
    from chip_smoke import train_batch, train_cfg

    cfg = train_cfg(TPU__COMPUTE_DTYPE="float32", TRAIN__OPTIMIZER="sgd",
                    MODEL__EXTRA__STAGE2__NUM_BLOCKS=[1, 1],
                    MODEL__EXTRA__STAGE3__NUM_MODULES=1,
                    MODEL__EXTRA__STAGE3__NUM_BLOCKS=[1, 1, 1],
                    MODEL__EXTRA__STAGE4__NUM_MODULES=1,
                    MODEL__EXTRA__STAGE4__NUM_BLOCKS=[1, 1, 1, 1])
    cfg.freeze()
    batch = train_batch(30, 4, "cpu")
    batch["target_heatmaps"] = gaussian_targets_reference(batch["pose2d"], batch["visibility"],
                                                          64, 2.0)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = build_model(cfg)
        state, tx = TS.create_train_state(cfg, model, device=dev)
        state, losses = TS.make_train_step(cfg, model, tx)(
            state, {k: v.to(dev) for k, v in batch.items()})
        out[dev.type] = (losses["total_loss"].item(), state.params.cpu(), state.grads.cpu())
    lr = float(cfg.TRAIN.LR)
    gmax = out["cpu"][2].abs().max().item()
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    dp = (out["cuda"][1] - out["cpu"][1]).abs() / (lr * max(1.0, gmax))
    assert dp.mean().item() <= 2e-5, (dp.mean().item(), dp.max().item())


def test_two_step_trainer_on_card(cuda, tmp_path):
    cfg = train_small_cfg(**{"OUTPUT_DIR": str(tmp_path), "TRAIN.BEGIN_EPOCH": 0,
                             "TRAIN.END_EPOCH": 1, "PRINT_FREQ": 1})
    loaders = {"s": DataLoader(SyntheticDataset(cfg, length=8), 4, num_workers=2)}
    vals = {"s": DataLoader(SyntheticDataset(cfg, "validation", length=4), 4, shuffle=False,
                            num_workers=0)}
    trainer = Trainer(cfg, build_model(cfg), loaders, vals, output_dir=str(tmp_path),
                      device=cuda)
    trainer.fit()
    assert trainer.train_global_steps == 2 and trainer.ckpt.epochs() == [0]
    assert np.isfinite(trainer.best_loss)


def test_multistep_on_card_matches_single_steps(cuda):
    """K=2 in one make_train_multistep call against two single steps from
    the same seeded state on the card (bf16 compute, adam), cuDNN
    deterministic: the losses and every parameter and BN statistic
    within 1e-6 (the same steps in the same order)."""
    cfg = train_small_cfg()
    batches = [small_batch(cuda, seed=s) for s in (0, 1)]
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        model = build_model(cfg)
        state, tx = TS.create_train_state(cfg, model, device=cuda)
        step = TS.make_train_step(cfg, model, tx)
        seq = []
        for b in batches:
            state, losses = step(state, b)
            seq.append(losses["total_loss"].clone())
        want = (state.params.clone(), state.stats.clone())
        model = build_model(cfg)
        state, tx = TS.create_train_state(cfg, model, device=cuda)
        stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
        state, losses = TS.make_train_multistep(cfg, model, tx)(state, stacked)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    assert losses["total_loss"].shape == (2,) and int(state.step) == 2
    torch.testing.assert_close(losses["total_loss"], torch.stack(seq), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(state.params, want[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(state.stats, want[1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("levers,stat_atol", [(dict(stat_samples=2), 1e-6),
                                              (dict(stat_dtype="bfloat16"), 1e-4)])
def test_lever_step_card_matches_cpu(cuda, levers, stat_atol):
    """One float32 sgd train step with a BN statistics lever on the card
    and on the CPU (TF32 off), B=4: the loss at 1e-4 relative, every BN
    running statistic at 1e-4 relative + ``stat_atol``: 1e-6 for the
    float32 subsample; 1e-4 for bf16 reductions, whose sums round to
    other bf16 neighbours in the card's order (measured: 2.4e-5 apart)."""
    from hrnet_hand_pose_estimation_tpu_torch.models.layers import set_bn_levers

    cfg = train_small_cfg(**{"TPU.COMPUTE_DTYPE": "float32", "TRAIN.OPTIMIZER": "sgd"})
    batch = {k: v.cpu() for k, v in small_batch(cuda).items()}
    out = {}
    set_bn_levers(**levers)
    try:
        for dev in (cuda, torch.device("cpu")):
            model = build_model(cfg)
            state, tx = TS.create_train_state(cfg, model, device=dev)
            state, losses = TS.make_train_step(cfg, model, tx)(
                state, {k: v.to(dev) for k, v in batch.items()})
            out[dev.type] = (losses["total_loss"].item(), state.stats.cpu())
    finally:
        set_bn_levers()
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4, atol=stat_atol)


def test_quant_infer_layer1_off_launches_no_chain(cuda):
    """make_quant_infer(pallas_layer1=False) with no layer1 qparams runs the
    walk's folded bf16 layer1 on cuDNN: no launch of the bf16 chain kernel
    (B2), one of the head; pallas_layer1=True launches B2 four times."""
    cfg = small_cfg((32, 64, 96, 128))
    state = init_variables(cfg, seed=3)
    weights = precast_variables(cfg, state)
    x = f32(np.random.default_rng(0).normal(size=(4, 64, 64, 3)), cuda)
    outs = {}
    for flag, b2 in ((False, 0), (True, 4)):
        before = (fused_bottleneck_chain.launches, fused_head_decode_v2.launches)
        outs[flag] = Q.make_quant_infer(cfg, trunk="f32", pallas_layer1=flag)(weights, {}, x)
        torch.cuda.synchronize()
        assert (fused_bottleneck_chain.launches - before[0],
                fused_head_decode_v2.launches - before[1]) == (b2, 1)
    assert outs[False].shape == (4, 21, 2) and torch.isfinite(outs[False]).all()
    assert (outs[False] - outs[True]).abs().max().item() <= 0.25


@pytest.mark.parametrize("shape", [(32, 64, 64, 21), (3, 64, 64, 21), (2, 48, 64, 21),
                                   (2, 7, 5, 3), (1, 16, 16, 700)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_decode_kernel_matches_twin(cuda, shape, dtype):
    """B4 against its twin at the eval path's shape, a ragged batch,
    non-square and odd planes and a wide K, with T as a float and as a
    0-d tensor on the card: 1e-4 px."""
    rng = np.random.default_rng(sum(shape))
    x = f32(rng.normal(size=shape) * 3.0, cuda).to(dtype)
    for temp in (1.0, torch.tensor(2.5, device=cuda)):
        before = fused_softmax_decode.launches
        got = fused_softmax_decode(x, temp)
        torch.cuda.synchronize()
        assert fused_softmax_decode.launches == before + 1
        want = softmax_decode_reference(x, temp)
        assert got.shape == (shape[0], shape[3], 2) and got.dtype == torch.float32
        assert (got - want).abs().max().item() <= 1e-4


def test_softmax_decode_kernel_exact_planes(cuda):
    flat = torch.zeros(2, 64, 48, 21, device=cuda)
    assert torch.equal(fused_softmax_decode(flat, 2.5)[..., 0].cpu(), torch.full((2, 21), 23.5))
    assert torch.equal(fused_softmax_decode(flat, 2.5)[..., 1].cpu(), torch.full((2, 21), 31.5))
    peak = f32(np.random.default_rng(1).normal(size=(2, 64, 64, 21)), cuda)
    peak[1, 10, 37, 4] = 1e4
    out = fused_softmax_decode(peak, torch.tensor(2.5, device=cuda))
    assert out[1, 4].tolist() == [37.0, 10.0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_decode_kernel_nan_and_inf(cuda, dtype):
    """B4's -inf and NaN rules against the twin, NaN where the twin has
    NaN and within 1e-4 px elsewhere: a 2x4 plane (8 ranges of one pixel)
    with one NaN logit; on 64x64 planes a joint whose first range of 512
    px is all NaN, one NaN amid -inf, -inf over part of a joint, over a
    whole range and over a whole joint (NaN)."""
    small = f32(np.random.default_rng(3).normal(size=(2, 2, 4, 3)), cuda)
    small[0, 1, 2, 1] = float("nan")
    x = f32(np.random.default_rng(4).normal(size=(2, 64, 64, 21)) * 3.0, cuda)
    x.view(2, 4096, 21)[0, :512, 5] = float("nan")
    x.view(2, 4096, 21)[1, :, 6] = -float("inf")
    x[1, 40, 3, 6] = float("nan")
    x[0, :, :8, 1] = -float("inf")
    x.view(2, 4096, 21)[1, 512:1024, 2] = -float("inf")
    x[0, :, :, 3] = -float("inf")
    for logits, temp in ((small, 1.0), (x, torch.tensor(1.7, device=cuda))):
        logits = logits.to(dtype)
        got = fused_softmax_decode(logits, temp).cpu()
        want = softmax_decode_reference(logits, temp).cpu()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        assert (got[ok] - want[ok]).abs().max().item() <= 1e-4
    assert torch.isnan(got[0, 5]).all() and torch.isnan(got[1, 6]).all()
    assert torch.isnan(got[0, 3]).all() and not torch.isnan(got[0, 1]).any()


def test_softmax_decode_kernel_refuses_bad_input(cuda):
    x = torch.zeros(2, 8, 8, 21, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_softmax_decode(x.half())
    with pytest.raises(ValueError, match="temperature on"):
        fused_softmax_decode(x, torch.tensor(1.0))
    with pytest.raises(ValueError, match="joints"):
        fused_softmax_decode(torch.zeros(1, 2, 2, 1025, device=cuda))


def test_small_eval_on_card(cuda):
    """Evaluator2D std on the card launches B4 once per batch and agrees
    with the same evaluation on the CPU (float32, TF32 off)."""
    from hrnet_hand_pose_estimation_tpu_torch.core.evaluator import Evaluator2D
    from hrnet_hand_pose_estimation_tpu_torch.data.build import make_test_dataloader

    cfg = small_cfg().clone()
    cfg.defrost()
    cfg.merge_from_list(["MODEL.HEATMAP_SOFTMAX", True, "TPU.COMPUTE_DTYPE", "float32",
                         "DATASET.TEST_DATASET", ["Synthetic_kpt"], "TEST.IMAGES_PER_GPU", 16,
                         "WORKERS", 0])
    cfg.freeze()
    state = init_variables(cfg, seed=2)
    results = {}
    for dev in ("cpu", cuda):
        loader = make_test_dataloader(cfg)["Synthetic_kpt"]
        before = fused_softmax_decode.launches
        results[str(dev)] = Evaluator2D(cfg, build_model(cfg), state, device=dev).run(loader)
        launched = fused_softmax_decode.launches - before
        assert launched == (len(loader) if str(dev) != "cpu" else 0)
    for key in ("EPE_px", "PCK_AUC_30", "PCK_AUC_full"):
        assert abs(results["cpu"][key] - results["cuda"][key]) <= 1e-3, key


def basic_int8_params(rng, c, n_blocks, device):
    """A W8A8 branch chain's flat params with scales that keep the int8
    intermediate inside +-127 for |N(0, 1)| inputs (inv1 11.3)."""
    i8 = lambda: torch.from_numpy(rng.integers(-127, 128, size=(9 * c, c)).astype(np.int8)).to(device)
    params = []
    for _ in range(n_blocks):
        params += [f32(np.full((1, 1), 11.3), device), i8(),
                   f32(rng.uniform(0.5, 1.5, size=c) * 0.06 / np.sqrt(9 * c), device),
                   f32(rng.normal(size=c) * 5, device), i8(),
                   f32(rng.uniform(0.5, 1.5, size=c) * 1.4e-3 / np.sqrt(9 * c), device),
                   f32(rng.normal(size=c) * 0.3, device)]
    return tuple(params)


@pytest.mark.parametrize("batch", [1, 2, 3])
@pytest.mark.parametrize("c,size", [(32, 64), (64, 32), (128, 16), (256, 8),    # w32 branches
                                    (48, 64), (96, 32)])                        # w48 (C % 32 == 16)
def test_basic_int8_kernel_matches_twin(cuda, c, size, batch):
    """The W8A8 BasicBlock chain at every w32 branch shape and two w48 ones;
    one launch per block.  Expected bit-equal; gated at 0.02 max|out|."""
    rng = np.random.default_rng(c + batch)
    params = basic_int8_params(rng, c, 2, cuda)
    x = bf16(np.abs(rng.normal(size=(batch, size, size, c))), cuda)
    before = fused_basic_chain_int8.launches
    got = fused_basic_chain_int8(x, params, 2)
    torch.cuda.synchronize()
    assert fused_basic_chain_int8.launches == before + 2
    want = basic_chain_int8_reference(x, params, 2)
    limit = 0.02 * max(1.0, want.float().abs().max().item())
    assert got.shape == want.shape == (batch, size, size, c) and want.float().std().item() > 0.1
    assert (got.float() - want.float()).abs().max().item() <= limit


def test_basic_int8_kernel_refuses_channels_it_cannot_take(cuda):
    rng = np.random.default_rng(1)
    params = basic_int8_params(rng, 40, 1, cuda)
    x = bf16(np.abs(rng.normal(size=(1, 8, 8, 40))), cuda)
    before = fused_basic_chain_int8.launches
    with pytest.raises(ValueError, match="C % 16"):
        fused_basic_chain_int8(x, params, 1)
    assert fused_basic_chain_int8.launches == before


def n_major_views(params):
    """A flat int8 param tuple with every kq as the (K, N) view of N-major
    storage, as prepare_branch_int8 and prepare_layer1_int8 make it."""
    return tuple(t.t().contiguous().t() if t.dtype == torch.int8 else t for t in params)


@pytest.mark.parametrize("n_major", [False, True])
@pytest.mark.parametrize("batch,h,w,c", [
    (2, 64, 64, 32), (2, 32, 32, 64), (2, 16, 16, 128), (2, 8, 8, 256),   # w32 branches
    (2, 64, 64, 48), (2, 32, 32, 96), (2, 16, 16, 192), (2, 8, 8, 384),   # w48 branches
    (1, 64, 64, 32), (1, 8, 8, 256),                                       # B = 1
    (2, 13, 21, 32), (1, 11, 9, 64), (1, 9, 7, 128), (2, 5, 3, 48),        # ragged tiles
    (1, 16, 16, 16), (2, 10, 12, 80)])                                     # 16; 80 padded to 96
def test_basic_int8_kernel_tile_edges_and_layouts(cuda, n_major, batch, h, w, c):
    """The W8A8 BasicBlock chain bit-equal to its twin at every w32 and w48
    branch shape, B = 1, tiles cut by the image's edge, the narrowest width
    and a width run zero-padded, with N-major or plain kq's; one launch per
    block."""
    rng = np.random.default_rng(c * 7 + h + batch)
    params = basic_int8_params(rng, c, 2, cuda)
    if n_major:
        params = n_major_views(params)
    x = bf16(np.abs(rng.normal(size=(batch, h, w, c))), cuda)
    before = fused_basic_chain_int8.launches
    got = fused_basic_chain_int8(x, params, 2)
    torch.cuda.synchronize()
    assert fused_basic_chain_int8.launches == before + 2
    want = basic_chain_int8_reference(x, params, 2)
    assert got.shape == want.shape == (batch, h, w, c) and want.float().std().item() > 0.1
    assert torch.equal(got, want)


@pytest.mark.parametrize("batch", [1, 3, 32])
def test_head_v1_kernel_matches_twin(cuda, batch):
    """v1 of the head at the w32 widths on a 64x64 map: one launch per
    call; within 0.05 px of the twin."""
    rng = np.random.default_rng(batch)
    widths = (32, 64, 128, 256)
    xs = [bf16(np.abs(rng.normal(size=(batch, 64 >> i, 64 >> i, c))), cuda)
          for i, c in enumerate(widths)]
    n, k = sum(widths), 21
    params = HeadParams(f32(rng.normal(size=(n, n)) * 0.05, cuda), f32(rng.normal(size=n) * 0.1, cuda),
                        f32(rng.normal(size=(n, k)) * 0.1, cuda), f32(rng.normal(size=k) * 0.1, cuda),
                        f32(np.float32(1.3), cuda))
    before = fused_head_decode.launches
    got = fused_head_decode(xs, params)
    torch.cuda.synchronize()
    assert fused_head_decode.launches == before + 1
    want = head_decode_v1_reference(xs, params)
    assert got.shape == (batch, k, 2) and want.std().item() > 0.5
    assert (got - want).abs().max().item() <= 0.05


# the branch widths of the HRNet widths and of experiments/synthetic_smoke.yaml
V1_WIDTHS = {"w18": (18, 36, 72, 144), "w32": (32, 64, 128, 256), "w40": (40, 80, 160, 320),
             "w48": (48, 96, 192, 384), "smoke": (8, 16, 32, 64)}


@pytest.mark.parametrize("name,k,batch", [(n, 21, b) for n in V1_WIDTHS for b in (1, 4)]
                         + [("w32", 128, 2), ("w18", 128, 1), ("smoke", 128, 3), ("w48", 70, 2)])
def test_head_v1_kernel_takes_every_width(cuda, name, k, batch):
    """C10: v1 at every width JAX's v1 takes, channels that are no multiple
    of 8 (w18), Ctot 600 (w40), the 128-row feat tile that does not fit
    (w48), the smoke model's 16x16 map, K up to 128: one launch, within
    0.05 px of the twin.  The final conv's weights are drawn at 0.3 on the
    16x16 map, so that the coordinates spread there too."""
    rng = np.random.default_rng(batch + k)
    widths = V1_WIDTHS[name]
    h0 = 16 if name == "smoke" else 64
    xs = [bf16(np.abs(rng.normal(size=(batch, h0 >> i, h0 >> i, c))), cuda)
          for i, c in enumerate(widths)]
    n = sum(widths)
    params = HeadParams(f32(rng.normal(size=(n, n)) * 0.05, cuda), f32(rng.normal(size=n) * 0.1, cuda),
                        f32(rng.normal(size=(n, k)) * (0.3 if name == "smoke" else 0.1), cuda),
                        f32(rng.normal(size=k) * 0.1, cuda), f32(np.float32(1.3), cuda))
    before = fused_head_decode.launches
    got = fused_head_decode(xs, params)
    torch.cuda.synchronize()
    assert fused_head_decode.launches == before + 1
    want = head_decode_v1_reference(xs, params)
    assert got.shape == (batch, k, 2) and want.std().item() > 0.5
    assert (got - want).abs().max().item() <= 0.05


@pytest.mark.parametrize("batch", [1, 32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_decode_kernel_splits(cuda, batch, dtype):
    """B4 at the eval path's 64x64x21 planes with the plan's split of each
    plane over a cluster (8 ranges of 512 px at every B): one launch,
    within 1e-4 px of the twin and of the split's plain mirror."""
    rng = np.random.default_rng(batch)
    x = f32(rng.normal(size=(batch, 64, 64, 21)) * 3.0, cuda).to(dtype)
    temp = torch.tensor(1.7, device=cuda)
    plan = decode_plan(batch, 64, 64, 21, x.element_size())
    before = fused_softmax_decode.launches
    got = fused_softmax_decode(x, temp)
    torch.cuda.synchronize()
    assert fused_softmax_decode.launches == before + 1
    assert (got - softmax_decode_reference(x, temp)).abs().max().item() <= 1e-4
    mirror = softmax_decode_split_reference(x, temp, plan.splits, plan.piece_px)
    assert (got.double() - mirror).abs().max().item() <= 1e-4


# -- the multi-view 3D inference and evaluation slice ------------------------

def mv_cameras(b, v, f, c):
    """(B, V, 3, 4) projections of cameras 900 mm out, 0.9 rad apart on a
    ring and tilted about x, with focal f and principal point c."""
    K = np.array([[f, 0, c[0]], [0, f, c[1]], [0, 0, 1]], np.float32)
    projs = []
    for i in range(v):
        ang, tx = 0.3 + 0.9 * i, 0.2 + 0.15 * i
        ry = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
        rx = np.array([[1, 0, 0], [0, np.cos(tx), -np.sin(tx)], [0, np.sin(tx), np.cos(tx)]])
        projs.append(K @ np.concatenate([rx @ ry, [[0], [0], [900.0]]], 1))
    return torch.from_numpy(np.broadcast_to(np.stack(projs), (b, v, 3, 4)).astype(np.float32).copy())


def small_3d_cfg(**opts):
    cfg = small_cfg().clone()
    cfg.defrost()
    cfg.merge_from_list(["MODEL.HEATMAP_SOFTMAX", True, "MODEL.VOLUME_SIZE", 32,
                         "MODEL.CUBOID_SIZE", 400.0, "MODEL.VOL_CONFIDENCES", False,
                         "TPU.COMPUTE_DTYPE", "float32"] + [x for kv in opts.items() for x in kv])
    return cfg.freeze()


@pytest.mark.parametrize("kind,opts", [("alg", {"MODEL.ALG_CONFIDENCES": True}), ("ransac", {}),
                                       ("vol", {}), ("vol", {"MODEL.VOL_CONFIDENCES": True,
                                                             "MODEL.VOLUME_AGGREGATION_METHOD":
                                                                 "conf_norm"})])
def test_triangulation_net_on_card_matches_cpu(cuda, kind, opts):
    """Each net at small widths (V2V at 32^3), float32 with TF32 off, on the
    card against the same net on the CPU: one B4 launch per forward, the 2D
    keypoints within 1e-3 heatmap px, the 3D ones within 0.5 mm + 1e-3."""
    from hrnet_hand_pose_estimation_tpu_torch.models.triangulation import build_triangulation_net

    cfg = small_3d_cfg(**opts)
    state = init_variables(cfg, 0, net=kind)
    rng = np.random.default_rng(7)
    images = torch.from_numpy(rng.normal(size=(2, 3, 64, 64, 3)).astype(np.float32))
    proj = mv_cameras(2, 3, *((15.0, (7.5, 7.5)) if kind == "vol" else (600.0, (320.0, 240.0))))
    nets = []
    for dev in ("cpu", cuda):
        net = build_triangulation_net(cfg, kind, dtype=torch.float32)
        net.load_state_dict(state)
        nets.append(net.to(dev))
    with torch.no_grad():
        want = nets[0](images, proj)
        before = fused_softmax_decode.launches
        got = nets[1](images.to(cuda), proj.to(cuda))
        torch.cuda.synchronize()
    assert fused_softmax_decode.launches == before + 1
    scale = 1.0 if kind == "vol" else torch.tensor([640 / 16, 480 / 16])
    assert ((got.keypoints_2d.cpu() - want.keypoints_2d) / scale).abs().max().item() <= 1e-3
    d3 = (got.keypoints_3d.cpu() - want.keypoints_3d).abs()
    assert (d3 <= 0.5 + 1e-3 * want.keypoints_3d.abs()).all(), d3.max().item()
    if kind == "vol":
        assert got.volumes.shape == (2, 32, 32, 32, 21)
        assert (got.volumes.double().sum(dim=(1, 2, 3)) - 1).abs().max().item() <= 1e-4


def test_evaluator3d_dlt_mode_on_card_matches_cpu(cuda):
    """The dlt mode's forward (the 2D model per view, decoded by B4: one
    launch) and its SII DLT on the card against the CPU."""
    from hrnet_hand_pose_estimation_tpu_torch.core.evaluator3d import Evaluator3D
    from hrnet_hand_pose_estimation_tpu_torch.ops.geometry import triangulate_batch

    cfg = small_3d_cfg()
    state = init_variables(cfg, 0)
    rng = np.random.default_rng(8)
    images = torch.from_numpy(rng.normal(size=(2, 3, 64, 64, 3)).astype(np.float32))
    proj = mv_cameras(2, 3, 600.0, (320.0, 240.0))
    out = []
    for dev in ("cpu", cuda):
        ev = Evaluator3D(cfg, build_model(cfg), state, mode="dlt", device=dev)
        before = fused_softmax_decode.launches
        kp2d, kp3d = ev.forward(images.to(dev), proj.to(dev))
        torch.cuda.synchronize()
        assert kp3d is None
        assert fused_softmax_decode.launches == before + (dev != "cpu")
        kp2d = kp2d * torch.tensor([640 / 16, 480 / 16], device=dev)
        out.append((kp2d.cpu(), triangulate_batch(kp2d, proj.to(dev), method="sii").cpu()))
    assert ((out[1][0] - out[0][0]) / torch.tensor([40.0, 30.0])).abs().max().item() <= 1e-3
    assert torch.allclose(out[1][1], out[0][1], rtol=1e-3, atol=0.5)


# -- B4's backward and the 3D train step ------------------------------------

@pytest.mark.parametrize("shape", [(8, 64, 64, 21), (3, 48, 40, 17), (2, 7, 5, 3), (1, 1, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tensor_temp", [True, False])
def test_softmax_decode_backward_matches_twin(cuda, shape, dtype, tensor_temp):
    """The backward kernel against ``softmax_decode_backward_reference``:
    dx within one bfloat16 ulp of each element (bf16) plus 1e-5 of the
    largest, dT within 1e-4 of sum |x g_z|; two runs bit-equal; one
    backward launch per backward."""
    from hrnet_hand_pose_estimation_tpu_torch.ops.kernels import softmax_decode as SD

    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = (torch.randn(*shape, device=cuda, generator=gen) * 3).to(dtype)
    g = torch.randn(shape[0], shape[3], 2, device=cuda, generator=gen)
    temp = torch.tensor(1.7, device=cuda, requires_grad=True) if tensor_temp else 1.7

    def grads():
        xr = x.clone().requires_grad_(True)
        return torch.autograd.grad(fused_softmax_decode(xr, temp),
                                   (xr, temp) if tensor_temp else (xr,), g)

    before = fused_softmax_decode.launches_bwd
    got, again = grads(), grads()
    torch.cuda.synchronize()
    assert fused_softmax_decode.launches_bwd == before + 2
    tv = temp.detach() if tensor_temp else temp
    dx, dt = SD.softmax_decode_backward_reference(x, tv, SD.softmax_decode_stats_reference(x, tv), g)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    err = (got[0].float() - dx.float()).abs()
    assert got[0].dtype == dtype
    assert (err <= ulp * dx.float().abs() + 1e-5 * dx.float().abs().max() + 1e-30).all()
    if tensor_temp:
        scale = (x.float() * dx.float() / 1.7).abs().sum().item()
        assert abs(got[1].item() - dt.item()) <= 1e-4 * scale + 1e-12
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tensor_temp", [True, False])
def test_softmax_decode_backward_misaligned_view(cuda, dtype, tensor_temp):
    """Logits that are a contiguous view one element into a larger buffer
    (not 16-byte aligned, as a batch slice can be): the wrapper copies them
    for the kernel's 16-byte loads, so the gradients are bit-equal to those
    of an aligned copy, with one backward launch each."""
    shape = (3, 48, 40, 17)
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = (torch.randn(*shape, device=cuda, generator=gen) * 3).to(dtype)
    g = torch.randn(shape[0], shape[3], 2, device=cuda, generator=gen)
    temp = torch.tensor(1.7, device=cuda, requires_grad=True) if tensor_temp else 1.7

    def grads(xr):
        return torch.autograd.grad(fused_softmax_decode(xr, temp),
                                   (xr, temp) if tensor_temp else (xr,), g)

    buf = torch.cat([x.new_zeros(1), x.flatten()]).requires_grad_(True)
    view = buf[1:].view(shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    before = fused_softmax_decode.launches_bwd
    got = grads(view)
    want = grads(x.clone().requires_grad_(True))
    torch.cuda.synchronize()
    assert fused_softmax_decode.launches_bwd == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_softmax_decode_backward_refuses_bad_input(cuda):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_softmax_decode(torch.zeros(1, 4, 4, 3, device=cuda, dtype=torch.float16,
                                         requires_grad=True), 1.0)
    with pytest.raises(ValueError, match="temperature on"):
        fused_softmax_decode(torch.zeros(1, 4, 4, 3, device=cuda, requires_grad=True),
                             torch.ones((), requires_grad=True))


@pytest.mark.parametrize("kind", ["alg", "vol"])
def test_train_step_3d_on_card_matches_cpu(cuda, kind):
    """One float32 3D train step (TF32 off) at small widths on the card and on
    the CPU: one B4 forward and one backward launch on the card, a finite
    loss and a non-zero head gradient; for alg the total loss within 1e-3
    of the CPU's and the head's gradient within 1e-2 in norm (the vol step
    is chaotic at this size: V2V's innermost BNs normalise 2 values, see
    tests/test_torch_trainer3d_vol.py)."""
    from hrnet_hand_pose_estimation_tpu_torch.core import trainer3d as T3
    from hrnet_hand_pose_estimation_tpu_torch.models.triangulation import (
        build_triangulation_net)

    cfg = small_3d_cfg(**{"MODEL.TRIANGULATION_MODEL_NAME": kind, "LOSS.WITH_HEATMAP_LOSS": False,
                          "LOSS.WITH_POSE2D_LOSS": kind == "vol", "LOSS.WITH_POSE3D_LOSS": True,
                          "LOSS.WITH_VOLUMETRIC_CE_LOSS": kind == "vol",
                          "TRAIN.OPTIMIZER": "adam"})
    state_dict = init_variables(cfg, 0, net=kind)
    rng = np.random.default_rng(9)
    # the cameras of test_triangulation_net_on_card_matches_cpu as K and [R|t]
    # at the original scale (vol: a 64 px image, rescaled to the 16 px map)
    f, c = (60.0, 30.0) if kind == "vol" else (600.0, 320.0)
    K = torch.tensor([[f, 0, c], [0, f, c if kind == "vol" else 240.0], [0, 0, 1]])
    ext = mv_cameras(2, 2, 1.0, (0.0, 0.0))           # an identity K: [R|t]
    batch = {"images": torch.from_numpy(rng.normal(size=(2, 2, 64, 64, 3)).astype(np.float32)),
             "pose2d": torch.from_numpy(rng.uniform(2, 14, size=(2, 2, 21, 2)).astype(np.float32)),
             "pose3d": torch.from_numpy(rng.uniform(-100, 100, size=(2, 21, 3)).astype(np.float32)),
             "visibility": torch.ones(2, 2, 21), "intrinsic_matrix": K.expand(2, 3, 3).clone(),
             "extrinsic_matrices": ext}
    out = []
    for dev in ("cpu", cuda):
        net = build_triangulation_net(cfg, kind, dtype=torch.float32)
        net.load_state_dict(state_dict)
        net.to(dev).train()
        tx = T3.make_optimizer_3d(cfg, net, 1000)
        state = TS.TrainState(net, tx)
        step = T3.make_train_step_3d(cfg, net, tx, (64, 64) if kind == "vol" else (640, 480))
        launches = (fused_softmax_decode.launches, fused_softmax_decode.launches_bwd)
        gen = torch.Generator(device=dev).manual_seed(0)
        _, losses = step(state, {k: v.to(dev) for k, v in batch.items()}, gen)
        torch.cuda.synchronize()
        n = int(dev != "cpu")
        assert (fused_softmax_decode.launches, fused_softmax_decode.launches_bwd) == (
            launches[0] + n, launches[1] + n)
        named = dict(zip(state.param_names, torch.split(
            state.grads, [p.numel() for p in net.parameters()])))
        head = torch.cat([v for k, v in named.items() if k.startswith("backbone.last_layer.")])
        out.append((float(losses["total_loss"]), head.cpu()))
    if kind == "alg":
        assert abs(out[1][0] - out[0][0]) <= 1e-3 * abs(out[0][0])
        assert (out[1][1] - out[0][1]).norm() <= 1e-2 * out[0][1].norm()
    assert out[1][1].abs().max() > 0 and np.isfinite(out[1][0])


def test_vol_step_draws_the_sliced_global_angles_on_card(cuda):
    """One process's vol train step on the card (world size 1): the cuboid
    turns are ``cuboid_angles``' global draw from the step's generator,
    sliced to this rank, which for one rank is the whole draw: the angles
    ``torch.rand(b)`` gives a generator seeded alike, times 2 pi."""
    import math

    from hrnet_hand_pose_estimation_tpu_torch.core import trainer3d as T3
    from hrnet_hand_pose_estimation_tpu_torch.models import triangulation as TRI

    cfg = small_3d_cfg(**{"MODEL.TRIANGULATION_MODEL_NAME": "vol",
                          "LOSS.WITH_HEATMAP_LOSS": False, "LOSS.WITH_POSE2D_LOSS": True,
                          "LOSS.WITH_POSE3D_LOSS": True, "LOSS.WITH_VOLUMETRIC_CE_LOSS": True,
                          "TRAIN.OPTIMIZER": "adam"})
    rng = np.random.default_rng(19)
    K = torch.tensor([[60.0, 0, 30.0], [0, 60.0, 30.0], [0, 0, 1]])
    batch = {"images": torch.from_numpy(rng.normal(size=(2, 2, 64, 64, 3)).astype(np.float32)),
             "pose2d": torch.from_numpy(rng.uniform(2, 14, size=(2, 2, 21, 2)).astype(np.float32)),
             "pose3d": torch.from_numpy(rng.uniform(-100, 100, size=(2, 21, 3)).astype(np.float32)),
             "visibility": torch.ones(2, 2, 21), "intrinsic_matrix": K.expand(2, 3, 3).clone(),
             "extrinsic_matrices": mv_cameras(2, 2, 1.0, (0.0, 0.0))}
    net = TRI.build_triangulation_net(cfg, "vol", dtype=torch.float32)
    net.load_state_dict(init_variables(cfg, 0, net="vol"))
    net.to(cuda).train()
    tx = T3.make_optimizer_3d(cfg, net, 1000)
    step = T3.make_train_step_3d(cfg, net, tx, (64, 64))
    drawn, real = [], TRI.cuboid_angles

    def record(*args):
        drawn.append(real(*args))
        return drawn[-1]

    TRI.cuboid_angles = record
    try:
        _, losses = step(TS.TrainState(net, tx), {k: v.to(cuda) for k, v in batch.items()},
                         torch.Generator(device=cuda).manual_seed(5))
    finally:
        TRI.cuboid_angles = real
    want = torch.rand(2, generator=torch.Generator(device=cuda).manual_seed(5),
                      device=cuda) * (2.0 * math.pi)
    assert len(drawn) == 1 and drawn[0].device.type == "cuda"
    assert torch.equal(drawn[0], want) and np.isfinite(float(losses["total_loss"]))


# -- CPM, the fusion net and vol_CPM ------------------------------------------

def test_cpm_forward_on_card_matches_cpu(cuda):
    """CPM at 64x64 (seeded ``init_variables`` weights), float32 with TF32
    off: the six belief maps on the card within 1e-4 of their largest value
    of the CPU's; the bf16 autocast forward on the card finite, within 5 %
    of the float32 maps' largest value."""
    cfg = load_config(opts=["MODEL.NAME", "CPM", "MODEL.IMAGE_SIZE", [64, 64],
                            "MODEL.HEATMAP_SIZE", [8, 8]])
    state = init_variables(cfg, 0)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(2, 64, 64, 3)).astype(np.float32))
    cm = torch.from_numpy(rng.uniform(size=(2, 64, 64, 1)).astype(np.float32))
    out = []
    for dev in ("cpu", cuda):
        model = build_model(cfg)
        model.load_state_dict(state)
        model.to(dev)
        with torch.no_grad():
            out.append([b.cpu() for b in model(x.to(dev), cm.to(dev))])
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        low = model(x.to(cuda), cm.to(cuda))[-1].cpu()
    for got, want in zip(out[1], out[0]):
        assert got.shape == (2, 8, 8, 22)
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    scale = out[0][-1].abs().max().item()
    assert torch.isfinite(low).all() and (low - out[0][-1]).abs().max().item() <= 0.05 * scale


def test_mv_step_b4_matches_twin_on_card(cuda):
    """The fusion net's train step at small widths (2 views, 16x16 maps,
    float32, TF32 off, cuDNN deterministic): one B4 forward and one backward
    launch; from the same state, the step decoded by the kernels and the
    step decoded by B4's twin (and the twin's autograd) give losses within
    1e-5 and gradients within 1e-4 in norm; the step on the card within
    1e-3 of the CPU's loss."""
    from hrnet_hand_pose_estimation_tpu_torch.core import train_variants as TV
    from hrnet_hand_pose_estimation_tpu_torch.data.synthetic import SyntheticMultiViewDataset

    cfg = small_cfg().clone()
    cfg.defrost()
    cfg.merge_from_list(["MODEL.NAME", "multiview_pose_hrnet", "DATASET.NUM_VIEWS", 2,
                         "MODEL.HEATMAP_SOFTMAX", True, "MODEL.TRAINABLE_SOFTMAX", True,
                         "LOSS.WITH_HEATMAP_LOSS", True, "LOSS.WITH_POSE2D_LOSS", True,
                         "TPU.COMPUTE_DTYPE", "float32", "TRAIN.OPTIMIZER", "adam"])
    cfg.freeze()
    ds = SyntheticMultiViewDataset(cfg, "training")
    samples = [ds[i] for i in range(2)]
    batch = {"images": torch.from_numpy(np.stack([s["imgs"] for s in samples])),
             "pose2d": torch.from_numpy(np.stack([s["pose2d"] for s in samples])),
             "visibility": torch.ones(2, 2, 21),
             "target_heatmaps": torch.from_numpy(np.stack([s["heatmaps"] for s in samples]))}
    state_dict = init_variables(cfg, 0)
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, dev, decode in (("cpu", "cpu", None), ("kernel", cuda, None),
                                  ("twin", cuda, softmax_decode_reference)):
            model = build_model(cfg)
            st, tx = TS.create_train_state(cfg, model, device=dev)
            model.load_state_dict(state_dict)
            step = TV.make_train_step_mv(cfg, model, tx)
            real = TV.softmax_decode
            if decode is not None:
                TV.softmax_decode = decode
            launches = (fused_softmax_decode.launches, fused_softmax_decode.launches_bwd)
            try:
                _, losses = step(st, {k: v.to(dev) for k, v in batch.items()})
                torch.cuda.synchronize()
            finally:
                TV.softmax_decode = real
            n = int(name == "kernel")
            assert (fused_softmax_decode.launches, fused_softmax_decode.launches_bwd) == (
                launches[0] + n, launches[1] + n), name
            runs[name] = (float(losses["total_loss"]), st.grads.cpu().clone())
    finally:
        torch.backends.cudnn.deterministic = False
    (lk, gk), (lt, gt), (lc, _) = runs["kernel"], runs["twin"], runs["cpu"]
    assert np.isfinite(lk) and gk.abs().max() > 0
    assert abs(lk - lt) <= 1e-5 * abs(lt)
    assert (gk - gt).norm() <= 1e-4 * gt.norm()
    assert abs(lk - lc) <= 1e-3 * abs(lc)


def test_vol_cpm_forward_on_card_matches_cpu(cuda):
    """vol_CPM at 64x64 (8x8 maps, V2V at 32^3, HEATMAP_SOFTMAX on), float32
    with TF32 off: one B4 launch per forward on the card, the 2D keypoints
    within 1e-3 heatmap px and the 3D ones within 0.5 mm + 1e-3 of the CPU's."""
    from hrnet_hand_pose_estimation_tpu_torch.models.triangulation import build_triangulation_net

    cfg = small_3d_cfg(**{"MODEL.HEATMAP_SIZE": [8, 8]})
    state = init_variables(cfg, 0, net="vol_CPM")
    rng = np.random.default_rng(12)
    images = torch.from_numpy(rng.normal(size=(2, 2, 64, 64, 3)).astype(np.float32))
    proj = mv_cameras(2, 2, 7.5, (3.5, 3.5))
    nets = []
    for dev in ("cpu", cuda):
        net = build_triangulation_net(cfg, "vol_CPM", dtype=torch.float32)
        net.load_state_dict(state)
        nets.append(net.to(dev))
    with torch.no_grad():
        want = nets[0](images, proj)
        before = fused_softmax_decode.launches
        got = nets[1](images.to(cuda), proj.to(cuda))
        torch.cuda.synchronize()
    assert fused_softmax_decode.launches == before + 1
    assert got.heatmaps.shape == (2, 2, 8, 8, 21)
    assert (got.keypoints_2d.cpu() - want.keypoints_2d).abs().max().item() <= 1e-3
    d3 = (got.keypoints_3d.cpu() - want.keypoints_3d).abs()
    assert (d3 <= 0.5 + 1e-3 * want.keypoints_3d.abs()).all(), d3.max().item()


# -- the single-image model zoo ------------------------------------------------

def zoo_cfg(name):
    """A small config of a zoo model at 64x64 (16x16 maps, small_cfg's
    HRNet stages for the hamburger), float32."""
    cfg = small_cfg().clone()
    cfg.defrost()
    opts = {"swin_transformer": ["MODEL.EMB_DIM", [16], "MODEL.DEPTHS", [2, 2, 2, 2],
                                 "MODEL.NUM_HEADS", [2, 2, 2, 2], "MODEL.FF_TYPE", "le_ff"],
            "pose_hrnet_hamburger": ["MODEL.R", 16, "MODEL.TRAIN_STEPS", 3,
                                     "MODEL.EVAL_STEPS", 4],
            "pose_resnet": ["MODEL.EXTRA.NUM_LAYERS", 18,
                            "MODEL.EXTRA.NUM_DECONV_FILTERS", [32, 32, 32]],
            "my_pose_transformer": ["MODEL.IMAGE_SIZE", [128, 128], "MODEL.PATCH_SIZE", 2,
                                    "MODEL.EMB_DIM", [8, 8], "MODEL.DEPTHS", [1, 1],
                                    "MODEL.NUM_HEADS", [2, 2], "MODEL.BACKBONE_NAME",
                                    "resnet18"]}[name]
    cfg.merge_from_list(["MODEL.NAME", name, "MODEL.HEATMAP_SOFTMAX", True,
                         "MODEL.TRAINABLE_SOFTMAX", True, "TPU.COMPUTE_DTYPE", "float32"] + opts)
    return cfg.freeze()


def zoo_pair(cfg, device):
    """(the model on the CPU, the same weights on ``device``), eval mode."""
    state = init_variables(cfg, 0)
    models = []
    for dev in ("cpu", device):
        model = build_model(cfg)
        model.load_state_dict(state)
        models.append(model.to(dev).eval())
    return models


@pytest.mark.parametrize("name", ["swin_transformer", "pose_hrnet_hamburger", "pose_resnet",
                                  "my_pose_transformer"])
def test_zoo_forward_on_card_matches_cpu(cuda, name):
    """Each zoo model's float32 forward (TF32 off) on the card: its maps
    within 1e-4 of their largest value of the CPU's (the RVT's poses within
    1e-3 px), decoded coordinates within 1e-3 px."""
    cfg = zoo_cfg(name)
    cpu, card = zoo_pair(cfg, cuda)
    size = int(cfg.MODEL.IMAGE_SIZE[0])
    x = torch.from_numpy(np.random.default_rng(13).normal(size=(2, size, size, 3)).astype(
        np.float32))
    with torch.no_grad():
        want, got = cpu(x), card(x.to(cuda))
    if name == "my_pose_transformer":
        assert got.shape == (2, 21, 2)
        assert (got.cpu() - want).abs().max().item() <= 1e-3
        return
    hm, want_hm = got.heatmaps.cpu(), want.heatmaps
    assert hm.shape == (2, 16, 16, 21)
    assert (hm - want_hm).abs().max().item() <= 1e-4 * want_hm.abs().max().item()
    if name != "pose_resnet":      # soft-argmax of probabilities: coordinates
        d = (TS.decode_heatmaps(hm, True) - TS.decode_heatmaps(want_hm, True)).abs().max()
        assert d.item() <= 1e-3


@pytest.mark.parametrize("name", ["swin_transformer", "pose_hrnet_hamburger"])
def test_zoo_evaluator_decodes_through_one_b4_launch(cuda, name):
    """``Evaluator2D`` on the card decodes a swin or hamburger batch with one
    B4 launch, within 1e-4 px of B4's twin on the same logits."""
    from hrnet_hand_pose_estimation_tpu_torch.core.evaluator import Evaluator2D

    cfg = zoo_cfg(name)
    _, card = zoo_pair(cfg, cuda)
    ev = Evaluator2D(cfg, card, None, device=cuda)
    assert ev.decode_logits
    x = torch.from_numpy(np.random.default_rng(14).normal(size=(8, 64, 64, 3)).astype(
        np.float32)).to(cuda)
    before = fused_softmax_decode.launches
    got = ev.forward(x)
    torch.cuda.synchronize()
    assert fused_softmax_decode.launches == before + 1
    with torch.no_grad():
        logits, temp = card.forward_logits(x)
    want = softmax_decode_reference(logits, temp)
    assert got.shape == (8, 21, 2)
    assert (got - want).abs().max().item() <= 1e-4


def test_hamburger_train_gradient_on_card_matches_cpu(cuda):
    """The hamburger's float32 train-mode gradient (BN on batch statistics,
    3 ham steps, the last differentiated) of a linear function of its
    probabilities on the card, TF32 off, against the CPU's float64 gradient
    of the same weights: within the larger of 1e-3 of max|g| and twice the
    CPU's own float32 distance from it (this small net's coarsest branch
    gives its BNs 8 values at B=2: the CPU's float32 gradient is 8e-3 of
    max|g| from its float64 one)."""
    cfg = zoo_cfg("pose_hrnet_hamburger")
    cpu, card = zoo_pair(cfg, cuda)
    cpu64 = build_model(cfg)
    cpu64.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.normal(size=(2, 64, 64, 3)))
    r = torch.from_numpy(rng.normal(size=(2, 16, 16, 21)))
    grads = []
    for model, dev, dtype in ((cpu64, "cpu", torch.float64), (cpu, "cpu", torch.float32),
                              (card, cuda, torch.float32)):
        model.to(dtype).train()
        (model(x.to(dev, dtype)).heatmaps.double() * r.to(dev)).sum().backward()
        grads.append({n: p.grad.cpu().double() for n, p in model.named_parameters()
                      if p.grad is not None})
    exact, cpu32, card32 = grads
    assert set(exact) == set(cpu32) == set(card32)
    gmax = max(g.abs().max().item() for g in exact.values())
    witness = max((cpu32[n] - g).abs().max().item() for n, g in exact.items())
    gap = max((card32[n] - g).abs().max().item() for n, g in exact.items())
    assert gap <= max(1e-3 * gmax, 2 * witness), (gap / gmax, witness / gmax)


# -- the temporal family -------------------------------------------------------

def temporal_cfg(name):
    """small_cfg's HRNet at 64x64 as the temporal model ``name``: 3 frames,
    dilations 1 and 2, the pose loss, float32."""
    cfg = small_cfg().clone()
    cfg.defrost()
    cfg.merge_from_list(["MODEL.NAME", name, "DATASET.SEQ_IDX", [-1, 0, 1],
                         "MODEL.DILATION_RATES", [1, 2], "MODEL.HEATMAP_SOFTMAX", True,
                         "MODEL.TRAINABLE_SOFTMAX", True, "TPU.COMPUTE_DTYPE", "float32",
                         "LOSS.WITH_HEATMAP_LOSS", False, "LOSS.WITH_POSE2D_LOSS", True])
    return cfg.freeze()


def temporal_frames(b, device, seed=17):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(b, 3, 64, 64, 3)).astype(
        np.float32)).to(device)


@pytest.mark.parametrize("dilation", [1, 6])
def test_deform_conv_on_card_matches_cpu(cuda, dilation):
    """PoseAggr's grouped deformable conv at its full shape (10 frames of
    64x64x21, one offset field per joint, offsets of std 3 px) on the card,
    TF32 off: the output within 1e-5 and the gradients of x, the offsets and
    the weight within 1e-4 of their largest value of the CPU's."""
    from hrnet_hand_pose_estimation_tpu_torch.ops.deform_conv import deform_conv2d

    rng = np.random.default_rng(16)
    arrays = (rng.normal(size=(10, 64, 64, 21)), 3 * rng.normal(size=(10, 64, 64, 21 * 18)),
              rng.normal(size=(3, 3, 21, 21)) / np.sqrt(189))
    r = torch.from_numpy(rng.normal(size=(10, 64, 64, 21)).astype(np.float32))
    outs, grads = [], []
    for dev in ("cpu", cuda):
        leaves = [torch.from_numpy(a.astype(np.float32)).to(dev).requires_grad_() for a in arrays]
        out = deform_conv2d(*leaves, padding=dilation, dilation=dilation, deformable_groups=21)
        (out * r.to(dev)).sum().backward()
        outs.append(out.detach().cpu())
        grads.append([leaf.grad.cpu() for leaf in leaves])
    assert (outs[1] - outs[0]).abs().max() <= 1e-5 * outs[0].abs().max()
    for want, got in zip(*grads):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_pose_aggr_on_card(cuda):
    """PoseAggr with a float32 offset chain on the card, TF32 off: the
    probabilities within 1e-4 of their largest value of the CPU's;
    ``Evaluator2D`` on the registry's net (its offset chain in bfloat16)
    decodes a batch with one B4 launch, within 1e-4 px of B4's twin on the
    same fused logits."""
    from hrnet_hand_pose_estimation_tpu_torch.core.evaluator import Evaluator2D
    from hrnet_hand_pose_estimation_tpu_torch.models.hrnet import hrnet_from_cfg
    from hrnet_hand_pose_estimation_tpu_torch.models.pose_aggr import PoseAggrNet

    cfg = temporal_cfg("pose_hrnet_PoseAggr")
    state = init_variables(cfg, 0)
    x = temporal_frames(2, "cpu")
    outs = []
    for dev in ("cpu", cuda):
        net = PoseAggrNet(hrnet_from_cfg(cfg, head="plain"), seq_len=3, dilation_rates=(1, 2),
                          trainable_softmax=True, offset_dtype=torch.float32)
        net.load_state_dict(state)
        with torch.no_grad():
            outs.append(net.to(dev).eval()(x.to(dev)).heatmaps.cpu())
    assert (outs[1] - outs[0]).abs().max() <= 1e-4 * outs[0].abs().max()

    model = build_model(cfg)
    model.load_state_dict(state)
    model.to(cuda).eval()
    ev = Evaluator2D(cfg, model, None, device=cuda)
    assert ev.decode_logits
    frames = temporal_frames(4, cuda)
    before = fused_softmax_decode.launches
    got = ev.forward(frames)
    torch.cuda.synchronize()
    assert fused_softmax_decode.launches == before + 1
    with torch.no_grad():
        logits, temp = model.forward_logits(frames)
    assert got.shape == (4, 21, 2)
    assert (got - softmax_decode_reference(logits, temp)).abs().max().item() <= 1e-4


def test_pose_transformer_b4_sites_on_card(cuda):
    """PoseFormer's forward on the card decodes the backbone's per-frame
    logits with one B4 launch: its maps within 1e-4 of their largest value
    and its refined pose within 1e-5 px of the CPU's (the twin's decode;
    2.7e-6 px on an H100).
    The C20 train step at one sequence launches B4 forward once and its
    backward never (the decode enters no loss), every gradient outside the
    backbone is zero, and two sequences raise C20."""
    cfg = temporal_cfg("pose_hrnet_transformer")
    state = init_variables(cfg, 0)
    models = []
    for dev in ("cpu", cuda):
        model = build_model(cfg)
        model.load_state_dict(state)
        models.append(model.to(dev).eval())
    x = temporal_frames(1, "cpu")
    with torch.no_grad():
        want = models[0](x)
        before = fused_softmax_decode.launches
        got = models[1](x.to(cuda))
        torch.cuda.synchronize()
    assert fused_softmax_decode.launches == before + 1
    assert (got.heatmaps.cpu() - want.heatmaps).abs().max() <= 1e-4 * want.heatmaps.max()
    gap = (got.pose2d_refined.cpu() - want.pose2d_refined).abs().max().item()
    print(f"PoseFormer refined pose, card vs CPU: {gap:.3g} px")
    assert gap <= 1e-5

    model = build_model(cfg)
    tstate, tx = TS.create_train_state(cfg, model, device=cuda)
    step = TS.make_train_step(cfg, model, tx)
    rng = np.random.default_rng(18)
    batch = {"images": x.to(cuda),
             "target_heatmaps": torch.zeros(1, 16, 16, 21, device=cuda),
             "pose2d": torch.from_numpy(rng.uniform(2, 14, size=(1, 21, 2)).astype(
                 np.float32)).to(cuda),
             "visibility": torch.ones(1, 21, device=cuda)}
    before = (fused_softmax_decode.launches, fused_softmax_decode.launches_bwd)
    tstate, losses = step(tstate, batch)
    torch.cuda.synchronize()
    assert (fused_softmax_decode.launches, fused_softmax_decode.launches_bwd) == (
        before[0] + 1, before[1])
    assert torch.isfinite(losses["total_loss"]).item()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert any(g.any() for n, g in grads.items() if n.startswith("backbone."))
    assert not any(g.any() for n, g in grads.items() if not n.startswith("backbone."))
    two = {k: torch.cat([v, v]) for k, v in batch.items()}
    two["images"] = temporal_frames(2, cuda)
    with pytest.raises(ValueError, match="C20"):
        step(tstate, two)


def test_kernel_times_match_key_averages(cuda):
    """``chip_timing.kernel_times`` reads the profiler's raw device events,
    which are not public API: on a small callable its sum is
    ``key_averages()``'s device self time, within 1e-6 (both are the same
    events, in ns and in float us)."""
    from torch.profiler import ProfilerActivity, profile

    from chip_timing import kernel_times

    a = torch.randn(512, 512, device=cuda)
    fn = lambda: (a @ a).relu_()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    raw = sum(kernel_times(prof, 3).values())
    averaged = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / 3
    print(f"kernel ms a step: raw events {raw:.6f}, key_averages {averaged:.6f}")
    assert raw > 0 and raw == pytest.approx(averaged, rel=1e-6)


# -- FTL, the stacked hourglass and the mesh family ------------------------------

def test_ftl_b4_forward_and_backward_on_card(cuda):
    """FTL at a small width (small_cfg's HRNet, 64 px, 2 views), float32
    with TF32 off: one B4 launch a forward, the maps within 1e-4 and the
    keypoints within 1e-3 px of the CPU's; the gradient of sum(keypoints_3d)
    launches B4's forward and backward once each, reaches no backbone
    parameter, and its head part is within 1e-3 (norm-wise) of the same
    gradient decoded by B4's twin on the card."""
    from hrnet_hand_pose_estimation_tpu_torch.models import ftl
    from hrnet_hand_pose_estimation_tpu_torch.models.ftl import FTLMultiviewNet, seeded_cameras
    from hrnet_hand_pose_estimation_tpu_torch.models.hrnet import hrnet_from_cfg

    cfg = small_cfg().clone()
    cfg.defrost()
    cfg.merge_from_list(["MODEL.NAME", "FTL", "DATASET.NUM_VIEWS", 2])
    cfg.freeze()
    state = init_variables(cfg, 0)
    x = torch.from_numpy(np.random.default_rng(21).normal(size=(2, 2, 64, 64, 3)).astype(
        np.float32))
    extr, intr = seeded_cameras(2, 2, 64, 21)
    nets = []
    for dev in ("cpu", cuda):
        net = FTLMultiviewNet(hrnet_from_cfg(cfg), num_views=2, dtype=torch.float32)
        net.load_state_dict(state)
        nets.append(net.to(dev).eval())
    args = [t.to(cuda) for t in (x, extr, intr)]
    with torch.no_grad():
        want = nets[0](x, extr, intr)
        before = fused_softmax_decode.launches
        got = nets[1](*args)
        torch.cuda.synchronize()
    assert fused_softmax_decode.launches == before + 1
    assert (got.heatmaps.cpu() - want.heatmaps).abs().max() <= 1e-4 * want.heatmaps.max()
    assert (got.keypoints_2d.cpu() - want.keypoints_2d).abs().max().item() <= 1e-3
    assert float(want.keypoints_2d.std()) > 0.5

    grads = {}
    for name, decode in (("kernel", ftl.softmax_decode), ("twin", softmax_decode_reference)):
        nets[1].zero_grad(set_to_none=True)
        launched = (fused_softmax_decode.launches, fused_softmax_decode.launches_bwd)
        orig, ftl.softmax_decode = ftl.softmax_decode, decode
        try:
            nets[1](*args).keypoints_3d.sum().backward()
        finally:
            ftl.softmax_decode = orig
        torch.cuda.synchronize()
        launched = (fused_softmax_decode.launches - launched[0],
                    fused_softmax_decode.launches_bwd - launched[1])
        assert launched == ((1, 1) if name == "kernel" else (0, 0)), (name, launched)
        params = dict(nets[1].named_parameters())
        assert all(p.grad is None for n, p in params.items() if n.startswith("backbone."))
        grads[name] = torch.cat([p.grad.reshape(-1) for n, p in params.items()
                                 if not n.startswith("backbone.")])
    twin = grads["twin"]
    assert twin.norm() > 0
    assert ((grads["kernel"] - twin).norm() / twin.norm()).item() <= 1e-3


def test_hourglass_on_card_matches_cpu(cuda):
    """HGFilter (2 stacks, depth 2, 64 px), batch and group norm, float32
    with TF32 off: every stack's maps and ``normx`` within 1e-4 of their
    largest value of the CPU's."""
    from hrnet_hand_pose_estimation_tpu_torch.models.hourglass import HGFilter

    x = torch.from_numpy(np.random.default_rng(22).normal(size=(2, 64, 64, 3)).astype(
        np.float32))
    for norm in ("batch", "group"):
        torch.manual_seed(0)
        cpu = HGFilter(num_stacks=2, depth=2, norm=norm).eval()
        TS.init_train_weights(cpu, 1)
        card = HGFilter(num_stacks=2, depth=2, norm=norm)
        card.load_state_dict(cpu.state_dict())
        card.to(cuda).eval()
        with torch.no_grad():
            (w0, w1), wn = cpu(x)
            (g0, g1), gn = card(x.to(cuda))
        for g, w in ((g0, w0), (g1, w1), (gn, wn)):
            assert (g.cpu() - w).abs().max() <= 1e-4 * w.abs().max(), norm


def test_lbs_on_card_matches_cpu(cuda):
    """LBS on a MANO-sized rig (778 vertices, 16 joints, 10 shape and 135
    pose-blendshape columns) at B = 8: vertices and joints within 1e-5 of
    their largest value of the CPU's."""
    from hrnet_hand_pose_estimation_tpu_torch.models.mano import lbs, toy_hand_model

    rng = np.random.default_rng(23)
    rig = toy_hand_model(n_verts=778, n_joints=16, n_shape=10, device="cpu")
    rig = rig._replace(posedirs=torch.from_numpy(rng.normal(scale=0.01, size=(778, 3, 135))
                                                 .astype(np.float32)))
    card = rig._replace(**{f: getattr(rig, f).to(cuda) for f in (
        "v_template", "shapedirs", "posedirs", "j_regressor", "weights")})
    pose = torch.from_numpy(rng.normal(scale=0.4, size=(8, 16, 3)).astype(np.float32))
    betas = torch.from_numpy(rng.normal(size=(8, 10)).astype(np.float32))
    want = lbs(rig, pose, betas)
    got = lbs(card, pose.to(cuda), betas.to(cuda))
    for g, w in zip(got, want):
        assert (g.cpu() - w).abs().max() <= 1e-5 * w.abs().max()


def test_rasterize_on_card_matches_cpu(cuda):
    """``MeshRenderer`` at 128 px on a seeded mesh: the card's coverage (the
    alpha channel) equals the CPU's except on at most 0.5 % of the pixels,
    and its colours are within 1 / 255 of the CPU's where both cover or
    neither does."""
    from hrnet_hand_pose_estimation_tpu_torch.utils.renderer import MeshRenderer

    rng = np.random.default_rng(24)
    verts = rng.normal(scale=0.25, size=(300, 3)).astype(np.float32)
    verts[:, 2] += 10.0
    d = ((verts[:, None] - verts[None]) ** 2).sum(-1)
    near = np.argsort(d, axis=1)[:, 1:6]
    a = rng.integers(0, 300, 600)
    faces = np.stack([a, near[a, 1], near[a, 3]], 1).astype(np.int32)
    cpu, card = (MeshRenderer(faces, img_size=128, device=dev)(verts, do_alpha=True)
                 for dev in ("cpu", "cuda"))
    differ = (cpu[..., 3] > 0) != (card[..., 3] > 0)
    assert (cpu[..., 3] > 0).mean() > 0.05 and differ.mean() <= 0.005
    col = np.abs(cpu[..., :3].astype(int) - card[..., :3].astype(int))
    assert (col[~differ] <= 1).mean() >= 0.995


def test_nms_on_card_matches_cpu(cuda):
    """``nms`` and ``oks_nms`` keep masks equal to the CPU's on 500 seeded
    boxes and 80 poses; ``soft_nms`` (both methods) within 1e-5."""
    from hrnet_hand_pose_estimation_tpu_torch.ops import nms

    rng = np.random.default_rng(25)
    xy = rng.uniform(0, 400, size=(60, 2))[rng.integers(0, 60, 500)] + rng.normal(scale=8, size=(
        500, 2))
    dets = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(10, 60, size=(500, 2)),
                                            rng.uniform(0.01, 1, (500, 1))], 1).astype(
        np.float32))
    assert torch.equal(nms.nms(dets.to(cuda), 0.5).cpu(), nms.nms(dets, 0.5))
    for method in ("gaussian", "linear"):
        got = nms.soft_nms(dets.to(cuda), method=method).cpu()
        assert (got - nms.soft_nms(dets, method=method)).abs().max() <= 1e-5
    kp = rng.uniform(0, 300, size=(16, 17, 2))[rng.integers(0, 16, 80)] + rng.normal(size=(
        80, 17, 2))
    kp = torch.from_numpy(np.concatenate([kp, np.ones((80, 17, 1))], -1).astype(np.float32))
    scores = torch.from_numpy(rng.uniform(size=80).astype(np.float32))
    areas = torch.from_numpy(rng.uniform(2000, 9000, 80).astype(np.float32))
    want = nms.oks_nms(kp, scores, areas, 0.9)
    assert 0 < int(want.sum()) < 80
    assert torch.equal(nms.oks_nms(kp.to(cuda), scores.to(cuda), areas.to(cuda), 0.9).cpu(), want)


def reader_cfg(root, test):
    """small_cfg in float32 reading the tiny trees under ``root``."""
    cfg = small_cfg().clone()
    cfg.defrost()
    cfg.merge_from_list(["DATA_DIR", str(root), "DATASET.TEST_DATASET", [test],
                         "TEST.IMAGES_PER_GPU", 4, "WORKERS", 0, "MODEL.TRAINABLE_SOFTMAX", True,
                         "MODEL.HEATMAP_SOFTMAX", True, "TPU.COMPUTE_DTYPE", "float32"])
    return cfg.freeze()


def test_rhd_evaluator_on_card_matches_cpu(cuda, tmp_path):
    """Evaluator2D on a tiny RHD tree (PNG frames decoded by the port,
    crop-corner rescale): one B4 launch a batch on the card, every metric
    within 1e-4 relative of the same evaluation on the CPU (float32, TF32
    off)."""
    from hrnet_hand_pose_estimation_tpu_torch.core.evaluator import Evaluator2D
    from hrnet_hand_pose_estimation_tpu_torch.data.build import make_test_dataloader
    import torch_reader_trees as trees

    trees.write_rhd(tmp_path, "evaluation", 8, seed=3)
    cfg = reader_cfg(tmp_path, "RHD")
    state = init_variables(cfg, 0)
    runs = {}
    for dev in ("cpu", cuda):
        loader = make_test_dataloader(cfg)["RHD"]
        model = build_model(cfg)
        model.load_state_dict(state)
        before = fused_softmax_decode.launches
        runs[str(dev)] = Evaluator2D(cfg, model, None, device=dev).run(loader, "RHD")
        launched = fused_softmax_decode.launches - before
        assert launched == (len(loader) if dev == cuda else 0)
    for key in ("EPE_px", "PCK_AUC_30", "PCK_AUC_full"):
        assert runs["cuda"][key] == pytest.approx(runs["cpu"][key], rel=1e-4), key


def test_reader_host_helpers_against_their_card_paths(cuda, tmp_path):
    """The host pipeline's numbers beside the card's: ``gaussian_targets_native``
    against B5 on the card (1e-6), ``normalize_collate`` against the card's
    normalisation (1e-6), and COCO's evaluation with its OKS-NMS on the card
    against the same on the CPU (the same results file)."""
    import json

    from hrnet_hand_pose_estimation_tpu_torch.data import native
    from hrnet_hand_pose_estimation_tpu_torch.data.coco_mpii import COCOKeypointsDataset
    from hrnet_hand_pose_estimation_tpu_torch.ops.image import normalize
    import torch_reader_trees as trees

    g = np.random.default_rng(21)
    joints = g.uniform(-2, 66, size=(8, 21, 2)).astype(np.float32)
    vis = (g.uniform(size=(8, 21)) > 0.2).astype(np.float32)
    host = native.gaussian_targets_native(joints, vis, 64, 2.0)
    card = fused_gaussian_targets(f32(joints, cuda), f32(vis, cuda), 64, 2.0)
    assert (card.cpu() - torch.from_numpy(host)).abs().max().item() <= 1e-6
    u8 = g.integers(0, 256, size=(4, 32, 32, 3)).astype(np.uint8)
    on_card = normalize(torch.from_numpy(u8).to(cuda)).cpu()
    assert (on_card - torch.from_numpy(native.normalize_collate(u8))).abs().max().item() <= 1e-6

    gt = trees.write_coco(tmp_path, 4)
    ds = COCOKeypointsDataset(str(tmp_path), "val2017")
    preds = np.stack([np.concatenate([gt[i][:, :2] + 0.3 * i, np.full((17, 1), 0.9)], 1)
                      for i in (1, 2, 3, 4, 1)]).astype(np.float32)
    boxes = np.array([[80, 80, 0.6, 0.6, 12544, 1.0]] * 5, np.float32)
    files = []
    for dev in ("cpu", cuda):
        nv, ap = ds.evaluate(preds, boxes, [1, 2, 3, 4, 1], str(tmp_path / str(dev)), device=dev)
        with open(nv["res_file"]) as f:
            files.append((json.load(f), ap))
    assert files[0] == files[1] and len(files[0][0]) == 4


@pytest.mark.parametrize("int8_head", [False, True])
def test_sharded_serving_on_card_matches_no_mesh(cuda, int8_head):
    """make_quant_infer(mesh=[cuda:0, cuda:0]) on the smoke widths at B=4:
    each replica launches the path's kernels (twice the unsharded call's
    conv_int8, B3 and B1), the result equals the two halves served apart
    bit for bit and the unsharded call within C9's 0.25 px."""
    from hrnet_hand_pose_estimation_tpu_torch.parallel.mesh import make_mesh

    cfg = small_cfg(SMOKE_WIDTHS)
    state = {k: v.to(cuda) for k, v in init_variables(cfg, seed=3).items()}
    weights = precast_variables(cfg, state)
    u8 = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, size=(4, 64, 64, 3)).astype(np.uint8)).to(cuda)
    norm = (Q.IMAGENET_MEAN, Q.IMAGENET_STD)
    mean = torch.tensor(norm[0], device=cuda) * 255.0
    std = torch.tensor(norm[1], device=cuda) * 255.0
    amax = Q.calibrate(cfg, weights, [(u8.float() - mean) / std])
    qparams = Q.prepare_serving_qparams(cfg, state, amax, int8_head=int8_head)
    plain = Q.make_quant_infer(cfg, cuda, input_norm=norm)
    sharded = Q.make_quant_infer(cfg, cuda, input_norm=norm,
                                 mesh=make_mesh(devices=[cuda, cuda]))
    kernels = (conv_int8, fused_bottleneck_chain_int8, fused_head_decode_v2)
    counts = []
    for fn_call in (lambda: plain(weights, qparams, u8), lambda: sharded(weights, qparams, u8)):
        for fn in kernels:
            fn.launches = 0
        out = fn_call()
        torch.cuda.synchronize()
        counts.append([fn.launches for fn in kernels])
        if len(counts) == 1:
            want = out
    assert counts[1] == [2 * n for n in counts[0]] and all(counts[0])
    halves = torch.cat([plain(weights, qparams, u8[:2]), plain(weights, qparams, u8[2:])])
    assert torch.equal(out, halves)
    assert (out - want).abs().max().item() <= 0.25


def test_synced_batch_stats_bf16_on_card_matches_cpu(cuda):
    """The data-parallel step's BN (``BatchNorm._synced_forward``, here with
    a one-rank sum) on bf16 input on the card against the same on the CPU,
    forward and backward, and against the one-process BN
    (``native_batch_norm``): within a bf16 ulp of the largest output (and
    of the largest input gradient), float32 running statistics within
    1e-5."""
    from hrnet_hand_pose_estimation_tpu_torch.models.layers import (batch_norm,
                                                                    synced_batch_stats)

    rng = np.random.default_rng(12)
    x0 = torch.from_numpy(rng.normal(1.5, 2.0, size=(4, 24, 9, 7)).astype(np.float32))
    g0 = torch.from_numpy(rng.normal(size=(4, 24, 9, 7)).astype(np.float32))
    out = {}
    for dev, synced in ((cuda, True), (torch.device("cpu"), True), (cuda, False)):
        bn = batch_norm(24).to(dev).train()
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 24))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, 24))
        x = x0.to(dev, torch.bfloat16).requires_grad_(True)
        if synced:
            with synced_batch_stats(lambda t: t):
                y = bn(x)
        else:
            y = bn(x)
        y.backward(g0.to(dev, torch.bfloat16))
        out[(dev.type, synced)] = (y.float().cpu(), x.grad.float().cpu(),
                                   bn.running_mean.cpu(), bn.running_var.cpu())
    ref = out[("cpu", True)]
    for key in (("cuda", True), ("cuda", False)):
        y, gx, rm, rv = out[key]
        assert (y - ref[0]).abs().max() <= 2.0 ** -8 * ref[0].abs().max()
        assert (gx - ref[1]).abs().max() <= 2.0 ** -8 * ref[1].abs().max()
        assert torch.allclose(rm, ref[2], atol=1e-5) and torch.allclose(rv, ref[3], atol=1e-5)


def test_model_axis_on_card_matches_data_mesh(cuda):
    """Evaluator2D over a (2, 2) grid of cuda:0 positions (the small
    HRNet's layer1 convs split their output channels, shard j at model
    position j) against the data-only (2,) mesh in float32 with cuDNN
    deterministic: the decoded coordinates within 1e-4 px, B4 launched once
    a data row; each split weight's shards on the card, half the channels
    each; make_quant_infer over the grid bit-equal to the data-only mesh."""
    from hrnet_hand_pose_estimation_tpu_torch.core.evaluator import Evaluator2D
    from hrnet_hand_pose_estimation_tpu_torch.parallel import tensor_parallel as TP
    from hrnet_hand_pose_estimation_tpu_torch.parallel.mesh import make_mesh

    cfg = small_cfg(SMOKE_WIDTHS).clone()
    cfg.defrost()
    cfg.MODEL.HEATMAP_SOFTMAX, cfg.TPU.COMPUTE_DTYPE = True, "float32"
    cfg.freeze()
    state = init_variables(cfg, seed=3)
    grid = make_mesh(("data", "model"), (2, 2), [cuda] * 4)
    data = make_mesh(("data",), (2,), [cuda] * 2)
    images = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4, 64, 64, 3)).astype(np.float32)).to(cuda)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = {}
        for name, mesh in (("grid", grid), ("data", data)):
            ev = Evaluator2D(cfg, build_model(cfg), state, mesh=mesh, device=cuda)
            fused_softmax_decode.launches = 0
            out[name] = ev.forward(images)
            torch.cuda.synchronize()
            assert fused_softmax_decode.launches == 2
            if name == "grid":
                rep = ev._replicas[0]
                split = {n: d for n, d in TP.info(rep).split.items() if d is not None}
                assert split and all(n.startswith("layer1.") for n in split)
                for n, d in split.items():
                    shards = TP.shards_of(rep, n)
                    assert [s.device.type for s in shards] == ["cuda", "cuda"]
                    assert shards[0].shape[d] == shards[1].shape[d] == 128
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert (out["grid"] - out["data"]).abs().max().item() <= 1e-4
    weights = precast_variables(cfg, {k: v.to(cuda) for k, v in state.items()})
    u8 = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, size=(4, 64, 64, 3)).astype(np.uint8)).to(cuda)
    norm = (Q.IMAGENET_MEAN, Q.IMAGENET_STD)
    mean = torch.tensor(norm[0], device=cuda) * 255.0
    std = torch.tensor(norm[1], device=cuda) * 255.0
    amax = Q.calibrate(cfg, weights, [(u8.float() - mean) / std])
    qparams = Q.prepare_serving_qparams(cfg, {k: v.to(cuda) for k, v in state.items()}, amax)
    got, want = (Q.make_quant_infer(cfg, cuda, input_norm=norm, mesh=m)(weights, qparams, u8)
                 for m in (grid, data))
    assert torch.equal(got, want)
