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
    SiteQ, conv_int8, conv_int8_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_bottleneck import (
    basic_chain_reference, fused_basic_chain, fused_bottleneck_chain, fused_stem_layer1,
    layer1_reference, stem_layer1_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_head_decode import (
    HeadParams, fused_head_decode_v2, head_decode_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.gaussian_targets import (
    fused_gaussian_targets, gaussian_targets_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.int8_chain import (
    bottleneck_chain_int8_reference, fused_bottleneck_chain_int8)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.softmax_decode import (
    fused_softmax_decode, softmax_decode_reference)
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
    # the w48 widths: Cin % 32 == 16 takes a 16-channel last K slice
    (3, 1, True, 48, 48, (13, 21)),
    (3, 2, True, 48, 96, (17, 17)),
    (1, 1, False, 96, 48, (9, 7)),
    (3, 1, False, 96, 96, (8, 8)),
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
    int8_slice_on_card(cuda, monkeypatch, small_cfg((32, 64, 96, 128)))


def test_small_w48_int8_slice_on_card(cuda, monkeypatch):
    """The same at the w48 stage widths (48/96/192/384), whose sites read
    tensors with Cin % 32 == 16."""
    int8_slice_on_card(cuda, monkeypatch, small_cfg((48, 96, 192, 384)))


def int8_slice_on_card(cuda, monkeypatch, cfg):
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
])
def test_basic_chain_kernel_matches_twin(cuda, batch, h, w, c):
    """Every branch shape of w32 and w48, ragged batches and ragged spatial
    sizes; one launch per block."""
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


@pytest.mark.parametrize("hs,ws", [(64, 64), (20, 36), (6, 38)])
def test_stem_layer1_kernel_matches_twin(cuda, hs, ws):
    """The s2d stem kernel + the layer1 launches against their twin, with
    ragged tiles; one stem launch and one per layer1 block."""
    rng = np.random.default_rng(hs + ws)
    stem = (bf16(rng.normal(size=(4, 12, 64)) * 0.3, cuda), f32(rng.normal(size=64) * 0.1, cuda),
            bf16(rng.normal(size=(576, 64)) * 0.06, cuda), f32(rng.normal(size=64) * 0.1, cuda))
    params, flags = layer1_params(rng, cuda)
    x = bf16(rng.normal(size=(2, hs, ws, 12)), cuda)
    before = fused_stem_layer1.launches
    got = fused_stem_layer1(x, stem, params, flags)
    torch.cuda.synchronize()
    assert fused_stem_layer1.launches == before + 5
    want = stem_layer1_reference(x, stem, params, flags)
    limit = 0.02 * max(1.0, want.float().abs().max().item())
    assert got.shape == want.shape == (2, hs // 2, ws // 2, 256)
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
    assert blocks == 9 and [fn.launches for fn in kernels] == [blocks, 5, 0, 3]
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
