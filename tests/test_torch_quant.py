"""The port's int8 modules (core/quant_infer, ops/kernels/conv_int8,
ops/kernels/int8_chain and the head's int8-input mode) against the JAX
package's.

On the CPU each wrapper runs its plain PyTorch twin; the JAX side runs its
Pallas kernels in interpret mode, as tests/test_int8_chain.py and
tests/test_quant_infer.py do.  Weights cross through
``utils/weights.from_jax_variables``; the random-but-active weights are
the recipe of tests/test_quant_infer.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.config import load_config as jax_load_config
from hrnet_hand_pose_estimation_tpu.config.defaults import POSE_HIGH_RESOLUTION_NET_EXTRA
from hrnet_hand_pose_estimation_tpu.core import quant_infer as JQ
from hrnet_hand_pose_estimation_tpu.models.hrnet import hrnet_from_cfg as jax_hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu.ops.pallas import fused_head_decode as jax_fh
from hrnet_hand_pose_estimation_tpu.ops.pallas import int8_chain as jax_chain
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.core import quant_infer as Q
from hrnet_hand_pose_estimation_tpu_torch.core.fast_infer import _fold_model, precast_variables
from hrnet_hand_pose_estimation_tpu_torch.models.hrnet import hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.conv_int8 import (
    SiteQ, conv_int8, conv_int8_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_head_decode import (
    HeadParams, fused_head_decode_v2, head_decode_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.int8_chain import (
    _kernel_kq, bottleneck_chain_int8_reference, fused_bottleneck_chain_int8, prepare_layer1_int8)
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables
from tests.test_quant_infer import _activated_variables

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def no_grad():
    """The module's tests run without autograd; a module-level
    ``set_grad_enabled(False)`` would also turn it off for every other test
    file a worker imports at collection."""
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def activated(tiny_cfg):
    """tiny_cfg with the activated weights of tests/test_quant_infer.py, in
    both packages, and one calibration record made by the JAX package."""
    rng = np.random.default_rng(0)
    model = jax_hrnet_from_cfg(tiny_cfg, head="softmax")
    x = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    v = jax.tree.map(np.asarray, _activated_variables(model, jnp.asarray(x), rng))
    cfg = config_from_dict(tiny_cfg.to_dict())
    state = from_jax_variables(v)
    amax = JQ.calibrate(tiny_cfg, v, [x])
    return tiny_cfg, cfg, v, state, x, amax


def w32_cfgs():
    jcfg = jax_load_config(freeze=False)
    jcfg.MODEL.EXTRA.merge_from_mapping(POSE_HIGH_RESOLUTION_NET_EXTRA)
    return jcfg.freeze(), config_from_dict(jcfg.to_dict())


# --------------------------------------------------------------------------
# the scheme
# --------------------------------------------------------------------------

def kernel_with_ties(rng, shape):
    """A random HWIO kernel whose channel c has max |k| = 127 * s_c with
    s_c a power of two, so k / wscale is exact, and half its entries sit
    on .5 ties."""
    *_, cout = shape
    s = 2.0 ** -rng.integers(3, 9, size=cout)
    k = rng.normal(size=shape) * 40 * s
    ties = rng.random(shape) < 0.5
    k = np.where(ties, (rng.integers(-126, 126, size=shape) + 0.5) * s, k)
    k = np.clip(k, -126 * s, 126 * s)
    k.reshape(-1, cout)[0] = 127 * s
    return k.astype(np.float32), ties


@pytest.mark.parametrize("shape", [(3, 3, 16, 8), (1, 1, 32, 24), (3, 3, 64, 32)])
def test_quantize_weight_bit_identical_to_jax(rng, shape):
    k, ties = kernel_with_ties(rng, shape)
    want_kq, want_ws = JQ.quantize_weight(k)
    got_kq, got_ws = Q.quantize_weight(k.transpose(3, 2, 0, 1))      # OIHW
    assert got_kq.dtype == np.int8 and got_ws.dtype == np.float32
    np.testing.assert_array_equal(got_kq.transpose(2, 3, 1, 0), want_kq)
    np.testing.assert_array_equal(got_ws, want_ws)
    # the ties round half to even, and are many
    tied = got_kq.transpose(2, 3, 1, 0)[ties & (np.abs(want_kq) < 127)]
    assert tied.size > 100 and (tied % 2 == 0).all()


def test_site_scale_and_constants_match_jax():
    amax = {"a": 3.7, "b": 0.0, "c": 1e-20, "d": 254.0}
    for site in amax:
        assert Q.site_scale(amax, site) == JQ.site_scale(amax, site)
    with pytest.raises(KeyError, match="no calibration record"):
        Q.site_scale(amax, "e")
    assert (Q.CALIBRATION_VERSION, Q.LAYER1_CHAIN_KEY, Q.HEAD_SCALES_KEY) == (
        JQ.CALIBRATION_VERSION, JQ.LAYER1_CHAIN_KEY, JQ.HEAD_SCALES_KEY)
    assert (Q.IMAGENET_MEAN, Q.IMAGENET_STD) == (JQ.IMAGENET_MEAN, JQ.IMAGENET_STD)


def test_calibration_record_crosses_both_ways(activated, tmp_path):
    tiny_cfg, cfg, _, _, _, amax = activated
    jax_path, port_path = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    JQ.save_calibration(jax_path, amax, tiny_cfg)
    Q.save_calibration(port_path, amax, cfg)
    assert json.load(open(jax_path)) == json.load(open(port_path))
    assert Q.load_calibration(jax_path, cfg) == JQ.load_calibration(port_path, tiny_cfg) == {
        k: float(v) for k, v in amax.items()}

    rec = json.load(open(port_path))
    for field, value, match in (("model", "pose_resnet", "made for model"),
                                ("image_size", [128, 128], "image size"),
                                ("version", 2, "version")):
        wrong = dict(rec, **{field: value})
        path = tmp_path / f"wrong_{field}.json"
        path.write_text(json.dumps(wrong))
        with pytest.raises(ValueError, match=match):
            Q.load_calibration(str(path), cfg)


# --------------------------------------------------------------------------
# sites
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scope", ["branch", "exchange", "wide"])
@pytest.mark.parametrize("stem2", [False, True])
def test_quant_sites_match_jax_and_map_to_port_modules(tiny_cfg, scope, stem2):
    jw32, pw32 = w32_cfgs()
    for jcfg, pcfg in ((tiny_cfg, config_from_dict(tiny_cfg.to_dict())), (jw32, pw32)):
        sites = Q.quant_sites(pcfg, scope, stem2=stem2)
        assert sites == JQ.quant_sites(jcfg, scope, stem2=stem2)
        model = hrnet_from_cfg(pcfg)
        for site in sites:
            conv, bn = Q.site_modules(site)
            assert isinstance(model.get_submodule(conv), torch.nn.Conv2d), site
            assert isinstance(model.get_submodule(bn), torch.nn.BatchNorm2d), site
    want = {("branch", False): 208, ("branch", True): 209, ("exchange", True): 291}
    if (scope, stem2) in want:
        assert len(Q.quant_sites(pw32, scope, stem2=stem2)) == want[scope, stem2]


def test_site_module_names():
    assert Q.site_modules("stage2_m0/branch0/block0/cb1") == (
        "stage2.0.branches.0.0.conv1", "stage2.0.branches.0.0.bn1")
    assert Q.site_modules("stage3_m1/fuse0_2") == (
        "stage3.1.fuse_layers.0.2.0", "stage3.1.fuse_layers.0.2.1")
    assert Q.site_modules("stage3_m1/fuse2_0_1") == (
        "stage3.1.fuse_layers.2.0.1.0", "stage3.1.fuse_layers.2.0.1.1")
    assert Q.site_modules("transition1_0") == ("transition1.0.0", "transition1.0.1")
    assert Q.site_modules("transition2_2_0") == ("transition2.2.0.0", "transition2.2.0.1")
    assert Q.site_modules("stem2") == ("conv2", "bn2")
    assert Q.site_modules("layer1/block0/downsample") == (
        "layer1.0.downsample.0", "layer1.0.downsample.1")
    with pytest.raises(KeyError, match="no port module"):
        Q.site_modules("stage2_m0/nowhere")


def test_prepare_quant_params_equal_jax(activated):
    tiny_cfg, cfg, v, state, _, amax = activated
    want = JQ.prepare_quant_params(tiny_cfg, v, amax, scope="wide", stem2=True)
    got = Q.prepare_quant_params(cfg, state, amax, scope="wide", stem2=True)
    assert list(got) == list(want)
    for site, q in got.items():
        w = want[site]
        np.testing.assert_array_equal(q.kq.permute(1, 2, 3, 0).numpy(), np.asarray(w["kq"]))
        np.testing.assert_array_equal(q.wscale.numpy(), np.asarray(w["wscale"]))
        np.testing.assert_array_equal(q.bias.numpy(), np.asarray(w["bias"]))
        assert q.sa.item() == float(w["sa"])
        np.testing.assert_array_equal(q.scale.numpy(),
                                      np.asarray(w["sa"] * w["wscale"], np.float32))


# --------------------------------------------------------------------------
# conv_int8 (the counterpart of XLA's int8 conv in _conv_int8)
# --------------------------------------------------------------------------

def site_case(rng, k, cin, cout, hw=(9, 11), batch=2):
    kernel = (rng.normal(size=(k, k, cin, cout)) * 0.1).astype(np.float32)
    kq, wscale = JQ.quantize_weight(kernel)
    sa = np.float32(0.037)
    bias = (rng.normal(size=cout) * 0.3).astype(np.float32)
    x = np.abs(rng.normal(size=(batch, *hw, cin))) * 2
    x = np.asarray(jnp.asarray(x.astype(np.float32)).astype(jnp.bfloat16).astype(jnp.float32))
    jq = {"kq": jnp.asarray(kq), "wscale": jnp.asarray(wscale), "sa": jnp.float32(sa),
          "bias": jnp.asarray(bias)}
    pq = SiteQ(kq=torch.from_numpy(np.ascontiguousarray(kq.transpose(3, 0, 1, 2))),
               wscale=torch.from_numpy(wscale), sa=torch.tensor(sa),
               scale=torch.from_numpy(sa * wscale), bias=torch.from_numpy(bias))
    return x, jq, pq


@pytest.mark.parametrize("k,stride,relu,cin,cout", [
    (3, 1, True, 32, 32),      # branch cb1
    (3, 1, False, 64, 64),     # branch cb2
    (3, 2, True, 64, 64),      # stem2, transition chains
    (3, 2, False, 32, 128),    # last conv of a downsampling fuse chain
    (1, 1, False, 256, 32),    # upsampling fuse conv
    (3, 1, True, 256, 32),     # transition1_0
])
def test_conv_int8_twin_matches_jax(rng, k, stride, relu, cin, cout):
    x, jq, pq = site_case(rng, k, cin, cout)
    want = np.asarray(JQ._conv_int8(jnp.asarray(x).astype(jnp.bfloat16), jq, stride=stride,
                                    relu=relu), np.float32)
    before = conv_int8.launches
    got = conv_int8(torch.from_numpy(x).to(torch.bfloat16), pq, stride=stride, relu=relu)
    assert conv_int8.launches == before      # the CPU runs the twin
    assert torch.equal(got, conv_int8_reference(torch.from_numpy(x).to(torch.bfloat16), pq,
                                                stride=stride, relu=relu))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-5)


def test_conv_int8_rejects_bad_inputs(rng):
    x, _, pq = site_case(rng, 3, 32, 32)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="bfloat16"):
        conv_int8(xt, pq)
    with pytest.raises(ValueError, match="channels"):
        conv_int8(xt[..., :16].to(torch.bfloat16), pq)
    with pytest.raises(ValueError, match="stride"):
        conv_int8(xt.to(torch.bfloat16), pq, stride=3)
    with pytest.raises(ValueError, match="sa must"):
        conv_int8(xt.to(torch.bfloat16), pq._replace(sa=torch.tensor([0.1])))
    with pytest.raises(ValueError, match="cuda or cpu"):
        conv_int8(xt.to(torch.bfloat16).to("meta"),
                  SiteQ(*(t.to("meta") for t in pq)))


# --------------------------------------------------------------------------
# the W8A8 layer1 chain (TPU kernel #3)
# --------------------------------------------------------------------------

def test_layer1_int8_params_and_twin_match_jax(activated):
    tiny_cfg, cfg, v, state, x, amax = activated
    want_flat, want_flags = jax_chain.prepare_layer1_int8(v, amax)
    flat, flags = prepare_layer1_int8(state, amax)
    assert flags == want_flags == Q.layer1_topology(state) == (True, False, False, False)
    assert len(flat) == len(want_flat) == 43
    for got, want in zip(flat, want_flat):
        want = np.asarray(want)
        assert got.dtype == {np.int8: torch.int8, np.float32: torch.float32}[want.dtype.type]
        if want.dtype == np.int8:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)

    stem = JQ._stem(v, jnp.asarray(x))                   # (B, 16, 16, 64) bf16
    want_k = np.asarray(jax_chain.fused_bottleneck_chain_int8(
        stem, tuple(want_flat), want_flags, out_channels=256, interpret=True), np.float32)
    want_r = np.asarray(jax_chain.bottleneck_chain_int8_reference(
        stem, tuple(want_flat), want_flags), np.float32)
    xt = torch.from_numpy(np.asarray(stem.astype(jnp.float32))).to(torch.bfloat16)
    before = fused_bottleneck_chain_int8.launches
    got = fused_bottleneck_chain_int8(xt, flat, flags)
    assert fused_bottleneck_chain_int8.launches == before
    assert torch.equal(got, bottleneck_chain_int8_reference(xt, flat, flags))
    assert got.shape == (4, 16, 16, 256) and np.abs(want_k).max() > 0.5
    np.testing.assert_allclose(got.float().numpy(), want_r, atol=1e-5)
    # XLA:CPU contracts a * acc + c into one FMA when it compiles (the
    # interpret-mode kernel is compiled, the reference runs op by op and
    # rounds twice, as the port does), so a few requantized values move one
    # int8 level: the port may differ from the kernel only as far as JAX's
    # own reference does
    jax_gap = np.abs(want_r - want_k).max()
    assert np.abs(got.float().numpy() - want_k).max() <= max(1e-5, jax_gap)


def test_int8_chain_rejects_bad_inputs(activated):
    _, _, _, state, _, amax = activated
    flat, flags = prepare_layer1_int8(state, amax)
    x = torch.zeros(1, 8, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_bottleneck_chain_int8(x.float(), flat, flags)
    with pytest.raises(ValueError, match="kq1"):
        fused_bottleneck_chain_int8(x[..., :32], flat, flags)
    with pytest.raises(ValueError, match="take"):
        fused_bottleneck_chain_int8(x, flat[:-1], flags)
    with pytest.raises(ValueError, match="int8"):
        fused_bottleneck_chain_int8(x, (flat[0], flat[1].float()) + flat[2:], flags)


def test_layer1_int8_kq_are_n_major_views(activated):
    """prepare_layer1_int8 keeps the JAX shapes and values (above) but
    stores each kq N-major, as the kernel reads it: the (K, N) view of
    contiguous (N, K) storage, handed to the kernel without a copy; a plain
    (K, N) kq is copied to N-major.  The twin and the wrapper give the same
    bits from the views and from plain copies."""
    _, _, _, state, _, amax = activated
    flat, flags = prepare_layer1_int8(state, amax)
    kqs = [t for t in flat if t.dtype == torch.int8]
    assert len(kqs) == 13                       # kq1, kq2, kq3 per block, kqs on block 0
    for t in kqs:
        assert t.dim() == 2 and not t.is_contiguous() and t.t().is_contiguous()
        assert _kernel_kq(t).data_ptr() == t.data_ptr()          # no copy
        plain = t.contiguous()
        assert torch.equal(_kernel_kq(plain), t.t()) and _kernel_kq(plain).is_contiguous()
    plain = tuple(t.contiguous() for t in flat)
    rng = np.random.default_rng(12)
    x = torch.from_numpy(np.abs(rng.normal(size=(2, 8, 8, 64))).astype(np.float32)).to(
        torch.bfloat16)
    want = bottleneck_chain_int8_reference(x, plain, flags)
    assert want.float().abs().max().item() > 0.1
    assert torch.equal(bottleneck_chain_int8_reference(x, flat, flags), want)
    assert torch.equal(fused_bottleneck_chain_int8(x, flat, flags), want)


# --------------------------------------------------------------------------
# the head's int8-input mode (TPU kernel #2 with input_scales)
# --------------------------------------------------------------------------

def test_head_int8_twin_matches_pallas_v2(rng):
    widths, size, k = (8, 16, 32, 64), 16, 21
    xs = [rng.integers(0, 128, size=(4, size >> i, size >> i, c)).astype(np.int8)
          for i, c in enumerate(widths)]
    scales = (0.011, 0.023, 0.017, 0.029)
    c = sum(widths)
    p = dict(w_head=rng.normal(size=(c, c)) * 0.1, b_head=rng.normal(size=(c,)) * 0.1,
             w_final=rng.normal(size=(c, k)) * 0.1, b_final=rng.normal(size=(k,)) * 0.1,
             temp=np.float32(1.3))
    p = {n: np.asarray(a, np.float32) for n, a in p.items()}
    want = np.asarray(jax_fh.fused_head_decode_v2(
        [jnp.asarray(a) for a in xs], jax_fh.HeadParams(**{n: jnp.asarray(a) for n, a in p.items()}),
        interpret=True, input_scales=tuple(jnp.float32(s) for s in scales)))
    params = HeadParams(**{n: torch.from_numpy(a) for n, a in p.items()})
    xt = [torch.from_numpy(a) for a in xs]
    sa = tuple(torch.tensor(s, dtype=torch.float32) for s in scales)
    before = fused_head_decode_v2.launches
    got = fused_head_decode_v2(xt, params, input_scales=sa)
    assert fused_head_decode_v2.launches == before
    assert torch.equal(got, head_decode_reference(xt, params, input_scales=sa))
    assert got.shape == (4, k, 2) and want.std() > 0.5
    np.testing.assert_allclose(got.numpy(), want, atol=0.1)
    with pytest.raises(ValueError, match="int8"):
        fused_head_decode_v2([x.to(torch.bfloat16) for x in xt], params, input_scales=sa)
    with pytest.raises(ValueError, match="float32"):
        fused_head_decode_v2(xt, params._replace(w_head=params.w_head.to(torch.bfloat16)),
                             input_scales=sa)


# --------------------------------------------------------------------------
# the walk and calibration
# --------------------------------------------------------------------------

def test_walk_f32_matches_port_backbone(activated):
    """The walk in 'f32' mode over a float32 folded model == the port's
    PoseHRNet backbone in float32 (BN folding is exact up to rounding)."""
    _, cfg, _, state, x, _ = activated
    model = hrnet_from_cfg(cfg)
    model.load_state_dict(state)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    want = model.forward_backbone(xt)
    folded = _fold_model(model)
    got, amax = Q.apply_trunk(cfg, folded, Q._stem(folded, xt), mode="f32", include_layer1=True)
    assert not amax and len(got) == len(want) == 4
    for g, r in zip(got, want):
        assert g.shape == r.shape
        assert (g - r).abs().max().item() / max(r.abs().max().item(), 1e-6) < 2e-4


def test_calibrate_matches_jax(activated):
    tiny_cfg, cfg, v, state, x, amax = activated
    got = Q.calibrate(cfg, precast_variables(cfg, state, device="cpu"), [x[:2], x[2:]])
    want = JQ.calibrate(tiny_cfg, v, [x[:2], x[2:]])
    assert set(got) == set(want)
    assert {"stem2", "head_in0", "head_in3", "layer1/block0/downsample"} <= set(got)
    assert set(Q.quant_sites(cfg, "wide", stem2=True)) < set(got)
    for site, m in want.items():
        assert abs(got[site] - m) <= 2e-2 * m, (site, got[site], m)
