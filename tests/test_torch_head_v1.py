"""The port's first version of the fused head (ops/kernels/fused_head_decode.py:
fused_head_decode, head_decode_v1_reference; ops/upsample.kron_interp)
against the JAX package's ``ops/pallas/fused_head_decode.fused_head_decode``.

On the CPU the wrapper runs its plain PyTorch twin; the JAX side runs its
Pallas kernel in interpret mode, as tests/test_pallas_kernels.py does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu.models.hrnet import hrnet_from_cfg as jax_hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu.ops.decode import soft_argmax, spatial_softmax
from hrnet_hand_pose_estimation_tpu.ops.pallas import fused_head_decode as jax_fh
from hrnet_hand_pose_estimation_tpu.ops.upsample import upsample_bilinear_align_corners
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels import _build
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_head_decode import (
    HeadParams, _kron_bf16, _v1_smem, _v1_staging, fused_head_decode, head_decode_v1_reference,
    head_v1_plan, prepare_head_params, v1_weight_stream)
from hrnet_hand_pose_estimation_tpu_torch.ops.upsample import kron_interp
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)

JAX_SHAPES = [(16, 8), (8, 16), (4, 32), (2, 64)]     # tests/test_pallas_kernels.py
W32_SHAPES = [(16, 32), (8, 64), (4, 128), (2, 256)]  # w32 widths on a 64x64 image
W18_SHAPES = [(32, 18), (16, 36), (8, 72), (4, 144)]  # w18 widths on a 128x128 image
# the branch widths of the HRNet widths and of experiments/synthetic_smoke.yaml
V1_WIDTHS = {"w18": (18, 36, 72, 144), "w32": (32, 64, 128, 256), "w40": (40, 80, 160, 320),
             "w48": (48, 96, 192, 384), "smoke": (8, 16, 32, 64)}


def branches(rng, shapes, batch=2):
    return [rng.normal(size=(batch, s, s, c)).astype(np.float32) for s, c in shapes]


def port_v1(xs, params: HeadParams):
    before = fused_head_decode.launches
    xt = [torch.from_numpy(x) for x in xs]
    got = fused_head_decode(xt, params)
    assert fused_head_decode.launches == before           # the CPU runs the twin
    assert torch.equal(got, head_decode_v1_reference(xt, params))
    return got.numpy()


def test_v1_matches_pallas_v1_and_the_f32_head():
    rng = np.random.default_rng(0)
    xs = branches(rng, JAX_SHAPES)
    p = dict(w_head=rng.normal(size=(120, 120)) * 0.1, b_head=rng.normal(size=(120,)) * 0.1,
             w_final=rng.normal(size=(120, 21)) * 0.1, b_final=rng.normal(size=(21,)) * 0.1,
             temp=np.float32(1.3))
    p = {k: np.asarray(a, np.float32) for k, a in p.items()}
    jp = jax_fh.HeadParams(**{k: jnp.asarray(a) for k, a in p.items()})
    want = np.asarray(jax_fh.fused_head_decode([jnp.asarray(x) for x in xs], jp, interpret=True))
    got = port_v1(xs, HeadParams(**{k: torch.from_numpy(a) for k, a in p.items()}))
    assert got.shape == (2, 21, 2) and want.std() > 0.5
    np.testing.assert_allclose(got, want, atol=0.01)

    # the f32 upsample + einsum head of tests/test_pallas_kernels.py
    feats = [jnp.asarray(xs[0])] + [upsample_bilinear_align_corners(jnp.asarray(t), (16, 16))
                                    for t in xs[1:]]
    y = jax.nn.relu(jnp.einsum("bhwc,cd->bhwd", jnp.concatenate(feats, -1), jp.w_head)
                    + jp.b_head)
    logits = jnp.einsum("bhwd,dk->bhwk", y, jp.w_final) + jp.b_final
    ref = np.asarray(soft_argmax(spatial_softmax(logits, 1.3)))
    np.testing.assert_allclose(got, ref, atol=0.05)


def w32_like_variables(tiny_cfg, head: str, seed: int):
    """A seeded tiny-depth model at the w32 widths (480-wide head), with
    its head weights, BN statistics and temperature drawn from numpy at
    scales that spread the decoded coordinates (the init's are near 0)."""
    cfg = tiny_cfg.clone()
    cfg.defrost()
    for n in (2, 3, 4):
        cfg.MODEL.EXTRA[f"STAGE{n}"]["NUM_CHANNELS"] = [32, 64, 128, 256][:n]
    model = jax_hrnet_from_cfg(cfg, head=head)
    v = model.init(jax.random.key(seed), jnp.zeros((1, 64, 64, 3)), False)
    v = jax.tree.map(np.array, v)
    rng = np.random.default_rng(seed)
    for name, scale in (("head_cb", 0.05), ("final_conv", 0.2)):
        leaf = v["params"][name]["conv"] if name == "head_cb" else v["params"][name]
        leaf["kernel"] = (rng.normal(size=leaf["kernel"].shape) * scale).astype(np.float32)
        leaf["bias"] = (rng.normal(size=leaf["bias"].shape) * 0.1).astype(np.float32)
    st = v["batch_stats"]["head_cb"]["bn"]
    st["mean"] = (rng.normal(size=st["mean"].shape) * 0.1).astype(np.float32)
    st["var"] = rng.uniform(0.5, 2.0, size=st["var"].shape).astype(np.float32)
    if head != "plain":
        v["params"]["trainable_temp"] = np.asarray(1.5, np.float32)
    return v


@pytest.mark.parametrize("head", ["softmax", "plain"])
def test_v1_on_w32_widths_matches_jax(tiny_cfg, head):
    v = w32_like_variables(tiny_cfg, head, seed=4)
    jp = jax_fh.prepare_head_params(v)
    params = prepare_head_params(from_jax_variables(v))
    assert params.w_head.shape == (480, 480) and float(params.temp) == float(jp.temp)
    assert float(params.temp) == (1.0 if head == "plain" else 1.5)
    rng = np.random.default_rng(5)
    xs = [np.abs(x) for x in branches(rng, W32_SHAPES)]
    want = np.asarray(jax_fh.fused_head_decode([jnp.asarray(x) for x in xs], jp, interpret=True))
    got = port_v1(xs, params)
    assert got.shape == (2, 21, 2) and want.std() > 0.5
    np.testing.assert_allclose(got, want, atol=0.01)


@pytest.mark.parametrize("src,dst", [(2, 16), (4, 16), (8, 64), (32, 64)])
def test_kron_interp_bit_equal_to_jax(src, dst):
    got, want = kron_interp(src, dst), jax_fh._kron_interp(src, dst)
    assert got.dtype == want.dtype == np.float32 and got.shape == (src * src, dst * dst)
    np.testing.assert_array_equal(got, want)
    assert not got.flags.writeable


def test_v1_refuses_what_the_tpu_kernel_cannot_take():
    rng = np.random.default_rng(6)
    xs = [torch.from_numpy(x) for x in branches(rng, JAX_SHAPES)]
    params = HeadParams(torch.zeros(120, 120), torch.zeros(120), torch.zeros(120, 21),
                        torch.zeros(21), torch.tensor(1.0))
    assert fused_head_decode(xs, params).shape == (2, 21, 2)
    with pytest.raises(ValueError, match="square"):
        fused_head_decode([xs[0], xs[1][:, :, :4]] + xs[2:], params)
    with pytest.raises(ValueError, match="square"):
        fused_head_decode([xs[0][:, :8]] + xs[1:], params)
    with pytest.raises(ValueError, match="K <= 128"):
        fused_head_decode(xs, params._replace(w_final=torch.zeros(120, 129),
                                              b_final=torch.zeros(129)))
    with pytest.raises(ValueError, match="4 branch tensors"):
        fused_head_decode(xs[:3], params)
    with pytest.raises(ValueError, match="w_head"):
        fused_head_decode(xs, params._replace(w_head=torch.zeros(100, 120)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_head_decode([x.to("meta") for x in xs],
                          HeadParams(*(t.to("meta") for t in params)))


@pytest.mark.parametrize("batch", [1, 3, 32, 128])
@pytest.mark.parametrize("k", [21, 128])
@pytest.mark.parametrize("name", list(V1_WIDTHS))
def test_v1_plan(name, k, batch):
    """The v1 kernel's plan at the HRNet widths and the smoke model's (a
    16x16 map): the padded widths, tiles of 128 pixels where the feat tile,
    the staged rows and a ring of 3 fit (64 pixels where not: w40, w48), a
    cluster of up to 8 blocks that the tiles fill, the shared memory within
    the card's 227 KB."""
    widths = V1_WIDTHS[name]
    h0, n = (16 if name == "smoke" else 64), sum(widths)
    sizes = (h0 // 2, h0 // 4, h0 // 8)
    plan = head_v1_plan(batch, h0, widths, n, k, sizes)
    assert all(c % 8 == 0 and 0 <= c - w < 8 for c, w in zip(plan.cp, widths))
    assert plan.ctot % 16 == 0 and 0 <= plan.ctot - sum(plan.cp) < 16
    assert plan.np % 96 == 0 and 0 <= plan.np - n < 96
    assert plan.joint_groups == -(-k // 32) and plan.kblocks == -(-plan.ctot // 64)
    assert plan.chunks * 96 == plan.np
    assert plan.warpgroups == (2 if name in ("w18", "w32", "smoke") else 1)
    assert plan.tiles == -(-h0 * h0 // (64 * plan.warpgroups))
    assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= plan.tiles
    assert plan.cluster == 8 or 2 * plan.cluster > plan.tiles
    assert plan.block_tiles == -(-plan.tiles // plan.cluster) and plan.grid == (plan.cluster, batch)
    assert (3 if plan.warpgroups == 2 else 2) <= plan.stages <= 6
    stage_bytes, rows = _v1_staging(sizes, h0, plan.cp, 64 * plan.warpgroups)
    assert plan.src_rows == rows and all(1 <= r <= s for r, s in zip(rows, sizes))
    assert plan.smem == _v1_smem(plan.warpgroups, plan.kblocks, plan.stages, h0, plan.np,
                                 plan.joint_groups, stage_bytes) <= _build.SMEM_LIMIT
    if plan.warpgroups == 1:     # two warpgroups with a ring of 3 would not fit
        two, _ = _v1_staging(sizes, h0, plan.cp, 128)
        assert _v1_smem(2, plan.kblocks, 3, h0, plan.np, plan.joint_groups,
                        two) > _build.SMEM_LIMIT
    if name == "w32" and k == 21:
        assert (plan.tiles, plan.cluster, plan.block_tiles, plan.stages) == (32, 8, 4, 4)
        assert plan.src_rows == (3, 3, 3)


def random_params(rng, widths, k, scale=0.05, final=0.1):
    n = sum(widths)
    p = dict(w_head=rng.normal(size=(n, n)) * scale, b_head=rng.normal(size=(n,)) * 0.1,
             w_final=rng.normal(size=(n, k)) * final, b_final=rng.normal(size=(k,)) * 0.1,
             temp=np.float32(1.3))
    return {name: np.asarray(a, np.float32) for name, a in p.items()}


def read_slab(slab, rows):
    """A ring stage as the kernel's wgmma descriptors read it: element (r, c)
    of a K block of 64 columns at byte r * 128 + ((c / 8) ^ (r % 8)) * 16 +
    (c % 8) * 2 -> (rows, 64)."""
    r, c = np.meshgrid(np.arange(rows), np.arange(64), indexing="ij")
    return slab[r * 64 + ((c // 8) ^ (r % 8)) * 8 + c % 8]


def stream_weights(stream, plan, k):
    """w_head (ctot, np) and w_final (np, 32 * joint_groups) read back from
    the kernel's weight stream slab by slab."""
    s = stream.float().numpy()
    wh = np.zeros((plan.np, plan.kblocks * 64), np.float32)
    wf = np.zeros((plan.joint_groups * 32, plan.np), np.float32)
    for c in range(plan.chunks):
        for kb in range(plan.kblocks):
            wh[c * 96:(c + 1) * 96, kb * 64:(kb + 1) * 64] = read_slab(s[c, kb], 96)
        for g in range(plan.joint_groups):
            slab = s[c, plan.kblocks + g]
            cols = np.concatenate([read_slab(slab, 32), read_slab(slab[2048:], 32)], axis=1)
            assert not cols[:, 96:].any() and not slab[4096:].any()
            wf[g * 32:(g + 1) * 32, c * 96:(c + 1) * 96] = cols[:, :96]
    return wh.T[:plan.ctot], wf.T


@pytest.mark.parametrize("name,k", [("w18", 21), ("smoke", 21), ("smoke", 128), ("w40", 21)])
def test_v1_weight_stream_holds_the_padded_weights(name, k):
    """The slabs the kernel streams hold w_head at the padded feat columns
    (branch i's rows at cp_0 + .. + cp_{i-1}) and w_final, in bf16, with
    every padding row and column zero."""
    widths = V1_WIDTHS[name]
    p = random_params(np.random.default_rng(7), widths, k)
    params = HeadParams(**{name_: torch.from_numpy(a) for name_, a in p.items()})
    plan = head_v1_plan(2, 16, widths, sum(widths), k, (8, 4, 2))
    stream = v1_weight_stream(params, widths, plan)
    assert stream.dtype == torch.bfloat16
    assert stream.shape == (plan.chunks, plan.kblocks + plan.joint_groups, 6144)
    wh, wf = stream_weights(stream, plan, k)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    want = np.zeros((plan.ctot, plan.np), np.float32)
    offs, feat = np.cumsum([0, *widths]), np.cumsum([0, *plan.cp])
    for i, c in enumerate(widths):
        want[feat[i]:feat[i] + c, :sum(widths)] = bf(p["w_head"][offs[i]:offs[i + 1]])
    np.testing.assert_array_equal(wh, want)
    want = np.zeros((plan.np, plan.joint_groups * 32), np.float32)
    want[:sum(widths), :k] = bf(p["w_final"])
    np.testing.assert_array_equal(wf, want)


def emulate_v1(xs, params, plan):
    """The kernel's arithmetic on the CPU from its padded operands: the feat
    rows at the padded columns, the weights read back from the stream, the
    zero-padded b_head, the softmax of the padded joints' first K."""
    b, h0 = xs[0].shape[:2]
    k = params.w_final.shape[1]
    feat = torch.zeros((b, h0 * h0, plan.ctot))
    col = np.cumsum([0, *plan.cp])
    for i, x in enumerate(xs):
        f = x.to(torch.bfloat16).float().reshape(b, -1, x.shape[3])
        if i:
            f = (_kron_bf16(x.shape[1], h0, "cpu").t() @ f).to(torch.bfloat16).float()
        feat[:, :, col[i]:col[i] + x.shape[3]] = f
    wh, wf = stream_weights(v1_weight_stream(params, tuple(x.shape[3] for x in xs), plan), plan, k)
    b_head = torch.nn.functional.pad(params.b_head, (0, plan.np - params.b_head.shape[0]))
    y = torch.relu(feat @ torch.from_numpy(wh) + b_head).to(torch.bfloat16).float()
    logits = (y @ torch.from_numpy(wf)[:, :k] + params.b_final) * params.temp
    e = torch.exp(logits - logits.amax(dim=1, keepdim=True))
    idx = torch.arange(h0 * h0)
    return torch.stack([(e * (idx % h0).float()[:, None]).sum(1),
                        (e * (idx // h0).float()[:, None]).sum(1)], -1) / e.sum(1)[..., None]


@pytest.mark.parametrize("name,shapes,k", [("w18", W18_SHAPES, 21), ("smoke", JAX_SHAPES, 21),
                                           ("smoke", JAX_SHAPES, 128)])
def test_v1_padded_operands_give_the_twin(name, shapes, k):
    """Zero-padded channels, head columns and joints change nothing: the
    kernel's arithmetic from its padded operands equals the twin within the
    w32 case's 0.01 px.  The final conv's weights are drawn at 0.3 on the
    16x16 map, so that the coordinates spread there too."""
    rng = np.random.default_rng(8)
    xs = [torch.from_numpy(np.abs(x)) for x in branches(rng, shapes)]
    p = random_params(rng, V1_WIDTHS[name], k, final=0.3 if name == "smoke" else 0.1)
    params = HeadParams(**{n: torch.from_numpy(a) for n, a in p.items()})
    plan = head_v1_plan(2, shapes[0][0], V1_WIDTHS[name], sum(V1_WIDTHS[name]), k,
                        tuple(s for s, _ in shapes[1:]))
    want = head_decode_v1_reference(xs, params)
    assert want.std() > 0.5
    np.testing.assert_allclose(emulate_v1(xs, params, plan).numpy(), want.numpy(), atol=0.01)


def test_v1_on_w18_widths_matches_pallas_v1():
    """The port's v1 against JAX's in interpret mode at the w18 widths
    (C_i % 8 != 0, the widths the kernel pads): 0.01 px."""
    rng = np.random.default_rng(9)
    xs = [np.abs(x) for x in branches(rng, W18_SHAPES)]
    p = random_params(rng, V1_WIDTHS["w18"], 21)
    jp = jax_fh.HeadParams(**{k: jnp.asarray(a) for k, a in p.items()})
    want = np.asarray(jax_fh.fused_head_decode([jnp.asarray(x) for x in xs], jp, interpret=True))
    got = port_v1(xs, HeadParams(**{k: torch.from_numpy(a) for k, a in p.items()}))
    assert got.shape == (2, 21, 2) and want.std() > 0.5
    np.testing.assert_allclose(got, want, atol=0.01)
