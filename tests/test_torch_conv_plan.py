"""Launch plans of the implicit-GEMM kernels, checked on the CPU.

``fused_bottleneck.basic_chain_plan`` (the bf16 BasicBlock kernel,
``csrc/basic_chain.cu``), ``conv_int8.conv_int8_plan`` (the W8A8 site
conv, ``csrc/conv_int8.cu``), ``fused_bottleneck.bottleneck_plan`` (the
layer1 block, ``csrc/fused_bottleneck.cu``) and ``fused_bottleneck.stem_plan``
(the s2d stem, ``csrc/stem_layer1.cu``), and ``int8_chain.int8_bottleneck_plan``
and ``int8_chain.basic_int8_plan`` (the W8A8 layer1 block and BasicBlock,
``csrc/int8_chain.cu`` and ``csrc/basic_int8.cu``) choose each launch's tile, warp
grid, weight ring depth, shared memory and grid in Python; the kernels
cannot run here, so these tests hold the plans to what the kernels need at
every w32 and w48 shape class the serving paths give them, at B = 1, 32
and 128: shared memory within the H100's 232,448 bytes per block, warps
that cover the tile, tiles that cover the output exactly once (decoded
from the grid as the kernels decode ``blockIdx``), and a ValueError for a
shape a kernel does not take.  The widths of the smoke model, HRNet-w18 and
w40 (8 ... 160) are served too: the BasicBlock kernel at a zero-padded
width it takes, ``conv_int8`` and the head at any width.  The head's plan
(``fused_head_decode.head_plan``, the one launch of
``csrc/fused_head_decode.cu``) is held to its row bands, passes, staged
source rows and shared memory, and the band decomposition of its softmax
epilogue (``band_decode_reference``) to the twin's decode.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu_torch.config import (POSE_HIGH_RESOLUTION_NET_EXTRA,
                                                         load_config)
from hrnet_hand_pose_estimation_tpu_torch.core.quant_infer import (quant_sites, site_modules,
                                                                   stage_cfgs)
from hrnet_hand_pose_estimation_tpu_torch.models.hrnet import hrnet_from_cfg
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.conv_int8 import (
    CONV_INT8_TILES, SiteQ, conv_int8_plan, conv_int8_reference, pad_kq)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_bottleneck import (
    BASIC_TILES, BASIC_WIDTHS, basic_chain_plan, basic_chain_reference, basic_chain_width,
    bottleneck_plan, pad_basic_params, stem_plan)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_head_decode import (
    HeadParams, _kernel_weights, _tap_table, band_decode_reference, band_passes,
    head_decode_reference, head_logits_reference, head_plan, slab_layout, soft_argmax_reference)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.int8_chain import (
    BASIC_INT8_TILES, TWO_BLOCKS_SMEM, basic_int8_plan, basic_int8_width, int8_bottleneck_plan,
    pitch_s8)

SMEM_LIMIT = 232448
RES = (64, 32, 16, 8)     # each branch's resolution at a 256 x 256 input


def width_cfg(width):
    cfg = load_config(opts=["MODEL.NAME", "pose_hrnet_softmax"], freeze=False)
    cfg.MODEL.EXTRA.merge_from_mapping(POSE_HIGH_RESOLUTION_NET_EXTRA)
    for n in (2, 3, 4):
        stage = dict(cfg.MODEL.EXTRA[f"STAGE{n}"])
        stage["NUM_CHANNELS"] = [width << i for i in range(n)]
        cfg.MODEL.EXTRA.merge_from_mapping({f"STAGE{n}": stage})
    return cfg.freeze()


def branch_classes(width):
    """(H, C) of every stage 2-4 branch: the BasicBlock kernel's classes."""
    return sorted({(RES[i], c) for stage in stage_cfgs(width_cfg(width))
                   for i, c in enumerate(stage.out_channels)})


def site_input_res(site):
    """The input resolution of an int8 site, from its name."""
    if site == "stem2":
        return 128
    if "/branch" in site:
        return RES[int(site.split("/branch")[1].split("/")[0])]
    if "/fuse" in site:
        i, j, *k = (int(v) for v in site.split("/fuse")[1].split("_"))
        return RES[j + (k[0] if k else 0)]
    t, i, *j = (int(v) for v in site[len("transition"):].split("_"))
    return RES[i] if not j else RES[i - 1 + j[0]]


def conv_classes(width):
    """Counter of (k, stride, Cin, Cout, H) over the 291 sites of the
    shipped int8 path, shapes read from the model's convs."""
    cfg = width_cfg(width)
    with torch.device("meta"):
        model = hrnet_from_cfg(cfg)
    classes = Counter()
    sites = quant_sites(cfg, "exchange", stem2=True)
    for site in sites:
        conv = model.get_submodule(site_modules(site)[0])
        cout, cin, k, _ = conv.weight.shape
        classes[(k, conv.stride[0], cin, cout, site_input_res(site))] += 1
    assert sum(classes.values()) == len(sites) == 291
    return classes


def covered_once(counts):
    return counts.size > 0 and counts.min() == 1 and counts.max() == 1


@pytest.mark.parametrize("batch", [1, 32, 128])
@pytest.mark.parametrize("width", [32, 48])
def test_basic_chain_plan_fits_and_covers(width, batch):
    classes = branch_classes(width)
    assert len(classes) == 4
    for h, c in classes:
        w = h
        p = basic_chain_plan(batch, h, w, c)
        assert p.smem <= SMEM_LIMIT
        # halo, t ring and weight ring, each row C + 8 bf16
        assert p.smem == 2 * (c + 8) * ((p.th + 4) * (p.tw + 4) + (p.th + 2) * (p.tw + 2)
                                        + p.stages * p.ks)
        assert p.mt in BASIC_TILES[p.nt] and 2 <= p.stages <= 4 and c % p.ks == 0
        assert (8 // p.wm) * p.nt * 8 == c and p.wm * (8 // p.wm) == 8
        assert p.wm * p.mt * 16 >= (p.th + 2) * (p.tw + 2)     # conv1's ring fits the warps
        tiles_x, tiles_y = -(-w // p.tw), -(-h // p.th)
        assert p.grid == (tiles_x * tiles_y, batch)
        counts = np.zeros((h, w), np.int32)
        for bx in range(p.grid[0]):                  # as the kernel decodes blockIdx.x
            x0, y0 = (bx % tiles_x) * p.tw, (bx // tiles_x) * p.th
            assert x0 < w and y0 < h                 # no empty block
            counts[y0:y0 + p.th, x0:x0 + p.tw] += 1
        assert covered_once(counts), (h, c)


@pytest.mark.parametrize("batch", [1, 32, 128])
@pytest.mark.parametrize("width", [32, 48])
def test_conv_int8_plan_fits_and_covers(width, batch):
    classes = conv_classes(width)
    for k, stride, cin, cout, h in classes:
        w, pad = h, (k - 1) // 2
        ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
        p = conv_int8_plan(batch, h, w, cin, cout, k, stride)
        assert p.smem <= SMEM_LIMIT
        assert p.smem == -(-p.hr * p.hc * p.ldh // 128) * 128 + p.stages * p.nb * (p.kb + 16)
        assert p.kb == (64 if cin % 64 == 0 else 32)
        assert (p.hr, p.hc) == ((p.tr - 1) * stride + k, (p.tw - 1) * stride + k)
        assert p.ldh % 32 == 16 and p.ldh >= cin + 16           # odd multiple of 16 bytes
        assert (p.wm, p.mt, p.nt) in CONV_INT8_TILES.values() and 2 <= p.stages <= 4
        assert p.wm * p.mt * 16 >= p.tr * p.tw and (8 // p.wm) * p.nt * 8 == p.nb
        tiles_x, tiles_y = -(-wo // p.tw), -(-ho // p.tr)
        assert p.grid == (batch * tiles_x * tiles_y, -(-cout // p.nb))
        counts = np.zeros((batch, ho, wo), np.int32)
        for bx in range(p.grid[0]):                  # as the kernel decodes blockIdx.x
            tx, ty = bx % tiles_x, (bx // tiles_x) % tiles_y
            b = bx // (tiles_x * tiles_y)
            assert b < batch and ty * p.tr < ho and tx * p.tw < wo
            counts[b, ty * p.tr:(ty + 1) * p.tr, tx * p.tw:(tx + 1) * p.tw] += 1
        assert covered_once(counts), (k, stride, cin, cout, h)
        channels = np.zeros(cout, np.int32)
        for by in range(p.grid[1]):                  # blockIdx.y: NB channels each
            assert by * p.nb < cout
            channels[by * p.nb:(by + 1) * p.nb] += 1
        assert covered_once(channels)


@pytest.mark.parametrize("b,h,w,c", [
    (2, 8, 8, 640),      # past 512: no width of the kernel to pad to
    (2, 8, 0, 32),       # empty
    (2, 8, 8, 1024),     # 128 channels a warp: no instance
    (0, 8, 8, 32),
])
def test_basic_chain_plan_raises_on_untaken_shapes(b, h, w, c):
    with pytest.raises(ValueError):
        basic_chain_plan(b, h, w, c)


@pytest.mark.parametrize("b,h,w,cin,cout,k,stride", [
    (0, 8, 8, 24, 32, 3, 1),     # B = 0
    (2, 8, 8, 32, 0, 3, 1),      # no output channel
    (2, 8, 8, 32, 32, 2, 1),     # even k
    (2, 8, 8, 32, 32, 3, 3),     # stride 3
    (2, 0, 8, 32, 32, 5, 2),     # empty output
    (1, 4, 4, 4096, 32, 1, 1),   # Cin > 2048: more 16-byte columns than threads
])
def test_conv_int8_plan_raises_on_untaken_shapes(b, h, w, cin, cout, k, stride):
    with pytest.raises(ValueError):
        conv_int8_plan(b, h, w, cin, cout, k, stride)


def test_plans_at_the_tile_edges():
    """The card tests' edge shapes: each ring depth a plan makes occurs (4
    and 2 for the BasicBlock kernel, 4, 3 and 2 for the int8 conv), one-row
    tiles where a warp's m16 tiles run out, and ragged sizes leave a
    partial last tile."""
    assert [basic_chain_plan(2, 8, 8, 512).stages, basic_chain_plan(2, 64, 64, 32).stages] == [2, 4]
    assert basic_chain_plan(1, 16, 16, 384)[:2] == (1, 16)
    assert {conv_int8_plan(2, 11, 13, 64, 32, 1, 1).stages,
            conv_int8_plan(3, 9, 7, 96, 48, 1, 1).stages,
            conv_int8_plan(1, 5, 70, 32, 32, 3, 1).stages} == {2, 3, 4}
    p = basic_chain_plan(2, 19, 45, 32)
    assert (19 % p.th, 45 % p.tw) != (0, 0)
    p = conv_int8_plan(1, 5, 70, 32, 32, 3, 1)
    assert p.tw == 64 and p.grid[0] == 2 * -(-5 // p.tr)


# -- the layer1 block and the stem (redesigned on the implicit-GEMM mainloop)

@pytest.mark.parametrize("batch", [1, 128])
@pytest.mark.parametrize("cin", [64, 256])
@pytest.mark.parametrize("h,w", [(64, 64), (16, 16), (20, 36), (7, 19)])
def test_bottleneck_plan_fits_and_covers(h, w, cin, batch):
    """layer1's two block classes (64 -> 256 with a projection, 256 -> 256)
    at the flagship's 64 x 64, the smoke model's 16 x 16 and the card
    tests' ragged sizes."""
    p = bottleneck_plan(batch, h, w, cin, 64, 256)
    halo = (p.th + 2) * (p.tw + 2)
    assert p.smem <= SMEM_LIMIT and 2 <= p.stages <= 4 and cin % p.ks == 0
    assert p.smem == 2 * (halo * (cin + 8) + halo * 72 + p.th * p.tw * 72 + p.stages * p.ks * 136)
    assert halo <= 192 and p.th * p.tw <= 128                # conv1's and conv2's warp tiles
    assert ((cin + 8) * 2 // 16) % 2 == 1                    # x rows: odd multiples of 16 bytes
    if (h, w) == (64, 64):
        assert (p.th, p.tw, p.stages) == (8, 16, 4 if cin == 256 else 4)
        assert halo / (p.th * p.tw) <= 1.41                  # conv1's recomputed share
    tiles_x, tiles_y = -(-w // p.tw), -(-h // p.th)
    assert p.grid == (tiles_x * tiles_y, batch)
    counts = np.zeros((h, w), np.int32)
    for bx in range(p.grid[0]):                      # as the kernel decodes blockIdx.x
        x0, y0 = (bx % tiles_x) * p.tw, (bx // tiles_x) * p.th
        assert x0 < w and y0 < h
        counts[y0:y0 + p.th, x0:x0 + p.tw] += 1
    assert covered_once(counts)


@pytest.mark.parametrize("b,h,w,cin,cm,cout", [
    (2, 8, 8, 64, 32, 256),      # Cm != 64
    (2, 8, 8, 64, 64, 96),       # Cout % 128
    (2, 8, 8, 48, 64, 256),      # Cin % 32
    (0, 8, 8, 64, 64, 256),      # B = 0
])
def test_bottleneck_plan_raises_on_untaken_shapes(b, h, w, cin, cm, cout):
    with pytest.raises(ValueError):
        bottleneck_plan(b, h, w, cin, cm, cout)


@pytest.mark.parametrize("batch", [1, 128])
@pytest.mark.parametrize("hs,ws", [(128, 128), (32, 32), (20, 36), (6, 38)])
def test_stem_plan_fits_and_covers(hs, ws, batch):
    """The s2d stem at 256 x 256 and 64 x 64 images and the card tests'
    ragged sizes: every y2 pixel once, the windows within shared memory."""
    p = stem_plan(batch, hs, ws)
    ho, wo = hs // 2, ws // 2
    assert p.smem <= SMEM_LIMIT and 2 <= p.stages <= 4
    assert p.th <= 8 and p.tw <= 16 and p.th * p.tw <= 128   # stem2's 4 x 2 warps of m16 tiles
    assert p.smem == 2 * ((2 * p.th + 2) * (2 * p.tw + 2) * 24 + 64 * 72
                          + (2 * p.th + 1) * (2 * p.tw + 1) * 72 + p.stages * 64 * 72)
    tiles_x, tiles_y = -(-wo // p.tw), -(-ho // p.th)
    assert p.grid == (tiles_x * tiles_y, batch)
    counts = np.zeros((ho, wo), np.int32)
    for bx in range(p.grid[0]):
        x0, y0 = (bx % tiles_x) * p.tw, (bx // tiles_x) * p.th
        assert x0 < wo and y0 < ho
        counts[y0:y0 + p.th, x0:x0 + p.tw] += 1
    assert covered_once(counts)


@pytest.mark.parametrize("b,hs,ws", [(1, 7, 8), (1, 8, 0), (0, 8, 8)])
def test_stem_plan_raises_on_untaken_shapes(b, hs, ws):
    with pytest.raises(ValueError):
        stem_plan(b, hs, ws)


# -- widths the JAX package serves that no kernel instance takes ------------

NEW_WIDTHS = (8, 16, 18, 36, 40, 72, 80, 120, 144, 160)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("c", NEW_WIDTHS)
def test_basic_chain_plan_serves_new_widths(c, batch):
    """A chain of C channels runs at the least width >= C of the kernel's
    instances, zero-padded; its plan fits and covers the map."""
    cp = basic_chain_width(c)
    assert cp >= c and cp in BASIC_WIDTHS and not any(c <= v < cp for v in BASIC_WIDTHS)
    for h in (16, 8, 4, 2):
        p = basic_chain_plan(batch, h, h, c)
        assert p.cp == cp and p.smem <= SMEM_LIMIT and (8 // p.wm) * p.nt * 8 == cp
        assert p.wm * p.mt * 16 >= (p.th + 2) * (p.tw + 2)
        assert p.grid == (-(-h // p.th) * -(-h // p.tw), batch)


@pytest.mark.parametrize("c", NEW_WIDTHS)
def test_padded_basic_twin_matches_unpadded(c):
    """The twin on params zero-padded to the kernel's width (x padded, the
    first C channels back) equals the unpadded twin: the padded channels
    stay exactly 0 and add exact zeros (float32 sums in another order)."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(c)
    params = []
    for _ in range(2):
        params += [torch.tensor(rng.normal(size=(3, 3, c, c)) * (0.6 / np.sqrt(9 * c)),
                                dtype=torch.bfloat16),
                   torch.tensor(rng.normal(size=c) * 0.1, dtype=torch.float32)]
    x = torch.tensor(np.abs(rng.normal(size=(2, 6, 5, c))), dtype=torch.bfloat16)
    padded = pad_basic_params(params)
    assert padded[0].shape[-1] == basic_chain_width(c)
    assert all(torch.equal(p[..., :c, :c] if p.dim() == 4 else p[:c], q)
               for p, q in zip(padded, params))
    want = basic_chain_reference(x, params, 1)
    got = basic_chain_reference(x, padded, 1)
    assert got.shape == want.shape == (2, 6, 5, c)
    diff = (got.float() - want.float()).abs()
    assert diff.max().item() <= 2 ** -7 * want.float().abs().max().item()   # one bf16 ulp
    assert (diff == 0).float().mean().item() > 0.99


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("c", NEW_WIDTHS)
def test_conv_int8_plan_serves_new_widths(c, batch):
    """Any Cin and Cout: the weights at a pitch of Cin rounded up to 16, the
    halo as wide, the output channels covered once."""
    for cin, cout, k, stride in ((c, c, 3, 1), (c, 2 * c, 3, 2), (2 * c, c, 1, 1), (256, c, 3, 1)):
        h = 16
        p = conv_int8_plan(batch, h, h, cin, cout, k, stride)
        assert p.cinp == -(-cin // 16) * 16 and p.cinp - cin < 16
        assert p.ldh % 32 == 16 and p.ldh >= p.cinp + 16 and p.smem <= SMEM_LIMIT
        assert p.kb == (64 if p.cinp % 64 == 0 else 32)
        assert p.grid[1] * p.nb >= cout > (p.grid[1] - 1) * p.nb


@pytest.mark.parametrize("c", NEW_WIDTHS)
def test_padded_conv_int8_twin_matches(c):
    """``pad_kq``'s view has kq's shape and values and a pitch of Cin rounded
    up to 16; the twin through it is bit-equal."""
    rng = np.random.default_rng(c)
    kq = torch.from_numpy(rng.integers(-127, 128, size=(c, 3, 3, c)).astype(np.int8))
    view = pad_kq(kq)
    cinp = -(-c // 16) * 16
    assert view.shape == kq.shape and torch.equal(view, kq)
    assert view.stride() == (9 * cinp, 3 * cinp, cinp, 1)
    assert (view.storage_offset(), view.untyped_storage().nbytes()) == (0, c * 9 * cinp)
    q = SiteQ(kq=kq, wscale=torch.full((c,), 0.01), sa=torch.tensor(0.05),
              scale=torch.full((c,), 5e-4), bias=torch.tensor(rng.normal(size=c), dtype=torch.float32))
    x = torch.tensor(np.abs(rng.normal(size=(2, 7, 6, c))) * 3, dtype=torch.bfloat16)
    assert torch.equal(conv_int8_reference(x, q._replace(kq=view), 2),
                       conv_int8_reference(x, q, 2))


def check_head_plan(p, batch, shapes, widths, n, k):
    """What the head kernel needs of its plan: padded pitches, at most 8
    bands (one cluster) that cover every output row exactly once, passes
    of at most 32 m16 tiles whose staged source rows reach every bilinear
    tap, at most 12 m16 tiles of each branch GEMM, at most 4 head tiles a
    warp, a W-mix window that holds every tap of 16 output columns, and
    the shared memory."""
    (h0, w0), groups = shapes[0], -(-shapes[0][1] // 16)
    assert p.cp == tuple(-(-c // 16) * 16 for c in widths) and p.np == -(-n // 32) * 32
    assert p.joint_groups == -(-k // 32) and p.chunk == 32
    assert 1 <= p.bands <= 8 and p.grid == (p.bands, batch) and p.cluster == (p.bands, 1, 1)
    assert (p.bands - 1) * p.band_rows < h0 <= p.bands * p.band_rows
    rows = np.zeros(h0, np.int32)
    taps = _tap_table(tuple(shapes[1:]), h0, w0)
    for y, r in band_passes(h0, p.bands, p.band_rows, p.pass_rows):
        assert 1 <= r <= p.pass_rows and r * groups <= 32
        assert y // p.band_rows == (y + r - 1) // p.band_rows     # a pass stays in its band
        rows[y:y + r] += 1
        for i, (h, w) in enumerate(shapes[1:]):
            lo = taps[i, 0, 0].astype(int)
            need = lo[y + r - 1] + 2 - lo[y]                         # source rows the pass reads
            assert need <= p.src_rows[i] <= h and -(-(p.src_rows[i] * w) // 16) <= 12
            assert (lo[y:y + r] + 1 < h).all()
    assert covered_once(rows)
    for i in range(3):
        lo = taps[i, 1, 0, :w0].astype(int)
        for x in range(0, w0, 16):
            assert lo[min(x + 15, w0 - 1)] + 1 - lo[x] < 16 * p.kw
    units = groups * -(-p.pass_rows // p.unit_rows)      # the warps' units of head tiles
    assert p.unit_rows in (1, 2, 4) and -(-units // 8) * p.unit_rows <= 4
    assert p.slab_rows % 16 == 0 and p.slab_rows >= max(128, p.cp[0] + 32)
    assert p.slab_rows in (max(128, p.cp[0] + 32), max(*p.cp[1:], p.cp[0] + 32))
    assert 2 <= p.stages <= 6
    assert p.smem <= SMEM_LIMIT


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("c", NEW_WIDTHS)
def test_head_plan_serves_new_widths(c, batch):
    """The head at branch widths c and 2c (a head 6c wide) on the smoke
    model's maps (a 2x2 coarsest one), K up to 128; K = 129 is refused."""
    widths = (c, c, 2 * c, 2 * c)
    n = sum(widths)
    shapes = ((16, 16), (8, 8), (4, 4), (2, 2))
    for k in (21, 128):
        check_head_plan(head_plan(batch, shapes, widths, n, k), batch, shapes, widths, n, k)
    with pytest.raises(ValueError, match="K <= 128"):
        head_plan(batch, shapes, widths, n, 129)


@pytest.mark.parametrize("batch", [1, 4])
def test_head_plan_rows_at_small_maps(batch):
    """The smoke model's maps (16 x 16 down to a 2x2 coarsest one, B*h*w of
    branches 1-3 as small as 64, 16 and 4 at B = 1): one band of all 16
    rows in one pass, all of each branch's rows staged, warps in units of
    2 rows (8 units for the 8 warps), the 120-wide head at 128 columns."""
    shapes = ((16, 16), (8, 8), (4, 4), (2, 2))
    p = head_plan(batch, shapes, (8, 16, 32, 64), 120, 21)
    check_head_plan(p, batch, shapes, (8, 16, 32, 64), 120, 21)
    assert (p.bands, p.band_rows, p.pass_rows, p.unit_rows) == (1, 16, 16, 2)
    assert p.src_rows == (8, 4, 2) and p.np == 128 and p.grid == (1, batch)


HEAD_MAPS = [((16, 16), (8, 8), (4, 4), (2, 2)),        # the smoke model
             ((20, 64), (10, 32), (5, 16), (3, 8)),      # 3 bands of 7, 7 and 6 rows
             ((64, 64), (32, 32), (16, 16), (8, 8)),     # the flagship: 8 bands of 8
             ((96, 96), (48, 48), (24, 24), (12, 12)),   # 8 bands of 12, passes of 4
             ((20, 36), (10, 18), (5, 9), (3, 5))]       # non-square, W0 not a multiple of 16


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("shapes", HEAD_MAPS)
def test_head_plan_bands_cover_rows(shapes, batch):
    """Bands and passes at the w32 widths, H0 of 16, 20, 64 and 96 rows
    (not all divisible by the band count) and a non-square map."""
    widths = (32, 64, 128, 256)
    p = head_plan(batch, shapes, widths, 480, 21)
    check_head_plan(p, batch, shapes, widths, 480, 21)
    if shapes[0] == (64, 64):
        assert (p.bands, p.band_rows, p.pass_rows) == (8, 8, 8)
    if shapes[0] == (20, 64):
        assert (p.bands, p.band_rows) == (3, 7)


@pytest.mark.parametrize("widths", [(64, 128, 256, 512), (96, 192, 384, 768)])
def test_head_plan_wide_heads(widths):
    """w64's 960-wide head and a 1440-wide one (the three-launch kernel
    stopped near 1080) on the flagship's 64 x 64 map: the weights stream in
    slabs, so only the staged rows grow with the width."""
    shapes = HEAD_MAPS[2]
    p = head_plan(128, shapes, widths, sum(widths), 21)
    check_head_plan(p, 128, shapes, widths, sum(widths), 21)


@pytest.mark.parametrize("rows,chunks,groups", [(48, 3, 0), (16, 4, 0), (256, 15, 0), (96, 3, 2),
                                                (480, 15, 1)])
def test_slab_layout_reads_back(rows, chunks, groups):
    """The wrapper's weight layout read back through the kernel's slab_addr:
    row r's 16-byte piece cg sits at piece cg ^ ((r >> 1) & 3) of its
    64-byte row, each chunk of 32 columns (and, for w_final, each joint
    group's chunk of 32 rows) contiguous."""
    cols = 32 * (groups or chunks)
    w = torch.arange(rows * cols, dtype=torch.float32).reshape(rows, cols)
    lay = slab_layout(w, groups)
    if groups:
        assert lay.shape == (groups, rows // 32, 32, 32)
        blocks = {(g, c): (lay[g, c], w[c * 32:(c + 1) * 32, g * 32:(g + 1) * 32])
                  for g in range(groups) for c in range(rows // 32)}
    else:
        assert lay.shape == (chunks, rows, 32)
        blocks = {c: (lay[c], w[:, c * 32:(c + 1) * 32]) for c in range(chunks)}
    for got, want in blocks.values():
        flat = got.reshape(-1)
        for r in range(got.shape[0]):
            for cg in range(4):
                at = r * 32 + (cg ^ ((r >> 1) & 3)) * 8        # slab_addr in elements
                assert torch.equal(flat[at:at + 8], want[r, cg * 8:cg * 8 + 8])


def test_kernel_weights_follow_the_parameters():
    """The head's laid-out weights are made once per parameter tensors and
    made anew when a parameter changes in place, when new tensors come, and
    on every call for inference tensors (no version counter)."""
    xs, params = band_case(HEAD_MAPS[0], 21)
    shapes = tuple(tuple(x.shape[1:3]) for x in xs)
    plan = head_plan(2, shapes, tuple(x.shape[3] for x in xs), params.w_final.shape[0], 21)
    first = _kernel_weights(xs, params, None, plan)
    assert _kernel_weights(xs, params, None, plan)[0] is first[0]
    params.w_head.mul_(2.0)
    again = _kernel_weights(xs, params, None, plan)
    assert again[0] is not first[0] and torch.equal(again[0][0].float(), 2 * first[0][0].float())
    fresh = params._replace(w_head=params.w_head.clone())
    assert _kernel_weights(xs, fresh, None, plan)[0] is not again[0]
    with torch.inference_mode():
        frozen = HeadParams(*(t.clone() for t in params))
        assert _kernel_weights(xs, frozen, None, plan)[0] is not _kernel_weights(
            xs, frozen, None, plan)[0]


def band_case(shapes, k):
    """Branch tensors (smoke widths) and head params from a seed, as numpy-made
    torch tensors."""
    rng = np.random.default_rng(k + shapes[0][1])
    widths = (8, 16, 32, 64)
    n = sum(widths)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    params = HeadParams(f32(rng.normal(size=(n, n)) * 0.05), f32(rng.normal(size=n) * 0.1),
                        f32(rng.normal(size=(n, k)) * 0.3), f32(rng.normal(size=k) * 0.1),
                        f32(np.float32(1.3)))
    xs = [f32(rng.normal(size=(2, *hw, c))).to(torch.bfloat16) for hw, c in zip(shapes, widths)]
    return xs, params


@pytest.mark.parametrize("k", [1, 21, 128])
@pytest.mark.parametrize("bands", range(1, 9))
@pytest.mark.parametrize("shapes", [HEAD_MAPS[0], HEAD_MAPS[4]])
def test_band_decode_matches_twin(shapes, bands, k):
    """The kernel's epilogue split into 1-8 row bands, each band's (m, sum
    e, sum e*u, sum e*v) combined by exp(m - M), agrees with the twin's
    softmax decode within 1e-5 px on the twin's logits (square and
    non-square maps).  The algebra is compared in float64: in float32 the
    order of the sums alone moves the decode by ~2e-5 px over 720 pixels."""
    torch.set_num_threads(1)
    xs, params = band_case(shapes, k)
    logits = head_logits_reference(xs, params)
    want = head_decode_reference(xs, params)
    assert torch.equal(soft_argmax_reference(logits), want)     # the twin's own decode
    got = band_decode_reference(logits.double(), bands)
    want64 = soft_argmax_reference(logits.double())
    assert got.shape == want.shape == (2, k, 2) and want.std().item() > 0.5
    assert (got - want64).abs().max().item() <= 1e-5
    assert (got.float() - want).abs().max().item() <= 1e-4     # and the float32 twin


# -- the W8A8 layer1 block and BasicBlock (redesigned on the implicit-GEMM mainloop)

SM_SMEM = 233472           # shared memory of one H100 SM; each block reserves 1 KB more

INT8_L1_SHAPES = [(64, 64), (16, 16), (20, 36), (7, 19), (13, 16), (16, 21), (8, 8), (3, 5)]


def covers(grid, th, tw, h, w):
    """Whether the tiles of a (tiles, B) grid, decoded from blockIdx.x as
    the kernels decode it, cover the h x w map exactly once."""
    tiles_x = -(-w // tw)
    assert grid[0] == tiles_x * -(-h // th)
    counts = np.zeros((h, w), np.int32)
    for bx in range(grid[0]):
        x0, y0 = (bx % tiles_x) * tw, (bx // tiles_x) * th
        assert x0 < w and y0 < h                     # no empty block
        counts[y0:y0 + th, x0:x0 + tw] += 1
    return covered_once(counts)


@pytest.mark.parametrize("batch", [1, 128])
@pytest.mark.parametrize("cin,proj", [(64, True), (256, False)])
@pytest.mark.parametrize("h,w", INT8_L1_SHAPES)
def test_int8_bottleneck_plan_fits_and_covers(h, w, cin, proj, batch):
    """layer1's two W8A8 block classes (64 -> 256 with a projection, 256 ->
    256) at the flagship's 64 x 64, the smoke model's 16 x 16 and every
    shape of the card tests: two blocks per SM."""
    p = int8_bottleneck_plan(batch, h, w, cin, 64, 256, proj)
    halo, tile = (p.th + 2) * (p.tw + 2), p.th * p.tw
    # the x halo (the identity stages y over it), for the projection y's
    # staging rows, t1, t2 and the weight ring of 64-byte slabs
    used = (halo * pitch_s8(cin) + (tile * 72 * 2 if proj else 0) + (halo + tile) * 80
            + p.stages * (64 if proj else 128) * 80)
    assert pitch_s8(cin) % 32 == 16 and pitch_s8(cin) >= cin + 16   # odd multiples of 16
    assert halo <= 192 and p.th * p.tw <= 128                      # conv1's and conv2's warps
    assert p.smem == used and 2 * (p.smem + 1024) <= SM_SMEM and 2 <= p.stages <= 4
    if (h, w) == (64, 64):
        assert (p.th, p.tw, p.stages) == (8, 16, 4)
    assert p.grid[1] == batch and covers(p.grid, p.th, p.tw, h, w)


@pytest.mark.parametrize("b,h,w,cin,cm,cout,proj", [
    (2, 8, 8, 64, 32, 256, True),      # Cm != 64
    (2, 8, 8, 64, 64, 192, True),      # Cout != 256
    (2, 8, 8, 64, 64, 128, True),
    (2, 8, 8, 48, 64, 256, True),      # Cin not 64 or 256
    (2, 8, 8, 96, 64, 256, True),
    (2, 8, 8, 128, 64, 128, False),
    (2, 8, 8, 64, 64, 256, False),     # an identity shortcut with Cin != Cout
    (0, 8, 8, 64, 64, 256, True),      # B = 0
])
def test_int8_bottleneck_plan_raises_on_untaken_shapes(b, h, w, cin, cm, cout, proj):
    with pytest.raises(ValueError):
        int8_bottleneck_plan(b, h, w, cin, cm, cout, proj)


def check_basic_int8_plan(p, b, h, w, c):
    """What csrc/basic_int8.cu's entry checks of a plan, and coverage."""
    ring = (p.th + 2) * (p.tw + 2)
    assert p.cp == basic_int8_width(c) >= c and p.cp % 16 == 0
    assert p.smem <= SMEM_LIMIT and p.smem == (pitch_s8(p.cp) * ((p.th + 4) * (p.tw + 4) + ring)
                                               + p.stages * p.cp * (p.kb + 16))
    assert p.mt in BASIC_INT8_TILES[p.nt] and 2 <= p.stages <= 4
    assert (8 // p.wm) * p.nt * 8 == p.cp and p.wm * (8 // p.wm) == 8
    assert p.wm * p.mt * 16 >= ring                                # conv1's ring fits the warps
    assert p.kb == (64 if p.cp % 64 == 0 else 32)
    assert p.grid[1] == b and covers(p.grid, p.th, p.tw, h, w)


@pytest.mark.parametrize("batch", [1, 32, 128])
@pytest.mark.parametrize("width", [32, 48])
def test_basic_int8_plan_fits_and_covers(width, batch):
    """Every w32 and w48 branch class runs at its own width."""
    classes = branch_classes(width)
    assert len(classes) == 4
    for h, c in classes:
        p = basic_int8_plan(batch, h, h, c)
        assert p.cp == c
        check_basic_int8_plan(p, batch, h, h, c)


@pytest.mark.parametrize("b,h,w,c", [
    (1, 64, 64, 32), (3, 32, 32, 64), (1, 16, 16, 128), (2, 8, 8, 256),   # the card tests' classes
    (1, 64, 64, 48), (2, 32, 32, 96), (1, 16, 16, 192), (2, 8, 8, 384),
    (2, 13, 21, 32), (1, 11, 9, 64), (1, 9, 7, 128), (2, 5, 3, 48),        # ragged tiles
    (1, 16, 16, 16), (2, 10, 12, 80), (1, 8, 8, 512), (1, 1, 1, 32),
])
def test_basic_int8_plan_takes_the_card_tests_shapes(b, h, w, c):
    check_basic_int8_plan(basic_int8_plan(b, h, w, c), b, h, w, c)


@pytest.mark.parametrize("b,h,w,c", [
    (1, 8, 8, 40),      # C % 16
    (1, 8, 8, 528),     # past the widest warp grid
    (0, 8, 8, 32),      # B = 0
    (1, 0, 8, 32),      # an empty map
])
def test_basic_int8_plan_raises_on_untaken_shapes(b, h, w, c):
    with pytest.raises(ValueError):
        basic_int8_plan(b, h, w, c)


def test_two_blocks_share_an_sm_at_layer1():
    """The W8A8 layer1 chain's blocks at 64 x 64: shared memory for two per
    SM at Cin 64 and 256 (the bf16 block kernel needs one SM each at 256)."""
    for cin, proj in ((64, True), (256, False)):
        p = int8_bottleneck_plan(128, 64, 64, cin, 64, 256, proj)
        assert p.smem <= TWO_BLOCKS_SMEM and 2 * (p.smem + 1024) <= SM_SMEM
    assert 2 * (bottleneck_plan(128, 64, 64, 256, 64, 256).smem + 1024) > SM_SMEM


@pytest.mark.parametrize("h,w", INT8_L1_SHAPES + [(200, 1), (100, 2), (1, 300)])
def test_int8_bottleneck_identity_staging_fits_over_the_halo(h, w):
    """With the identity shortcut the kernel stages y (tile pixels x 136
    bf16) over the x halo (halo pixels x pitch_s8(256) bytes): it fits at
    every tile the plan makes, thin ones included."""
    p = int8_bottleneck_plan(2, h, w, 256, 64, 256, False)
    halo, tile = (p.th + 2) * (p.tw + 2), p.th * p.tw
    assert tile * 136 * 2 <= halo * pitch_s8(256)
