"""Launch plans of the two implicit-GEMM kernels, checked on the CPU.

``fused_bottleneck.basic_chain_plan`` (the bf16 BasicBlock kernel,
``csrc/basic_chain.cu``) and ``conv_int8.conv_int8_plan`` (the W8A8 site
conv, ``csrc/conv_int8.cu``) choose each launch's tile, warp grid, weight
ring depth, shared memory and grid in Python; the kernels cannot run here,
so these tests hold the plans to what the kernels need at every w32 and
w48 shape class the serving paths give them, at B = 1, 32 and 128: shared
memory within the H100's 232,448 bytes per block, warps that cover the
tile, tiles that cover the output exactly once (decoded from the grid as
the kernels decode ``blockIdx``), and a ValueError for a shape a kernel
does not take.
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
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.conv_int8 import (CONV_INT8_TILES,
                                                                        conv_int8_plan)
from hrnet_hand_pose_estimation_tpu_torch.ops.kernels.fused_bottleneck import (BASIC_TILES,
                                                                               basic_chain_plan)

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
    (2, 8, 8, 80),       # 80 = 8 * 10: no warp grid of the kernel's n8 tiles
    (2, 8, 8, 24),
    (2, 8, 8, 1024),     # 128 channels a warp: no instance
    (0, 8, 8, 32),
])
def test_basic_chain_plan_raises_on_untaken_shapes(b, h, w, c):
    with pytest.raises(ValueError):
        basic_chain_plan(b, h, w, c)


@pytest.mark.parametrize("b,h,w,cin,cout,k,stride", [
    (2, 8, 8, 24, 32, 3, 1),     # Cin % 16
    (2, 8, 8, 32, 20, 3, 1),     # Cout % 8
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
