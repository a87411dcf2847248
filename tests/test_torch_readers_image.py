"""The readers' host image path in the port, without cv2: the PNG decoder of
``utils/zipreader``, the helpers of ``data/cv.py``, ``data/native.py`` and
the legend tables, against cv2 5.0 and the JAX package's modules.

- PNG: ``cv2.imwrite``'d gray, RGB and RGBA files at compression 0-9 and at
  cv2's default (Sub rows only), and files of the tree writer with every
  row filter cycled (gray + alpha too), decoded bit-equal to
  ``cv2.imread`` under IMREAD_COLOR (with and without
  IMREAD_IGNORE_ORIENTATION) and IMREAD_UNCHANGED;
- the filled circle, radii 1-60, centres inside, across the borders and
  outside: bit-equal to ``cv2.circle(..., -1)``;
- Rodrigues: 1e-12; resize (INTER_LINEAR, uint8): within one gray level
  of ``cv2.resize`` (measured: bit-equal on the downscales below, MHP's
  640x480 frames to 256 and 368 among them; one level off on 0.3-1.5 % of
  the pixels of the upscales).
"""

import os
import subprocess
import sys
import zipfile
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import torch_reader_trees as trees
from hrnet_hand_pose_estimation_tpu.data import legends as JL
from hrnet_hand_pose_estimation_tpu.data import native as JN
from hrnet_hand_pose_estimation_tpu.utils import zipreader as JZ
from hrnet_hand_pose_estimation_tpu_torch.data import cv as C
from hrnet_hand_pose_estimation_tpu_torch.data import legends as L
from hrnet_hand_pose_estimation_tpu_torch.data import native as N
from hrnet_hand_pose_estimation_tpu_torch.utils import zipreader as Z

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _content(channels: int, h: int = 37, w: int = 53, seed: int = 0) -> np.ndarray:
    img = trees.image(h, w, seed, channels=max(channels, 1))
    return img[..., 0] if channels == 1 else img


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decoder_matches_cv2_at_every_compression(tmp_path, channels):
    """cv2.imwrite at compression 0-9 (libpng's adaptive filters: on smooth
    and on noise content all five kinds appear) and at its default (Sub on
    every row), bit-equal."""
    noise = np.random.default_rng(9).integers(0, 256, size=_content(channels).shape)
    seen = set()
    for img, level in [(img, level) for img in (_content(channels), noise.astype(np.uint8))
                       for level in [None, *range(10)]]:
        path = str(tmp_path / f"{level}.png")
        cv2.imwrite(path, img, [] if level is None else [cv2.IMWRITE_PNG_COMPRESSION, level])
        data = open(path, "rb").read()
        rows = np.frombuffer(zlib.decompress(b"".join(
            body for kind, body in Z._chunks(data, path) if kind == b"IDAT")), np.uint8)
        seen |= set(rows.reshape(img.shape[0], -1)[:, 0].tolist())
        for flags in (cv2.IMREAD_COLOR, cv2.IMREAD_UNCHANGED,
                      cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION):
            got, want = Z.imread(path, flags), cv2.imread(path, flags)
            assert got.dtype == want.dtype and got.shape == want.shape, (level, flags)
            np.testing.assert_array_equal(got, want, err_msg=f"level {level} flags {flags}")
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filters", ["sub", "mixed"])
def test_tree_writer_pngs_decode_as_cv2(tmp_path, channels, filters):
    """The tree writer's PNGs (gray + alpha included, rows cycling the five
    filters) under a .jpg name: read by signature, bit-equal to cv2."""
    img = trees.image(29, 41, 3, channels=channels)
    path = tmp_path / "frame.jpg"
    trees.write_png(path, img, filters)
    for flags in (cv2.IMREAD_COLOR, cv2.IMREAD_UNCHANGED):
        got, want = Z.imread(str(path), flags), cv2.imread(str(path), flags)
        np.testing.assert_array_equal(got, want)
    if channels >= 3:
        np.testing.assert_array_equal(Z.imread(str(path)), img[..., 2::-1])


def test_zip_paths_jpeg_and_errors(tmp_path, monkeypatch):
    """``archive.zip@inner`` reads the member, as the JAX zipreader does;
    JPEG content goes to cv2; without cv2 it raises ImportError naming cv2
    and the file; a corrupted chunk raises."""
    png = trees.png_bytes(trees.image(16, 24, 1))
    ok, jpg = cv2.imencode(".jpg", trees.image(16, 24, 2)[..., ::-1])
    archive = tmp_path / "set.zip"
    with zipfile.ZipFile(archive, "w") as zf:
        zf.writestr("imgs/a.png", png)
        zf.writestr("imgs/b.jpg", jpg.tobytes())
        zf.writestr("meta.xml", b"<a/>")
    for inner in ("imgs/a.png", "imgs/b.jpg"):
        path = f"{archive}@/{inner}"
        np.testing.assert_array_equal(Z.imread(path), JZ.imread(path))
    assert Z.split_zip_path(f"{archive}@/x/y.png") == JZ.split_zip_path(f"{archive}@/x/y.png")
    assert Z.xmlread(f"{archive}@meta.xml") == JZ.xmlread(f"{archive}@meta.xml") == b"<a/>"
    plain = tmp_path / "c.jpg"
    plain.write_bytes(jpg.tobytes())
    np.testing.assert_array_equal(Z.imread(str(plain)), cv2.imread(str(plain)))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2") as err:
        Z.imread(str(plain))
    assert str(plain) in str(err.value)
    np.testing.assert_array_equal(Z.imread(f"{archive}@imgs/a.png"),
                                  trees.image(16, 24, 1)[..., ::-1])
    bad = bytearray(png)
    bad[40] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        Z.decode_png(bytes(bad))


def test_png_decode_time_per_320px_frame(tmp_path):
    """Prints the decode time of a 320x320 RGB frame (RHD's size) with Sub
    rows only (cv2.imwrite's default) and with rows of all five filters,
    both decoded along the anti-diagonals."""
    import time

    img = trees.image(320, 320, 5)
    for filters in ("sub", "mixed"):
        data = trees.png_bytes(img, filters)
        t = time.perf_counter()
        for _ in range(3):
            got = Z.decode_png(data, Z.IMREAD_UNCHANGED)
        ms = (time.perf_counter() - t) / 3 * 1e3
        np.testing.assert_array_equal(got, img[..., ::-1])
        print(f"decode_png 320x320x3, {filters} rows: {ms:.1f} ms")


@pytest.mark.parametrize("shape", [(48, 64, 3), (31, 29), (40, 40, 4)])
def test_circle_is_cv2s(shape):
    """Radii 1-60 at centres inside, across each border and outside."""
    g = np.random.default_rng(1)
    h, w = shape[:2]
    centres = [(w // 2, h // 2), (0, 0), (w - 1, h - 1), (-5, h // 3), (w + 3, 5),
               (w // 3, -20), (w // 2, h + 10), (-70, -70)]
    for r in range(1, 61):
        for cx, cy in centres + [tuple(g.integers(-30, 90, 2))]:
            base = g.integers(0, 256, size=shape).astype(np.uint8)
            color = (0, 0, 0, 0) if r % 2 else (10, 200, 37, 99)
            want = cv2.circle(base.copy(), (int(cx), int(cy)), r, color, -1)
            got = C.circle_filled(base.copy(), (cx, cy), r, color)
            np.testing.assert_array_equal(got, want, err_msg=f"r {r} at {(cx, cy)}")


def test_rodrigues_and_colour_order():
    g = np.random.default_rng(2)
    for rvec in [np.zeros(3), np.array([1e-20, 0, 0]), np.array([np.pi, 0, 0]),
                 *g.normal(size=(20, 3)), *(g.normal(size=(5, 3)) * 1e-4)]:
        for shape in ((3,), (3, 1), (1, 3)):
            want = cv2.Rodrigues(rvec.reshape(shape))[0]
            np.testing.assert_allclose(C.rodrigues(rvec.reshape(shape)), want, rtol=0, atol=1e-12)
    img = g.integers(0, 256, size=(7, 9, 3)).astype(np.uint8)
    np.testing.assert_array_equal(C.bgr_to_rgb(img), cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    np.testing.assert_array_equal(C.bgr_to_rgb(img), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


@pytest.mark.parametrize("src, dst", [((480, 640), (256, 256)), ((480, 640), (368, 368)),
                                      ((37, 53), (64, 64)), ((64, 64), (32, 32)),
                                      ((100, 80), (33, 71)), ((16, 16), (50, 40))])
def test_resize_within_a_gray_level_of_cv2(src, dst):
    """INTER_LINEAR on uint8 (MHP's 640x480 frames to the CPM inputs among
    them): at most one gray level from cv2.resize; the share of pixels off
    by one is printed."""
    for seed, ch in ((0, 3), (1, 1)):
        img = trees.image(*src, seed, channels=ch)
        img = img[..., 0] if ch == 1 else img
        want = cv2.resize(img, dst[::-1]).astype(int)
        got = C.resize(img, dst[::-1]).astype(int)
        assert got.shape == want.shape
        diff = np.abs(got - want)
        assert diff.max() <= 1
        print(f"resize {src} -> {dst} x{ch}: max {diff.max()}, off share {(diff > 0).mean():.2e}")


def test_native_matches_jax(monkeypatch):
    """normalize_collate and gaussian_targets_native: the port's bindings of
    its own build of native/fastops.cpp (under build/native/) give the JAX
    package's numbers.  JAX's loader is pointed at the same library
    (``HANDPOSE_NATIVE_LIB``), so a JAX build of native/ running in another
    test process at the same time cannot leave it half-written."""
    g = np.random.default_rng(3)
    imgs = g.integers(0, 256, size=(3, 20, 24, 3)).astype(np.uint8)
    joints = g.uniform(-2, 18, size=(3, 21, 2)).astype(np.float32)
    vis = (g.uniform(size=(3, 21)) > 0.2).astype(np.float32)
    if N.native_available():
        monkeypatch.setenv("HANDPOSE_NATIVE_LIB", str(N.LIB_PATH))
    else:
        monkeypatch.setenv("HANDPOSE_NO_NATIVE", "1")
    monkeypatch.setattr(JN, "_LIB", None)
    monkeypatch.setattr(JN, "_TRIED", False)
    assert N.native_available() == JN.native_available()
    np.testing.assert_array_equal(N.normalize_collate(imgs), JN.normalize_collate(imgs))
    np.testing.assert_array_equal(N.gaussian_targets_native(joints, vis, 16, 2.0),
                                  JN.gaussian_targets_native(joints, vis, 16, 2.0))
    if N.native_available():
        assert str(N.LIB_PATH).startswith(str(REPO / "build"))
    with pytest.raises(ValueError):
        N.normalize_collate(imgs.astype(np.float32))


def test_native_fallback_without_the_library():
    """HANDPOSE_NO_NATIVE: numpy, with the JAX package's fallback numbers."""
    code = ("import numpy as np\n"
            "from hrnet_hand_pose_estimation_tpu_torch.data import native as N\n"
            "from hrnet_hand_pose_estimation_tpu.data import native as JN\n"
            "g = np.random.default_rng(4)\n"
            "x = g.integers(0, 256, size=(2, 8, 8, 3)).astype(np.uint8)\n"
            "j = g.uniform(0, 16, size=(2, 21, 2)).astype(np.float32)\n"
            "v = np.ones((2, 21), np.float32)\n"
            "assert not N.native_available() and not JN.native_available()\n"
            "assert (N.normalize_collate(x) == JN.normalize_collate(x)).all()\n"
            "assert (N.gaussian_targets_native(j, v, 16) == JN.gaussian_targets_native(j, v, 16)).all()\n")
    env = dict(os.environ, HANDPOSE_NO_NATIVE="1", PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


def test_legends_match_jax():
    assert L.STD_LEGEND == JL.STD_LEGEND and L.NUM_JOINTS == JL.NUM_JOINTS
    for name in ("IDX_RHD", "IDX_FREI", "IDX_HANDGRAPH", "IDX_FHA", "IDX_MHP", "KC_MATRIX",
                 "BONE_PARENTS", "BONE_CHILDREN", "BONE_PARENTS_REF"):
        np.testing.assert_array_equal(getattr(L, name), getattr(JL, name), err_msg=name)
