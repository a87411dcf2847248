"""Read images and XML from files or straight from zip archives, with a PNG
decoder of the port's own.

Port of the JAX package's ``utils/zipreader.py`` (reference
lib/utils/zipreader.py:23-70): a path ``archive.zip@inner/path.jpg`` reads
the member from the archive (one open handle per archive).

``imread`` decodes PNG content itself, in numpy with ``zlib``: 8-bit gray,
gray + alpha, RGB and RGBA, non-interlaced, the five scanline filters.  It
knows a PNG by its signature, not by its name, as ``cv2.imread`` does, and
follows cv2's flags: ``IMREAD_COLOR`` gives (H, W, 3) BGR, gray replicated
and alpha dropped; ``IMREAD_UNCHANGED`` keeps the file's channels, (H, W)
for gray, BGRA for RGBA and gray + alpha.  The result is bit-equal to
``cv2.imread`` (``tests/test_torch_readers_image.py``).
Every other format (JPEG above all) goes to cv2, imported at that call; the
card's machine has no cv2, so JPEG content raises ``ImportError`` there.

Decoding: one path for every filter mix.  Average and Paeth make a byte
depend on its left neighbour, so the image is decoded along anti-diagonals
of pixels, each diagonal one vector step over every row and channel
(H + W - 1 steps); each step computes only the predictors of the filters
that the file uses.
"""

from __future__ import annotations

import struct
import zipfile
import zlib
from typing import Dict, Optional

import numpy as np

# cv2's flag values
IMREAD_UNCHANGED = -1
IMREAD_COLOR = 1
IMREAD_IGNORE_ORIENTATION = 128

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}      # PNG colour type -> samples per pixel

_cache: Dict[str, zipfile.ZipFile] = {}


def split_zip_path(path: str):
    if "@" not in path:
        return None, path
    archive, inner = path.split("@", 1)
    return archive, inner.lstrip("/")


def _archive(path: str) -> zipfile.ZipFile:
    if path not in _cache:
        _cache[path] = zipfile.ZipFile(path, "r")
    return _cache[path]


def read_bytes(path: str) -> bytes:
    archive, inner = split_zip_path(path)
    if archive is None:
        with open(path, "rb") as f:
            return f.read()
    return _archive(archive).read(inner)


def imread(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    """``cv2.imread`` that understands ``archive.zip@inner.png`` paths; PNG
    content is decoded here, any other by cv2."""
    data = read_bytes(path)
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data, flags, name=path)
    try:
        import cv2
    except ImportError as err:
        raise ImportError(f"{path} is not PNG content: decoding it needs cv2, which is not "
                          "installed") from err
    img = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
    if img is None:
        raise ValueError(f"cv2 could not decode {path}")
    return img


def xmlread(path: str) -> bytes:
    return read_bytes(path)


def _chunks(data: bytes, name: str):
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{name}: bad CRC in the PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: PNG ends before its IEND chunk")


def decode_png(data: bytes, flags: int = IMREAD_COLOR, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> uint8 array with ``cv2.imread``'s layout for ``flags``."""
    header: Optional[tuple] = None
    idat = []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise ValueError(f"{name}: PNG of bit depth {depth}, colour type {colour}, interlace "
                         f"{interlace}; the decoder reads 8-bit gray, gray + alpha, RGB and "
                         "RGBA, not interlaced")
    ch = _CHANNELS[colour]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != height * (1 + width * ch):
        raise ValueError(f"{name}: PNG data of {rows.size} bytes for {width}x{height}x{ch}")
    rows = rows.reshape(height, 1 + width * ch)
    pix = unfilter(rows[:, 0], rows[:, 1:].reshape(height, width, ch), name)

    flags = flags & ~IMREAD_IGNORE_ORIENTATION if flags >= 0 else flags
    if flags == IMREAD_UNCHANGED:
        if ch == 1:
            return pix[..., 0]
        if ch == 2:                       # gray + alpha -> BGRA, as cv2 gives it
            return np.ascontiguousarray(pix[..., [0, 0, 0, 1]])
        return np.ascontiguousarray(pix[..., [2, 1, 0, 3][:ch]])
    if flags != IMREAD_COLOR:
        raise ValueError(f"{name}: imread flags {flags} are not supported for PNG content")
    if ch <= 2:
        return np.ascontiguousarray(np.repeat(pix[..., :1], 3, axis=2))
    return np.ascontiguousarray(pix[..., 2::-1])


def _paeth(a, b, c):
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - c - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


# predictor of each filter from the left (a), upper (b) and upper-left (c)
# samples; None (0) predicts zero
_PREDICTORS = {1: lambda a, b, c: a, 2: lambda a, b, c: b,
               3: lambda a, b, c: (a + b) >> 1, 4: _paeth}


def unfilter(ftype: np.ndarray, raw: np.ndarray, name: str = "<bytes>") -> np.ndarray:
    """Undo PNG's per-row filters: ``ftype`` (H,) filter bytes, ``raw``
    (H, W, C) filtered samples -> (H, W, C) uint8 samples.

    Pixel (r, x) lives at ``s[r + x + 1, r + 1]`` of a skewed int16 array
    with a zero diagonal and a zero row in front, and zeros where x falls
    outside the row: diagonal d is ``s[d]``, the left neighbour is on
    ``s[d - 1]`` in the same row, the upper one on ``s[d - 1]`` one row up,
    the upper-left one on ``s[d - 2]`` one row up.  Each filter's predictor
    is added under its rows' 0/1 mask, or unmasked when it filters every
    row."""
    if ftype.size and int(ftype.max()) > 4:
        raise ValueError(f"{name}: unknown PNG filter type {int(ftype.max())}")
    h, w, ch = raw.shape
    s = np.zeros((h + w + 1, h + 1, ch), np.int16)
    st = s.strides
    pix = np.lib.stride_tricks.as_strided(s[1:, 1:], (h, w, ch), (st[0] + st[1], st[0], st[2]))
    pix[...] = raw
    used = [(_PREDICTORS[k], (ftype == k).astype(np.int16)[:, None])
            for k in _PREDICTORS if (ftype == k).any()]
    whole = len(used) == 1 and bool(used[0][1].all())
    for d in range(1, h + w):
        lo, hi = max(0, d - w), min(h, d)
        a, b, c = s[d - 1, lo + 1:hi + 1], s[d - 1, lo:hi], s[d - 2, lo:hi]
        row = s[d, lo + 1:hi + 1]
        for predict, mask in used:
            row += predict(a, b, c) if whole else mask[lo:hi] * predict(a, b, c)
        row &= 255
    return pix.astype(np.uint8)
