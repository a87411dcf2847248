"""Space-to-depth rewrite of the stride-2 stem convs.

Port of the algebra of the JAX package's ``core/fast_infer.py``
(``_space_to_depth``, ``_s2d_kernel``).  A 3x3 / stride-2 / pad-1 conv is
exactly a 2x2 / stride-1 conv over the space-to-depth input with padding 1
at the top and left only, with 4x the input channels: output (i, j) reads
input rows 2i-1..2i+1, which in 2x2-block coordinates are blocks i-1 (row
parity 1, tap kh=0) and i (parities 0 and 1, taps kh=1 and 2).  The sums are
the same up to float summation order.
"""

from __future__ import annotations

import torch


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C); channel = (pr*2 + pc)*C + c."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def s2d_kernel(k: torch.Tensor) -> torch.Tensor:
    """A 3x3/stride-2/pad-1 conv kernel (Cout, Cin, 3, 3), OIHW, rewritten for
    the space-to-depth input: (Cout, 4*Cin, 2, 2), zero where no tap lands.

    Tap kh maps to block row bi and pixel parity pr: kh=0 -> (0, 1),
    kh=1 -> (1, 0), kh=2 -> (1, 1); the same for kw -> (bj, pc)."""
    cout, cin = k.shape[:2]
    k2 = k.new_zeros((cout, 4 * cin, 2, 2))
    for kh in range(3):
        bi, pr = (0, 1) if kh == 0 else (1, kh - 1)
        for kw in range(3):
            bj, pc = (0, 1) if kw == 0 else (1, kw - 1)
            off = (pr * 2 + pc) * cin
            k2[:, off:off + cin, bi, bj] = k[:, :, kh, kw]
    return k2
