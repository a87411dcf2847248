"""The reference answers of the serving cells: coordinates (B, K, 2) [u, v]
in heatmap pixels, computed in float32 with TF32 off, in blocks of rows.

- ``Int8Reference``: the int8 serving configuration repeated from the
  state: BN folded into every conv, calibration on the given normalized
  images (the largest |input| of every conv), then every trunk conv but
  the first fake-quantized, weights per output channel and activations per
  tensor at ``qmax`` (127: W8A8; 7: the int4 control).
- ``FloatReference``: the folded float32 network; ``fp8=True`` is the
  control, every conv's input and weight rounded to float8 e4m3 at a
  per-tensor scale.
"""

from __future__ import annotations

from typing import Mapping

import torch

from .model import Walk, fold, make_quant, nchw, softmax_decode, trunk_sites
from .weights import tf32_off

BLOCK = 32          # rows a block: the reference's memory stays small beside the cell's


def fp8_cast(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """x rounded to a float8 type (e4m3 unless told) at the scale that maps
    its largest |value| to the type's largest, back in float32."""
    scale = torch.clamp(x.abs().amax().float(), min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).float() * scale


class FloatReference:
    def __init__(self, state: Mapping[str, torch.Tensor], model_cfg: Mapping,
                 fp8: bool = False):
        self.cfg = model_cfg
        self.folded = fold(state, model_cfg)
        self.temp = state["trainable_temp"].float()
        self.cast = fp8_cast if fp8 else None

    def walk(self) -> Walk:
        return Walk(self.cfg, "eval", folded=self.folded, cast=self.cast)

    @torch.no_grad()
    def __call__(self, images_nhwc: torch.Tensor) -> torch.Tensor:
        """Normalized NHWC images (any float dtype) -> (B, K, 2) float32."""
        outs = []
        with tf32_off():
            for i in range(0, images_nhwc.shape[0], BLOCK):
                x = nchw(images_nhwc[i:i + BLOCK])
                outs.append(softmax_decode(self.walk().logits(x), self.temp)[1])
        return torch.cat(outs)


class Int8Reference(FloatReference):
    def __init__(self, state: Mapping[str, torch.Tensor], model_cfg: Mapping,
                 calibration: torch.Tensor, qmax: int = 127):
        super().__init__(state, model_cfg)
        amax = {}
        with torch.no_grad(), tf32_off():
            Walk(model_cfg, "eval", folded=self.folded, amax=amax).logits(nchw(calibration))
        self.quant = make_quant(self.folded, {k: float(v) for k, v in amax.items()},
                                trunk_sites(model_cfg), qmax)

    def walk(self) -> Walk:
        return Walk(self.cfg, "eval", folded=self.folded, quant=self.quant)


def normalize(images_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NHWC images -> float32 (x / 255 - mean) / std."""
    m = torch.tensor(mean, dtype=torch.float32, device=images_u8.device)
    s = torch.tensor(std, dtype=torch.float32, device=images_u8.device)
    return (images_u8.float() / 255.0 - m) / s
