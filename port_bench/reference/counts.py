"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes that each step and each kernel of the measured paths needs, computed
from the configuration's shapes alone.

Peaks: NVIDIA's data sheet for the H100 SXM, dense rates without sparsity,
at the full 700 W: 989 TFLOP/s in bf16, 67 TFLOP/s in float32 outside the
tensor cores, 1,979 TOP/s in int8, 3.35 TB/s of HBM.

A conv's operations are 2 per multiply-add; a bilinear align-corners resize
counts as the two separable matrix products that compute it.  A kernel's
bytes count each input tensor once and each output once (activations in
the dtype the path hands over: bfloat16 between kernels), whatever the
kernel reads again.  A launch's least time is the larger of its operations
over the peak of their type and its bytes over the memory rate; the least
time of a set of launches is the sum over them.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple

from .model import conv_specs, stages, trunk_sites

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12
BF16 = 2
F32 = 4


class Work(NamedTuple):
    """Operations by type and bytes moved."""

    bf16: float = 0.0
    int8: float = 0.0
    f32: float = 0.0
    nbytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(*(a + b for a, b in zip(self, other)))

    def scaled(self, n: float) -> "Work":
        return Work(*(a * n for a in self))

    @property
    def ops_s(self) -> float:
        return self.bf16 / PEAK_BF16 + self.int8 / PEAK_INT8 + self.f32 / PEAK_F32

    @property
    def bound_s(self) -> float:
        """Least time of this work as one launch."""
        return max(self.ops_s, self.nbytes / PEAK_BYTES)


def conv_flops(model_cfg: Mapping) -> Dict[str, float]:
    """conv name -> operations of one image's forward through it."""
    out = {}
    for s in conv_specs(model_cfg):
        ho = s.hw_in // s.stride
        out[s.conv] = 2.0 * ho * ho * s.cout * s.cin * s.k * s.k
    return out


def upsample_flops(model_cfg: Mapping) -> float:
    """Operations of one image's head resize of branches 1-3 to branch 0's
    side, as separable products (rows, then columns)."""
    hw = int(model_cfg["IMAGE_SIZE"][0]) // 4
    total = 0.0
    for i, c in enumerate(stages(model_cfg)[2].out[1:], start=1):
        s = hw >> i
        total += 2.0 * hw * s * s * c + 2.0 * hw * hw * s * c
    return total


def forward_flops(model_cfg: Mapping) -> float:
    """Operations of one image's forward: every conv and the head's resize."""
    return sum(conv_flops(model_cfg).values()) + upsample_flops(model_cfg)


def forward_work(model_cfg: Mapping, int8_trunk: bool) -> Work:
    """One image's forward by the type its configuration states: with
    ``int8_trunk`` every trunk conv but the first in int8, the rest bf16."""
    sites = set(trunk_sites(model_cfg)) if int8_trunk else set()
    work = Work(bf16=upsample_flops(model_cfg))
    for name, f in conv_flops(model_cfg).items():
        work = work + (Work(int8=f) if name in sites else Work(bf16=f))
    return work


def _conv_launch(s, batch: int, int8: bool) -> Work:
    ho = s.hw_in // s.stride
    ops = 2.0 * batch * ho * ho * s.cout * s.cin * s.k * s.k
    nbytes = (batch * s.hw_in * s.hw_in * s.cin * BF16 + batch * ho * ho * s.cout * BF16
              + s.cout * s.cin * s.k * s.k * (1 if int8 else BF16) + 2 * s.cout * F32)
    return Work(int8=ops, nbytes=nbytes) if int8 else Work(bf16=ops, nbytes=nbytes)


def _block_launch(specs: List, batch: int, int8: bool) -> Work:
    """One launch of a fused residual block: every conv's operations, the
    block's input once at its own side, its output once at the last conv's
    output side, and its weights."""
    first, last = specs[0], specs[-1]
    ops = sum(2.0 * batch * (s.hw_in // s.stride) ** 2 * s.cout * s.cin * s.k * s.k
              for s in specs)
    wbytes = sum(s.cout * s.cin * s.k * s.k * (1 if int8 else BF16) + 2 * s.cout * F32
                 for s in specs)
    side_in, side_out = first.hw_in, last.hw_in // last.stride
    nbytes = batch * (side_in ** 2 * first.cin + side_out ** 2 * last.cout) * BF16 + wbytes
    return Work(int8=ops, nbytes=nbytes) if int8 else Work(bf16=ops, nbytes=nbytes)


def _by_prefix(model_cfg: Mapping, prefix: str) -> List:
    return [s for s in conv_specs(model_cfg) if s.conv.startswith(prefix)]


def kernel_bounds(model_cfg: Mapping, batch: int) -> Dict[str, float]:
    """Least seconds, summed over the launches of one batch, of each kernel
    family that a serving path routes work to:

    - ``conv_int8``: every W8A8 site but layer1's (stem2 and stages 2-4),
      one launch each;
    - ``int8_chain``: layer1's four W8A8 bottlenecks, one launch each;
    - ``basic_chain``: every BasicBlock of stages 2-4 in bf16, one launch each;
    - ``stem_layer1``: both stem convs in one launch, then layer1's four
      bf16 bottlenecks, one launch each;
    - ``head_decode``: the head with its 1x1 conv commuted ahead of the
      resize (the least work: branch i's product at its own side), the
      separable resize of the 480-channel sums (two taps an axis), the final
      1x1 conv, softmax and decode; one launch.
    """
    specs = conv_specs(model_cfg)
    by_name = {s.conv: s for s in specs}
    out: Dict[str, float] = {}
    sites = [n for n in trunk_sites(model_cfg) if not n.startswith("layer1.")]
    out["conv_int8"] = sum(_conv_launch(by_name[n], batch, True).bound_s for n in sites)
    blocks = [_by_prefix(model_cfg, f"layer1.{b}.") for b in range(4)]
    out["int8_chain"] = sum(_block_launch(b, batch, True).bound_s for b in blocks)
    basic = {}
    for s in specs:
        if ".branches." in s.conv:
            basic.setdefault(s.conv.rsplit(".", 1)[0], []).append(s)
    out["basic_chain"] = sum(_block_launch(b, batch, False).bound_s for b in basic.values())
    stem = _block_launch([by_name["conv1"], by_name["conv2"]], batch, False)
    out["stem_layer1"] = stem.bound_s + sum(_block_launch(b, batch, False).bound_s
                                            for b in blocks)
    out["head_decode"] = head_work(model_cfg, batch).bound_s
    return out


def head_work(model_cfg: Mapping, batch: int) -> Work:
    hw = int(model_cfg["IMAGE_SIZE"][0]) // 4
    chans = stages(model_cfg)[2].out
    n = sum(chans)
    k = int(model_cfg["NUM_JOINTS"])
    ops = 0.0
    nbytes = 0.0
    for i, c in enumerate(chans):
        s = hw >> i
        ops += 2.0 * s * s * c * n
        nbytes += s * s * c * BF16
        if i:
            ops += 2.0 * 2 * (hw * s + hw * hw) * n
    ops += 2.0 * hw * hw * n * k
    return Work(bf16=batch * ops,
                nbytes=batch * nbytes + (n * n + n * k) * BF16 + (n + k) * F32
                + batch * k * 2 * F32)


def train_step_flops(model_cfg: Mapping, batch: int) -> float:
    """Operations of one train step: forward plus backward, three times the
    forward."""
    return 3.0 * forward_flops(model_cfg) * batch
