"""One ``make_train_step_3d`` step of the volumetric net against the JAX
package's (float32, tiny_cfg backbone, V2V at 32^3, one sample of 2 views,
the same cuboid angle), held as ``test_torch_trainer3d.check_step`` holds
the alg step.  A file of its own: XLA takes ~3 min to compile the JAX
step with V2V's backward.

V2V's train-mode gradient at 32^3 is ill-conditioned: its innermost BNs
normalise B values a channel.  At B = 2 the port's own float32 gradient of
V2V's encoder is ~100 % from its float64 one; at B = 1 (where that BN
passes no gradient at all) 0.8 %.  Hence B = 1 and 3e-2 per tensor.
"""

import torch

from tests.test_torch_trainer3d import check_step, run_step_pair
from tests.torch3d_parity import jax_eigh64_grad  # noqa: F401

torch.set_num_threads(1)


def test_train_step_3d_vol_matches_jax(tiny_cfg, monkeypatch, jax_eigh64_grad):
    check_step(*run_step_pair(tiny_cfg, monkeypatch, "vol", seed=11, b=1), rel=3e-2)
