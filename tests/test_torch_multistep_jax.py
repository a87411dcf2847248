"""The port's make_train_multistep against the JAX package's, on the same
state and batches (tests/test_engine_fixes.py::
test_train_multistep_matches_sequential_steps on the port; its setup is
tests/test_torch_multistep.py's)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import hrnet_hand_pose_estimation_tpu.parallel.train_step as jax_ts
from hrnet_hand_pose_estimation_tpu_torch.parallel import train_step as TS
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_train_state
from test_torch_multistep import K, port_state, setup, stacked  # noqa: F401 (fixture)

torch.set_num_threads(1)


def test_multistep_matches_jax_multistep(setup):
    """The port's K=3 call against JAX's make_train_multistep (jitted, a
    lax.scan) from the same state, at JAX's own tolerances for its scanned
    against its sequential steps: losses rtol 2e-4, parameters atol 1e-3."""
    jcfg, pcfg, jm, tx, jstate, batches = setup
    multi = jax_ts.make_train_multistep(jcfg, jm, tx)
    jbatches = {k: jnp.stack([jnp.asarray(b[k]) for b in batches]) for k in batches[0]}
    j_after, j_losses = multi(jax.tree.map(jnp.copy, jstate), jbatches)
    model, state, ptx = port_state(pcfg, jstate)
    state, p_losses = TS.make_train_multistep(pcfg, model, ptx)(state, stacked(batches))
    assert set(j_losses) == set(p_losses)
    for key, v in j_losses.items():
        np.testing.assert_allclose(p_losses[key].numpy(), np.asarray(v), rtol=2e-4,
                                   atol=1e-7, err_msg=key)
    ref = from_jax_train_state(jax.device_get(j_after), model)
    got = state.state_dict()
    assert int(got["step"]) == int(j_after.step) == K
    gap = max(float((got["params"][k] - v).abs().max()) for k, v in ref["params"].items())
    print(f"K={K}: largest parameter gap to JAX's scan {gap:.3g}")
    for name, val in ref["params"].items():
        np.testing.assert_allclose(got["params"][name].numpy(), val.numpy(), atol=1e-3,
                                   err_msg=name)
