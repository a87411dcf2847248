"""The port's ``tools/perf_quant_e2e.run()`` on the tiny config against the
same sequence of the JAX package's calls (``tools/perf_quant_e2e.py:227-276``:
the bf16 fast path with the Pallas layer1, calibration on the first 16
images, ``prepare_quant_params`` at each scope and
``prepare_serving_qparams`` without and with ``int8_head``, each served by
``make_quant_infer``), JAX's Pallas kernels in interpret mode (the
backbone's layer1 kernel handed over so, as tests/test_torch_fast_infer_options.py
does), on the same weights and float images.

The weights are tests/test_torch_sharding.py's activated recipe at gain
1.0: at 1.4 random tiny nets are chaotic in bf16 and the two frameworks'
roundings part the decodes by pixels (the C26 precedent,
tests/test_torch_accuracy_gate.py).  A shift is |int8 - bf16| on one
coordinate; each end may part from JAX's by the int8 slice's own 0.05 px
(tests/test_torch_quant_infer.py), so a shift's maximum is held within 0.1
px of JAX's (measured up to 0.071, on one of 84 coordinates) and its mean,
over all of them, within 0.01 px (measured up to 0.0017).
"""

import jax.numpy as jnp
import numpy as np
import torch

from hrnet_hand_pose_estimation_tpu.core import quant_infer as JQ
from hrnet_hand_pose_estimation_tpu.core.fast_infer import make_fast_infer as jax_fast_infer
from hrnet_hand_pose_estimation_tpu_torch.config import config_from_dict
from hrnet_hand_pose_estimation_tpu_torch.tools import perf_quant_e2e as E
from hrnet_hand_pose_estimation_tpu_torch.utils.weights import from_jax_variables
from test_torch_fast_infer_options import interpret_kernels  # noqa: F401 (fixture)
from test_torch_sharding import variables  # noqa: F401 (fixture)

torch.set_num_threads(1)
MAX_TOL, MEAN_TOL = 0.1, 0.01


def jax_shifts(jcfg, v, images):
    """{tag: (sites, shift max, shift mean)} of the JAX tool's sequence."""
    ref = np.asarray(jax_fast_infer(jcfg, pallas_layer1=True, interpret=True)(v, images))
    amax = JQ.calibrate(jcfg, v, [images[:E.CALIB]])
    qfn = JQ.make_quant_infer(jcfg, interpret=True)
    configs = {scope: JQ.prepare_quant_params(jcfg, v, amax, scope=scope) for scope in E.SCOPES}
    configs["exchange+l1chain+stem2"] = JQ.prepare_serving_qparams(jcfg, v, amax)
    configs["exchange+l1chain+stem2+int8head"] = JQ.prepare_serving_qparams(jcfg, v, amax,
                                                                            int8_head=True)
    out = {}
    for tag, qparams in configs.items():
        shift = np.abs(np.asarray(qfn(v, qparams, images)) - ref)
        out[tag] = (len(qparams), float(shift.max()), float(shift.mean()))
    return out, len(amax)


def test_run_matches_jax_sequence(tiny_cfg, variables, interpret_kernels):
    images = np.random.default_rng(0).normal(size=(4, 64, 64, 3)).astype(np.float32)
    want, n_sites = jax_shifts(tiny_cfg, variables, jnp.asarray(images))
    cfg = config_from_dict(tiny_cfg.to_dict())
    got = E.run(cfg, from_jax_variables(variables), iters=1, device="cpu", images=images)
    assert got["batch"] == 4 and got["bf16"] > 0 and got["calibrated"] == n_sites
    assert [k for k, v in got.items() if isinstance(v, dict)] == list(want)
    assert any(w[1] > 0.05 for w in want.values())          # the int8 paths move the decode
    for tag, (sites, smax, smean) in want.items():
        row = got[tag]
        print(f"{tag}: port max {row['shift_max']:.4f} / mean {row['shift_mean']:.4f} px, "
              f"JAX {smax:.4f} / {smean:.4f} px")
        assert row["sites"] == sites and row["fps"] > 0
        assert row["ratio"] == row["fps"] / got["bf16"]
        assert abs(row["shift_max"] - smax) <= MAX_TOL, tag
        assert abs(row["shift_mean"] - smean) <= MEAN_TOL, tag
    assert len(list(E.lines(got))) == 2 + 2 * len(want)
