"""Full-test-set 2D evaluation.

Port of the JAX package's ``tools/evaluate_2d.py`` (reference
tools/evaluate_2D.py:61-297): batch forward over the eval dataset, decode,
rescale to the original image, accumulate EPE/PCK, write
``eval2D_results_<EXP>/{mse2d_each_joint,PCK2d}.txt``.

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.evaluate_2d --cfg <exp.yaml> \\
        [--model_path <ckpt>] [--serving std|int8] [--calib <record.json>] [--device cpu]
"""

from __future__ import annotations

import json
from typing import Dict, Mapping, Optional

from ._common import base_parser, load_cfg


def evaluate(cfg, state: Optional[Mapping] = None, model_path: str = "", serving: str = "std",
             calib: str = "", out: str = "tools", device="cuda") -> Dict[str, float]:
    """Evaluate a built config on its first test dataset and write the
    artifacts under ``out``.  Weights: ``state`` if given, else
    ``model_path``, else seeded random weights (smoke mode)."""
    from ..core.evaluator import Evaluator2D
    from ..data.build import make_test_dataloader
    from ..models import build_model
    from ._common import load_weights, tool_mesh

    model = build_model(cfg)
    loaders = make_test_dataloader(cfg)
    name, loader = next(iter(loaders.items()))
    if state is None:
        state = load_weights(cfg, model, model_path, device=device)
    # data-parallel over the devices of TPU.MESH_AXES / MESH_SHAPE, as the
    # JAX tool's (a mesh of one device is none)
    evaluator = Evaluator2D(cfg, model, state, mesh=tool_mesh(cfg, device), serving=serving,
                            calib_path=calib, device=device)
    return evaluator.run(loader, dataset_name=name, output_dir=out)


def main() -> None:
    p = base_parser(__doc__)
    p.add_argument("--out", default="tools", help="artifact directory root")
    p.add_argument("--serving", default="std", choices=("std", "int8"),
                   help="evaluate the standard forward or the calibrated "
                        "int8 W8A8 serving path (deployment-accuracy check)")
    p.add_argument("--calib", default="",
                   help="saved calibration record (tools/calibrate.py) for "
                        "--serving int8; default calibrates on the first "
                        "eval batch")
    args = p.parse_args()
    results = evaluate(load_cfg(args), model_path=args.model_path, serving=args.serving,
                       calib=args.calib, out=args.out, device=args.device)
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
