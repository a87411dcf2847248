"""Multi-view 3D evaluation.

Port of the JAX package's ``tools/evaluate_3d.py`` (reference
tools/evaluate_3D.py:143-420): run a triangulation net (or, with --dlt, the
plain 2D backbone + a per-joint DLT) over the multi-view test set,
accumulate 2D px / 3D mm EPE + PCK + AUC, write the eval3D_results
artifacts.

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.evaluate_3d --cfg <exp.yaml> \\
        [--model_path <ckpt>] [--views 0 1 2 3] [--dlt] [--device cpu] [KEY VALUE ...]
"""

from __future__ import annotations

import json
from typing import Dict, Mapping, Optional, Sequence

from ._common import base_parser, load_cfg


def build_evaluator(cfg, dlt: bool = False, state: Optional[Mapping] = None,
                    model_path: str = "", device="cuda"):
    """(Evaluator3D, its loader) for a built config: the triangulation net
    of ``MODEL.TRIANGULATION_MODEL_NAME`` (or, with ``dlt``, the config's 2D
    model) on the first test dataset.  Weights: ``state`` if given, else
    ``model_path``, else seeded random weights (smoke mode)."""
    import torch

    from ..core.evaluator3d import Evaluator3D
    from ..data.build import make_test_dataloader
    from ..models import build_model
    from ..models.triangulation import build_triangulation_net
    from ..parallel.checkpoint import join_state_dict, load_pretrained
    from ..utils.weights import init_variables
    from ._common import load_weights, tool_mesh

    # data-parallel over the devices of TPU.MESH_AXES / MESH_SHAPE, as the
    # JAX tool's (a mesh of one device is none)
    mesh = tool_mesh(cfg, device)
    _, loader = next(iter(make_test_dataloader(cfg).items()))
    if dlt:
        model = build_model(cfg)
        if state is None:
            state = load_weights(cfg, model, model_path, device=device)
        return Evaluator3D(cfg, model, state, mode="dlt", mesh=mesh, device=device), loader
    model = build_triangulation_net(cfg, dtype=torch.bfloat16 if torch.device(
        device).type == "cuda" else torch.float32)
    if state is None:
        state = (join_state_dict(load_pretrained(model_path)) if model_path else
                 init_variables(cfg, 0, device=device,
                                net=str(cfg.MODEL.TRIANGULATION_MODEL_NAME)))
    return Evaluator3D(cfg, model, state, mode="model", mesh=mesh, device=device), loader


def evaluate(cfg, dlt: bool = False, state: Optional[Mapping] = None, model_path: str = "",
             views: Optional[Sequence[int]] = None, out: str = "tools",
             device="cuda") -> Dict[str, float]:
    """Evaluate a built config and write the artifacts under ``out``."""
    evaluator, loader = build_evaluator(cfg, dlt, state, model_path, device)
    return evaluator.run(loader, views=views, output_dir=out)


def main() -> None:
    p = base_parser(__doc__)
    p.add_argument("--views", type=int, nargs="*", default=None,
                   help="view subset (reference --views, evaluate_3D.py:228)")
    p.add_argument("--dlt", action="store_true",
                   help="plain 2D backbone + per-joint DLT path (:293-303)")
    p.add_argument("--out", default="tools", help="artifact directory root")
    args = p.parse_args()
    results = evaluate(load_cfg(args), dlt=args.dlt, model_path=args.model_path,
                       views=args.views, out=args.out, device=args.device)
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
