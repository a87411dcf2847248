"""2D training entry point.

Port of the JAX package's ``tools/train.py`` (reference
tools/train.py:95-424): build config, model and loaders, train with
per-epoch validation, checkpoints and best-model snapshots.

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.train --cfg <exp.yaml>
    python -m hrnet_hand_pose_estimation_tpu_torch.tools.train --cfg ... --device cpu \\
        DATASET.DATASET "['Synthetic_kpt']"
"""

from __future__ import annotations

from ._common import base_parser, load_cfg


def main() -> None:
    args = base_parser(__doc__).parse_args()

    import torch

    from ..core.trainer import Trainer
    from ..data.build import make_dataloader
    from ..models import build_model
    from ..utils.summary import model_summary

    cfg = load_cfg(args)
    model = build_model(cfg)

    train_loaders = make_dataloader(cfg, is_train=True)
    val_loaders = {} if cfg.WITHOUT_EVAL else make_dataloader(cfg, is_train=False)

    trainer = Trainer(cfg, model, train_loaders, val_loaders, device=args.device)
    device = torch.device(args.device)
    trainer.logger.info("device: %s", torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu")
    trainer.logger.info("%s", model_summary(model, cfg))
    trainer.fit()


if __name__ == "__main__":
    main()
