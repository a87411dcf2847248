"""2D training entry point.

Port of the JAX package's ``tools/train.py`` (reference
tools/train.py:95-424): build config, model and loaders, train with
per-epoch validation, checkpoints and best-model snapshots.

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.train --cfg <exp.yaml>
    python -m hrnet_hand_pose_estimation_tpu_torch.tools.train --cfg ... --device cpu \\
        DATASET.DATASET "['Synthetic_kpt']"

Data-parallel over N GPUs, one process each (``parallel/distributed.py``;
each rank reads its slice of every epoch and steps on the global batch of
N x TRAIN.IMAGES_PER_GPU, rank 0 writes the run's files):

    torchrun --nproc_per_node=N -m hrnet_hand_pose_estimation_tpu_torch.tools.train \\
        --cfg <exp.yaml>

Under torchrun (its ``WORLD_SIZE`` in the environment) the tool starts the
process group with ``--dist_backend`` (nccl, the default, for ranks on
cards; gloo for ranks on the CPU, ``--device cpu --dist_backend gloo``).
"""

from __future__ import annotations

from ._common import add_dist_flags, base_parser, load_cfg, start_ranks


def main() -> None:
    args = add_dist_flags(base_parser(__doc__)).parse_args()

    import torch

    from ..core.trainer import Trainer
    from ..data.build import make_dataloader
    from ..models import build_model
    from ..parallel import distributed
    from ..parallel.train_step import refuse_unsupported
    from ..utils.summary import model_summary

    device = start_ranks(args)
    try:
        cfg = load_cfg(args)
        # a model the JAX package's tools cannot train raises before its data is read
        refuse_unsupported(cfg, "train state")
        refuse_unsupported(cfg, "train step")
        model = build_model(cfg)

        train_loaders = make_dataloader(cfg, is_train=True)
        val_loaders = {} if cfg.WITHOUT_EVAL else make_dataloader(cfg, is_train=False)

        trainer = Trainer(cfg, model, train_loaders, val_loaders, device=device)
        trainer.logger.info("device: %s; rank %d of %d", torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu", distributed.rank(),
                            distributed.world_size())
        trainer.logger.info("%s", model_summary(model, cfg))
        trainer.fit()
    finally:
        distributed.destroy_process_group()


if __name__ == "__main__":
    main()
