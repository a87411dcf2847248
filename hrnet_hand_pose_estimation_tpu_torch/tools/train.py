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

A grid of data x model ranks splits the wide weights over the model axis
(``parallel/tensor_parallel.py``), from the config, data-major over the
world: four CPU ranks as two data rows of two model ranks each,

    torchrun --nproc_per_node=4 -m hrnet_hand_pose_estimation_tpu_torch.tools.train \\
        --cfg <exp.yaml> --device cpu --dist_backend gloo \\
        TPU.MESH_AXES "['data', 'model']" TPU.MESH_SHAPE "[2, 2]"

(ranks sharing one card run gloo too; NCCL takes one card a rank).
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
        # the Trainer lays the ranks out on TPU.MESH_AXES / MESH_SHAPE
        trainer.logger.info("device: %s; rank %d of %d (data %d of %d, model %d of %d)",
                            torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu", distributed.rank(), distributed.world_size(),
                            distributed.data_rank(), distributed.data_size(),
                            distributed.model_rank(), distributed.model_size())
        trainer.logger.info("%s", model_summary(model, cfg))
        trainer.fit()
    finally:
        distributed.destroy_process_group()


if __name__ == "__main__":
    main()
