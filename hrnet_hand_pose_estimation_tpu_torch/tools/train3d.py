"""3D multi-view training entry point.

Port of the JAX package's ``tools/train3d.py`` (reference
tools/train3D.py:95-429): build the triangulation net named by
MODEL.TRIANGULATION_MODEL_NAME ('alg' | 'ransac' | 'vol' | 'vol_CPM') and train it on
the multi-view loaders with per-module learning rates and frozen backbone
layers (``core/trainer3d.Trainer3D``).

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.train3d \\
        --cfg experiments/LearnableTriangulation/VolTriangulation_MHP_v2.yaml
    python -m hrnet_hand_pose_estimation_tpu_torch.tools.train3d \\
        --cfg experiments/synthetic_vol_smoke.yaml --device cpu MODEL.VOLUME_SIZE 32

Data-parallel over N GPUs, one process each (``parallel/distributed.py``;
each rank reads its slice of every epoch and steps on the global batch,
rank 0 writes the run's files):

    torchrun --nproc_per_node=N -m hrnet_hand_pose_estimation_tpu_torch.tools.train3d \\
        --cfg <exp.yaml>

Under torchrun (its ``WORLD_SIZE`` in the environment) the tool starts the
process group with ``--dist_backend`` (nccl, the default, for ranks on
cards; gloo for ranks on the CPU, ``--device cpu --dist_backend gloo``).
"""

from __future__ import annotations

from ._common import add_dist_flags, base_parser, load_cfg, start_ranks


def train(cfg, device="cuda", gan: bool = False, output_dir=None):
    """Build the net and the loaders of ``cfg`` and fit; returns the trainer.
    The volumetric net computes process_features and V2V in bfloat16 on the
    card, in float32 on the CPU.  ``gan``: the WGAN trainer."""
    import torch

    from ..core.trainer3d import Trainer3D
    from ..core.trainer3d_gan import TrainerGAN3D
    from ..data.build import make_dataloader
    from ..models.triangulation import build_triangulation_net
    from ..parallel import distributed

    device = torch.device(device)
    model = build_triangulation_net(
        cfg, dtype=torch.bfloat16 if device.type == "cuda" else torch.float32)
    train_loaders = make_dataloader(cfg, is_train=True)
    val_loaders = {} if cfg.WITHOUT_EVAL else make_dataloader(cfg, is_train=False)
    trainer = (TrainerGAN3D if gan else Trainer3D)(cfg, model, train_loaders, val_loaders,
                                                    output_dir=output_dir, device=device)
    trainer.logger.info("device: %s; rank %d of %d", torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu", distributed.rank(),
                        distributed.world_size())
    trainer.fit()
    return trainer


def cli(doc: str, gan: bool = False) -> None:
    """The command line of this tool (``gan``: of ``tools.train3d_gan``)."""
    from ..parallel import distributed

    args = add_dist_flags(base_parser(doc)).parse_args()
    device = start_ranks(args)
    try:
        train(load_cfg(args), device, gan=gan)
    finally:
        distributed.destroy_process_group()


def main() -> None:
    cli(__doc__)


if __name__ == "__main__":
    main()
