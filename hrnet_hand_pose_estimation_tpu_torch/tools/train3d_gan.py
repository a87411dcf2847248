"""WGAN-regularised 3D training entry point.

Port of the JAX package's ``tools/train3d_gan.py`` (reference
tools/train3D_GAN.py:96-440): ``tools/train3d`` with the critic loop of
``core/trainer3d_gan.TrainerGAN3D``.

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.train3d_gan \\
        --cfg experiments/LearnableTriangulation/VolTriangulation_MHP_GAN_v1.yaml

Across N GPUs as ``tools/train3d`` (``torchrun --nproc_per_node=N -m
hrnet_hand_pose_estimation_tpu_torch.tools.train3d_gan --cfg <exp.yaml>``;
``--device cpu --dist_backend gloo`` for ranks on the CPU).
"""

from __future__ import annotations


def main() -> None:
    from .train3d import cli

    cli(__doc__, gan=True)


if __name__ == "__main__":
    main()
