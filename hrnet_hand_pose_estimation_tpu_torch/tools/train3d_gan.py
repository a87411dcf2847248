"""WGAN-regularised 3D training entry point.

Port of the JAX package's ``tools/train3d_gan.py`` (reference
tools/train3D_GAN.py:96-440): ``tools/train3d`` with the critic loop of
``core/trainer3d_gan.TrainerGAN3D``.

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.train3d_gan \\
        --cfg experiments/LearnableTriangulation/VolTriangulation_MHP_GAN_v1.yaml
"""

from __future__ import annotations

from ._common import base_parser, load_cfg


def main() -> None:
    from .train3d import train

    args = base_parser(__doc__).parse_args()
    train(load_cfg(args), args.device, gan=True)


if __name__ == "__main__":
    main()
