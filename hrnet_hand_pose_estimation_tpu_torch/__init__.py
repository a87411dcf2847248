"""PyTorch/CUDA port of ``hrnet_hand_pose_estimation_tpu``.

The port imports torch and never jax, flax or the JAX package; it keeps its
own copies of what it needs.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.

Layout
------
- ``config``       frozen config tree; loads ``experiments/*.yaml`` like the JAX package
- ``models``       PyTorch HRNet with the reference module names, behind a registry
- ``ops``          upsampling, decoding, image ops, and the hand-written CUDA kernels (``ops/kernels``)
- ``csrc``         CUDA C++ sources of the kernels, built with nvcc at first use
- ``core``         the serving paths (bf16 ``make_fast_infer``, int8 W8A8 ``make_quant_infer``),
                   the 2D trainer, the 2D evaluator and its metrics
- ``data``         synthetic datasets, the numpy transform chain, the dataset factory, the loader
- ``parallel``     the train step, optimizers, checkpoints
- ``tools``        the CLIs: ``python -m hrnet_hand_pose_estimation_tpu_torch.tools.<tool>``
- ``utils``        weights from the JAX variable tree, seeded random weights, summaries
"""

__version__ = "0.1.0"
