"""PyTorch/CUDA port of :mod:`image_segmentation_tpu` for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here names
its JAX counterpart by file, and the tests hold the two to each other on
the CPU.  This package imports ``torch`` and never ``jax``.

What is ported so far is the ``large_unet`` preset's serving path (the
eval-mode LargeUNet forward, its weights bridge to and from the JAX
artifacts, ``load_model``/``predict``) and its training step without
augmentation (``config``, the synthetic data and batch pipeline, the CE
loss and eval metrics, ``engine.train.Trainer`` with torch-Adam and
flax-semantics BatchNorm).  The TPU kernels on those paths are hand-written
CUDA C++ for ``sm_90a`` in ``csrc/``: the 3x3 ConvBN conv (forward with
batch statistics, input gradient, weight gradient), the BN-ReLU backward
reduction, the BN-affine max-pool and the 2x2 ConvTranspose, each with its
backward.  Each has a plain PyTorch version beside its wrapper in
:mod:`.ops.fused_conv`, which CPU tensors take.

Public tensors are NHWC, as in the JAX package.  Parameters are fp32;
the compute dtype is a model attribute (bf16 on the card, fp32 in the CPU
tests).

Subpackages
-----------
- ``config``  TrainConfig and the presets
- ``data``    synthetic datasets, the uint8 batch pipeline
- ``models``  blocks, the kernel-backed level-0/1 blocks, UNet/LargeUNet,
              registry
- ``ops``     kernel wrappers + plain versions + autograd Functions, the
              nvcc build, normalize, losses and metrics
- ``engine``  Trainer; export_model / load_model / predict
- ``utils``   JAX params <-> port state dict, flat-npz artifacts
"""

__version__ = "0.1.0"
