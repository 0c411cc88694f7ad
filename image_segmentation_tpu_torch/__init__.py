"""PyTorch/CUDA port of :mod:`image_segmentation_tpu` for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here names
its JAX counterpart by file, and the tests hold the two to each other on
the CPU.  This package imports ``torch`` and never ``jax``.

What is ported so far is the serving path of the ``large_unet`` preset:
the eval-mode LargeUNet forward, its weights bridge to and from the JAX
artifacts (``config.json`` + ``model.npz``), and ``load_model``/``predict``.
The three TPU kernels on that path (the fused 3x3 ConvBN conv, the
BN-affine max-pool and the 2x2 ConvTranspose) are hand-written CUDA C++
for ``sm_90a`` in ``csrc/``; each has a plain PyTorch version beside its
wrapper in :mod:`.ops.fused_conv`, which CPU tensors take.

Public tensors are NHWC, as in the JAX package.  Parameters are fp32;
the compute dtype is a model attribute (bf16 on the card, fp32 in the CPU
tests).

Subpackages
-----------
- ``models``  blocks, the kernel-backed level-0/1 blocks, UNet/LargeUNet,
              registry
- ``ops``     kernel wrappers + plain versions, the nvcc build, normalize
- ``engine``  export_model / load_model / predict
- ``utils``   JAX params <-> port state dict, flat-npz artifacts
"""

__version__ = "0.1.0"
