"""PyTorch/CUDA port of :mod:`image_segmentation_tpu` for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here names
its JAX counterpart by file, and the tests hold the two to each other on
the CPU.  This package imports ``torch`` and never ``jax``.

What is ported: every model of the JAX registry (the U-Nets, the CLIP
models with the frozen ViT tower and, for ClipRes, the frozen ResNet-34,
the prompt model, the autoencoder, ``prompt_fusion``), their weights
bridge to and from the JAX artifacts, ``load_model``/``predict``, and
``engine.train.Trainer`` with torch-Adam, flax-semantics BatchNorm, the
augmentors and the segmentation, prompt, class and reconstruction tasks
(``config``, the synthetic data and batch pipeline, every loss and eval
metric), the run artifacts and checkpoints (``Trainer.restore``, in the
JAX ``.npz`` layout both ways), the robustness battery and
``engine.evaluate.Evaluator``, plotting, and the train / evaluate / plot
CLIs.  The TPU kernels are hand-written CUDA C++ for ``sm_90a`` in
``csrc/``: the 3x3 ConvBN conv (forward with batch statistics, input
gradient, weight gradient), the BN-ReLU backward reduction, the BN-affine
max-pool and the 2x2 ConvTranspose with their backwards, the 1x1-conv
backward, the shear shifts, the fused colour stage and the cross
attention.  Each has a plain PyTorch version beside its wrapper in
:mod:`.ops`, which CPU tensors take.

Public tensors are NHWC, as in the JAX package.  Parameters are fp32;
the compute dtype is a model attribute (bf16 on the card, fp32 in the CPU
tests).

Subpackages
-----------
- ``config``  TrainConfig and the presets
- ``data``    synthetic datasets, the uint8 batch pipeline, the
              robustness perturbations
- ``models``  blocks, the kernel-backed blocks, UNet/LargeUNet, the CLIP
              models, ResNet-34, the autoencoder, prompt_fusion, registry
- ``ops``     kernel wrappers + plain versions + autograd Functions, the
              nvcc build, normalize, losses and metrics
- ``engine``  Trainer; export_model / load_model / predict; Evaluator
- ``utils``   JAX params <-> port state dict, flat-npz artifacts, run
              artifacts (io), checkpoints, plotting
- ``cli``     ``python -m image_segmentation_tpu_torch.cli.{train,evaluate,
              plot_results}``
"""

__version__ = "0.1.0"
