"""The dtype the port sums, normalises and takes its losses in.

The compute dtype of a model (bf16 on the card, fp32 in the CPU tests) is
widened to fp32 for BatchNorm, the plain versions of the kernels and the
losses, as the JAX package does; a float64 model keeps float64 there, so
a CPU test can hold the port's gradients to the JAX model's float64
gradient without fp32 rounding flipping a ReLU mask on either side.
"""

from __future__ import annotations

import torch


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in fp32, or unchanged if it is float64."""
    return t if t.dtype == torch.float64 else t.float()
