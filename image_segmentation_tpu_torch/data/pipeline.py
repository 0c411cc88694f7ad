"""Host -> device batch pipeline; counterpart of
``image_segmentation_tpu/data/pipeline.py`` (epoch_permutation :34,
BatchPipeline :50) for one process.

Each epoch visits a permutation of VIRTUAL indices: every item appears
``augmentations_per_datapoint + 1`` times, shuffled by a generator keyed on
(seed, epoch), bit for bit as in the JAX package.  Batches leave the host
as uint8 (4x fewer bytes than fp32) and are normalised on the device by
the trainer.  One batch of look-ahead: the copy of batch i+1 is issued
before batch i is handed out, from pinned memory when the device is a
card.  Process slicing and sharding wait for ROADMAP.md Queue 1 item 10.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from .datasets import ArrayDataset


def epoch_permutation(
    num_items: int,
    augmentations_per_datapoint: int,
    epoch: int,
    seed: int = 0,
    shuffle: bool = True,
) -> np.ndarray:
    """Shuffled virtual -> base index map for one epoch."""
    reps = augmentations_per_datapoint + 1
    virt = np.arange(num_items * reps) // reps
    if shuffle:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        rng.shuffle(virt)
    return virt


class BatchPipeline:
    """Iterate ``(images_u8, masks_u8)`` batches on ``device`` over an
    ArrayDataset.  ``drop_last=True`` keeps every training batch full;
    evaluation uses ``drop_last=False``.  ``mask_attr``: the dataset field
    the masks come from ("raw_masks" for the prompt task's palette masks)."""

    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int,
        *,
        device,
        augmentations_per_datapoint: int = 0,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        mask_attr: str = "masks",
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.augmentations_per_datapoint = augmentations_per_datapoint
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.mask_attr = mask_attr
        if getattr(dataset, mask_attr) is None:
            raise ValueError(f"the dataset has no {mask_attr!r}")

    def batches_per_epoch(self) -> int:
        n = len(self.dataset) * (self.augmentations_per_datapoint + 1)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _to_device(self, idx: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        pin = self.device.type == "cuda"
        out = []
        for src in (self.dataset.images, getattr(self.dataset, self.mask_attr)):
            t = torch.from_numpy(src[idx])
            if pin:
                t = t.pin_memory()
            out.append(t.to(self.device, non_blocking=pin))
        return out[0], out[1]

    def epoch(self, epoch: int = 0) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Yield device-placed uint8 (images, masks) batches for one epoch."""
        order = epoch_permutation(len(self.dataset), self.augmentations_per_datapoint,
                                  epoch, self.seed, self.shuffle)
        b = self.batch_size
        num_batches = self.batches_per_epoch()
        pending = self._to_device(order[:b]) if num_batches else None
        for i in range(num_batches):
            nxt = (self._to_device(order[(i + 1) * b:(i + 2) * b])
                   if i + 1 < num_batches else None)
            out, pending = pending, nxt
            yield out
