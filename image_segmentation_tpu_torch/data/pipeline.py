"""Host -> device batch pipeline; counterpart of
``image_segmentation_tpu/data/pipeline.py`` (epoch_permutation :34,
BatchPipeline :50, prefetch_to_device :207).

Each epoch visits a permutation of VIRTUAL indices: every item appears
``augmentations_per_datapoint + 1`` times, shuffled by a generator keyed on
(seed, epoch), bit for bit as in the JAX package.  Batches leave the host
as uint8 (4x fewer bytes than fp32) and are normalised on the device by
the trainer.  One batch of look-ahead: the copy of batch i+1 is issued
before batch i is handed out, from pinned memory when the device is a
card.

Several processes (``process_count`` R > 1 data rows, one rank each, or
M ranks each under tensor parallelism): every rank walks the same order
and takes the rows ``[r*n/R, (r+1)*n/R)`` of each n-row global batch for
its data row r, the rows JAX's batch-sharded global array places on data
row r (:137-161), so the M ranks of a data row get the same rows.  A batch
size that R does not divide raises ``ValueError``.  A remainder batch (``drop_last=False``) whose rows R does
not divide goes to every rank whole, as JAX places it replicated
(:162-186); :meth:`BatchPipeline.replicated` tells the consumer, which
then computes that batch's metrics on each rank alone
(``parallel.mesh.local``), so they equal those of one process.
"""

from __future__ import annotations

import collections
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..parallel import mesh
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
    ArrayDataset: this process's rows of each global batch of
    ``batch_size``.  ``drop_last=True`` keeps every training batch full;
    evaluation uses ``drop_last=False``.  ``mask_attr``: the dataset field
    the masks come from ("raw_masks" for the palette masks).
    ``process_index`` / ``process_count`` default to this rank's data row
    and the number of data rows (``parallel.mesh.data_rank`` /
    ``data_size``: the rank and the world size without tensor
    parallelism)."""

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
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.augmentations_per_datapoint = augmentations_per_datapoint
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.mask_attr = mask_attr
        self.process_index = mesh.data_rank() if process_index is None else process_index
        self.process_count = mesh.data_size() if process_count is None else process_count
        if getattr(dataset, mask_attr) is None:
            raise ValueError(f"the dataset has no {mask_attr!r}")
        if batch_size % self.process_count:
            raise ValueError(f"batch_size {batch_size} not divisible by process_count "
                             f"{self.process_count}")

    @property
    def virtual_length(self) -> int:
        return len(self.dataset) * (self.augmentations_per_datapoint + 1)

    def batches_per_epoch(self) -> int:
        n, b = self.virtual_length, self.batch_size
        return n // b if self.drop_last else -(-n // b)

    def global_rows(self, i: int) -> int:
        """The rows of global batch ``i``."""
        return min(self.batch_size, self.virtual_length - i * self.batch_size)

    def replicated(self, i: int) -> bool:
        """Whether batch ``i`` goes to every rank whole (a remainder that
        the ranks do not divide)."""
        return self.process_count > 1 and self.global_rows(i) % self.process_count != 0

    def rows(self, i: int) -> slice:
        """This rank's rows of global batch ``i`` (all of a replicated one)."""
        n = self.global_rows(i)
        if self.process_count == 1 or self.replicated(i):
            return slice(0, n)
        return mesh.rows(n, self.process_index, self.process_count)

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
        """Yield device-placed uint8 (images, masks) batches for one epoch:
        this rank's rows of each global batch."""
        order = epoch_permutation(len(self.dataset), self.augmentations_per_datapoint,
                                  epoch, self.seed, self.shuffle)
        b = self.batch_size
        num_batches = self.batches_per_epoch()

        def batch(i):
            return self._to_device(order[i * b:(i + 1) * b][self.rows(i)])

        pending = batch(0) if num_batches else None
        for i in range(num_batches):
            nxt = batch(i + 1) if i + 1 < num_batches else None
            out, pending = pending, nxt
            yield out


def _tensors(item) -> tuple:
    return tuple(torch.from_numpy(t) if isinstance(t, np.ndarray) else t for t in item)


def prefetch_to_device(iterator: Iterator, size: int = 2, device="cuda") -> Iterator[tuple]:
    """Tuples of host arrays or tensors -> the same on ``device``, with up
    to ``size`` copies in flight (JAX :207).  To a card: each tensor from
    pinned memory, copied on a side CUDA stream; the consumer's stream
    waits on the copy's event before the tuple is handed out, and each
    tensor is marked used by that stream (``record_stream``), so the
    caching allocator keeps it until the consumer's work on it is done.
    Elsewhere: a plain ``.to(device)``."""
    device = torch.device(device)
    if device.type != "cuda":
        for item in iterator:
            yield tuple(t.to(device) for t in _tensors(item))
        return
    side = torch.cuda.Stream(device)
    queue = collections.deque()

    def issue(item):
        with torch.cuda.stream(side):
            out = tuple((t if t.is_pinned() else t.pin_memory()).to(device, non_blocking=True)
                        for t in _tensors(item))
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def hand_out(out, done):
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in out:
            t.record_stream(consumer)
        return out

    for item in iterator:
        queue.append(issue(item))
        if len(queue) >= size:
            yield hand_out(*queue.popleft())
    while queue:
        yield hand_out(*queue.popleft())
