"""ctypes bindings for the C++ batch assembler ``runtime/loader.cpp``;
counterpart of ``image_segmentation_tpu/data/native_loader.py``.

The assembler fills contiguous uint8 batches on a background thread
(GIL-free) into a ring of slots, overlapping host batch preparation with
device compute.  Its C interface is the JAX package's (:42-72), and so are
the semantics: index replication, a per-epoch shuffle keyed on (seed,
epoch) from its own stream (``mt19937_64``, so the order is not
:func:`~.pipeline.epoch_permutation`'s), and per-process strided shards
of every global batch (rank r takes positions r, r+R, ... of the batch;
its rows of the global batch are then ``[r*b/R, (r+1)*b/R)``, the same
slot a contiguous shard takes).  ``process_count > 1`` requires
``drop_last=True``: a remainder would give the ranks unequal shards.
Under tensor parallelism (``parallel.mesh`` model groups of M > 1) it
raises ``ValueError``, as JAX's refuses a sub-row layout (:121-143): each
process of a model group holds a data row's rows that its neighbours hold
too, which the C++ shard does not give; ``native_loader=False`` takes the
Python pipeline there.

The library is built from the checkout's ``runtime/loader.cpp`` with
``g++`` into ``build/native/`` (never into ``runtime/``, where the JAX
package caches its own copy), once per source change.

To a card, each batch goes straight from its ring slot: the slots are
page-locked in place (``cudaHostRegister``) the first time they are seen,
the copy runs on a side CUDA stream, the consumer's stream waits on its
event, and the slot is released once the copy has landed, when the
consumer asks for the next batch; meanwhile the C++ thread fills the other
slots.  The loader hands out one slot at a time (``loader_next`` gives the
slot after the last one released), so one copy is in flight.  On the CPU
each batch is copied out of its slot, which is then released at once.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..parallel import mesh
from .pipeline import BatchPipeline

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "runtime" / "loader.cpp"
LIBRARY = _ROOT / "build" / "native" / "libimgseg_loader.so"

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build_library() -> None:
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                    str(SOURCE), "-o", str(tmp)], check=True, capture_output=True)
    os.replace(tmp, LIBRARY)


def load_library() -> ctypes.CDLL:
    """Load the native loader library, building it first if it is missing
    or older than its source."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
            _build_library()
        lib = ctypes.CDLL(str(LIBRARY))
        lib.loader_new.restype = ctypes.c_void_p
        lib.loader_new.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int64,
        ]
        lib.loader_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.loader_num_batches.restype = ctypes.c_int64
        lib.loader_num_batches.argtypes = [ctypes.c_void_p]
        lib.loader_next.restype = ctypes.c_int64
        lib.loader_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.loader_release.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.loader_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_loader_available() -> bool:
    """Whether the library builds (``g++`` present) and loads."""
    try:
        load_library()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


class NativeBatchPipeline(BatchPipeline):
    """:class:`~.pipeline.BatchPipeline` with its batches assembled by the
    C++ loader (same constructor, plus ``ring_depth``)."""

    def __init__(self, dataset, batch_size: int, *, ring_depth: int = 3, **kwargs):
        super().__init__(dataset, batch_size, **kwargs)
        if mesh.model_size() > 1:
            # JAX's rule (data/native_loader.py:121-143): the C++ shard hands
            # each process batch/process_count rows, valid only where the
            # process addresses exactly that many; a process of a model group
            # holds part of a data row that its neighbours hold too
            ranks = mesh.world_size()
            raise ValueError(
                f"native loader: process addresses {batch_size // self.process_count} batch "
                f"rows but batch/process_count = {batch_size // ranks}; sub-row process "
                "layouts need native_loader=False")
        if self.process_count > 1 and not self.drop_last:
            raise ValueError("process_count > 1 requires drop_last=True")
        self._lib = load_library()
        self._registered = []
        self._images = np.ascontiguousarray(dataset.images)
        self._masks = np.ascontiguousarray(getattr(dataset, self.mask_attr))
        n, h, w, c = self._images.shape
        self._shape = (h, w, c)
        self._handle = self._lib.loader_new(
            self._images.ctypes.data_as(ctypes.c_void_p),
            self._masks.ctypes.data_as(ctypes.c_void_p),
            n, h * w * c, h * w, batch_size, self.augmentations_per_datapoint + 1,
            self.process_index, self.process_count,
            int(self.shuffle), int(self.drop_last), self.seed, ring_depth,
        )

    def batches_per_epoch(self) -> int:
        return int(self._lib.loader_num_batches(self._handle))

    def _slots(self, epoch: int) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor]]:
        """``(slot, images, masks)`` of each batch, the tensors over the ring
        slot's memory: valid until the caller releases the slot, which it
        must do before asking for the next."""
        h, w, c = self._shape
        self._lib.loader_start_epoch(self._handle, epoch)
        img_p, mask_p, items = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_int64()
        while True:
            slot = self._lib.loader_next(self._handle, ctypes.byref(img_p),
                                         ctypes.byref(mask_p), ctypes.byref(items))
            if slot < 0:
                return
            b = items.value
            yield slot, *(torch.from_numpy(np.ctypeslib.as_array(
                ctypes.cast(p, ctypes.POINTER(ctypes.c_uint8)), shape=shape))
                for p, shape in ((img_p, (b, h, w, c)), (mask_p, (b, h, w))))

    def _register(self, t: torch.Tensor, item_bytes: int) -> None:
        """Page-lock the ring slot that ``t`` starts, whole, once."""
        ptr = t.data_ptr()
        if ptr not in self._registered:
            per_proc = -(-self.batch_size // self.process_count)  # the C++ slot's items
            cudart = torch.cuda.cudart()
            torch.cuda.check_error(cudart.cudaHostRegister(ptr, per_proc * item_bytes, 0))
            self._registered.append(ptr)

    def _device_batches(self, epoch: int) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        side = torch.cuda.Stream(self.device)
        h, w, c = self._shape
        for slot, images, masks in self._slots(epoch):
            self._register(images, h * w * c)
            self._register(masks, h * w)
            with torch.cuda.stream(side):
                out = (images.to(self.device, non_blocking=True),
                       masks.to(self.device, non_blocking=True))
                done = torch.cuda.Event()
                done.record(side)
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for t in out:
                t.record_stream(consumer)
            yield out
            done.synchronize()
            self._lib.loader_release(self._handle, slot)

    def _host_batches(self, epoch: int) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        for slot, images, masks in self._slots(epoch):
            out = images.clone(), masks.clone()
            self._lib.loader_release(self._handle, slot)
            yield out

    def epoch(self, epoch: int = 0) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Yield this rank's device-placed uint8 (images, masks) batches."""
        if self.device.type == "cuda":
            return self._device_batches(epoch)
        return (tuple(t.to(self.device) for t in batch) for batch in self._host_batches(epoch))

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            for ptr in self._registered:  # before the slots are freed
                torch.cuda.cudart().cudaHostUnregister(ptr)
            self._lib.loader_free(handle)
            self._handle = None
