"""The port's data layer (image_segmentation_tpu_torch/data: records,
the Pet loader, host_augment, the multi-rank BatchPipeline, the native
loader, prefetch_to_device) against the JAX package on the CPU.

Inputs come from numpy seeds.  Tolerance: none — every comparison is bit
for bit (the numpy code is JAX's, call for call; the pipelines move
uint8 values).  The local ``datasets`` directory is written by the test
itself (parquet files in the hub dataset's byte-record schema); the hub
fallback of ``load_pet_dataset``, which needs the network, is made to
raise if it were reached.
"""

import os

import numpy as np
import pytest
import torch

import jax

from image_segmentation_tpu.data import datasets as jax_datasets
from image_segmentation_tpu.data import host_augment as jax_host_augment
from image_segmentation_tpu.data import native_loader as jax_native
from image_segmentation_tpu.data import pipeline as jax_pipeline
from image_segmentation_tpu.data import records as jax_records
from image_segmentation_tpu.parallel import mesh as jax_mesh
from image_segmentation_tpu_torch.data import datasets, host_augment, native_loader, pipeline
from image_segmentation_tpu_torch.data import records
from image_segmentation_tpu_torch.parallel import mesh

PALETTE = np.array([0, 38, 75, 255, 7], np.uint8)  # 7: a value outside the palette


def _raw_masks(seed, n=6, size=16):
    rng = np.random.default_rng(seed)
    raw = PALETTE[rng.integers(0, len(PALETTE), (n, size, size))]
    raw[0][raw[0] == 38] = 75  # an image without a cat pixel
    raw[1][:] = 0              # an image with no animal
    return raw


# ---- records ----------------------------------------------------------------

@pytest.mark.parametrize("fn", ["remap_mask", "binary_any_animal_mask", "class_presence_masks"])
def test_record_functions_equal_jax(fn):
    for raw in _raw_masks(3):
        got, want = getattr(records, fn)(raw), getattr(jax_records, fn)(raw)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert np.array_equal(np.asarray(g), np.asarray(w)) and np.asarray(g).dtype == np.asarray(w).dtype


@pytest.mark.parametrize("fn", ["remap_mask_batch", "binary_any_animal_batch"])
def test_record_batch_functions_equal_jax(fn):
    raw = _raw_masks(4)
    got, want = getattr(records, fn)(raw), getattr(jax_records, fn)(raw)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert np.array_equal(g, w) and g.dtype == w.dtype


def test_deserialize_and_palette_constants_equal_jax():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, records.IMAGE_SHAPE, dtype=np.uint8)
    assert np.array_equal(records.deserialize_image(img.tobytes()),
                          jax_records.deserialize_image(img.tobytes()))
    for name in ("CAT_PALETTE", "DOG_PALETTE", "UNCERTAIN_PALETTE", "CAT_ID", "DOG_ID",
                 "IMAGE_SHAPE", "MASK_SHAPE"):
        assert getattr(records, name) == getattr(jax_records, name), name
    assert datasets.CAT_PALETTE == records.CAT_PALETTE  # re-exported


# ---- datasets ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_shapes_dataset_equals_jax(seed):
    got = datasets.synthetic_shapes_dataset(6, 24, 32, seed=seed)
    want = jax_datasets.synthetic_shapes_dataset(6, 24, 32, seed=seed)
    assert np.array_equal(got.images, want.images) and np.array_equal(got.masks, want.masks)


def test_host_augment_equals_jax():
    ds = datasets.synthetic_shapes_dataset(3, 24, 24, seed=1)
    got = list(host_augment.robust_augment_epoch(ds, 2, seed=4))
    want = list(jax_host_augment.robust_augment_epoch(ds, 2, seed=4))
    assert len(got) == len(want) == 9
    for (gi, gm), (wi, wm) in zip(got, want):
        assert np.array_equal(gi, wi) and np.array_equal(gm, wm)
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    a = host_augment.robust_transform_item(rng_a, ds.images[0], ds.masks[0], blur_kernel=5)
    b = jax_host_augment.robust_transform_item(rng_b, ds.images[0], ds.masks[0], blur_kernel=5)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_load_pet_dataset_npz_route_equals_jax(tmp_path):
    ds = datasets.synthetic_dataset(5, 16, 16, seed=2, keep_raw_masks=True)
    np.savez(tmp_path / "validation_arrays.npz", images=ds.images, masks=ds.masks,
             raw_masks=ds.raw_masks)
    for keep in (False, True):
        got = datasets.load_pet_dataset("validation", str(tmp_path), keep_raw_masks=keep)
        want = jax_datasets.load_pet_dataset("validation", str(tmp_path), keep_raw_masks=keep)
        assert np.array_equal(got.images, want.images) and np.array_equal(got.masks, want.masks)
        assert (got.raw_masks is None) == (want.raw_masks is None) == (not keep)
        if keep:
            assert np.array_equal(got.raw_masks, want.raw_masks)
    with pytest.raises(ValueError, match="split must be one of"):
        datasets.load_pet_dataset("training", str(tmp_path))


def test_load_pet_dataset_local_directory_route_equals_jax(tmp_path, monkeypatch):
    import datasets as hfds

    real = hfds.load_dataset

    def local_only(path, *args, **kwargs):
        if path == datasets.HF_DATASET_ID:
            raise AssertionError("the hub fallback was reached")
        return real(path, *args, **kwargs)

    monkeypatch.setattr(hfds, "load_dataset", local_only)
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (3, 256, 256, 3), dtype=np.uint8)
    raw = PALETTE[:4][rng.integers(0, 4, (3, 256, 256))]
    loc = tmp_path / "pet"
    (loc / "data").mkdir(parents=True)
    hfds.Dataset.from_dict({"image": [im.tobytes() for im in images],
                            "mask": [m.tobytes() for m in raw]}).to_parquet(
        str(loc / "data" / "test-00000-of-00001.parquet"))
    got = datasets.load_pet_dataset("test", str(loc), cache=False, keep_raw_masks=True)
    want = jax_datasets.load_pet_dataset("test", str(loc), cache=False, keep_raw_masks=True)
    for field in ("images", "masks", "raw_masks"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), field
    assert np.array_equal(got.images, images) and np.array_equal(got.raw_masks, raw)
    # the cache the port writes is the one JAX reads
    datasets.load_pet_dataset("test", str(loc), cache=True)
    assert os.path.exists(loc / "test_arrays.npz")
    cached = jax_datasets.load_pet_dataset("test", str(loc))
    assert np.array_equal(cached.masks, got.masks)


# ---- the pipeline over several ranks ----------------------------------------

def _jax_rank_rows(arr, rank, size):
    """The rows of a batch-sharded JAX global array on data row ``rank``
    (the whole array when it is replicated)."""
    spans = {}
    for shard in arr.addressable_shards:
        lo = shard.index[0].start or 0
        spans[lo] = np.asarray(shard.data)
    starts = sorted(spans)
    return spans[starts[rank]] if len(starts) == size else np.asarray(arr)


@pytest.mark.parametrize("size", [2, 4])
def test_rank_rows_equal_the_rows_of_jax_sharded_batches(size):
    """Each rank's rows of every batch equal the rows that JAX's
    batch-sharded global array places on its data row; the ranks' rows
    concatenate to the one-process batch.  16 items x 2 (aug 1) in batches
    of 12 leaves a remainder of 8, which 2 and 4 divide; the eval pipeline
    over 10 items leaves 10 - 8 = 2, which 4 does not (whole on every
    rank, replicated in JAX)."""
    ds = datasets.synthetic_dataset(16, 4, 4, seed=1)
    devices = jax.devices()[:size]
    shard = jax_mesh.batch_sharding(jax_mesh.make_mesh(n_data=size, devices=devices))
    for n_items, batch, aug, drop in ((16, 12, 1, False), (10, 8, 0, False), (16, 8, 1, True)):
        sub = datasets.ArrayDataset(ds.images[:n_items], ds.masks[:n_items])
        kw = dict(augmentations_per_datapoint=aug, shuffle=True, drop_last=drop, seed=3)
        ref = list(jax_pipeline.BatchPipeline(
            jax_datasets.ArrayDataset(sub.images, sub.masks), batch, sharding=shard,
            process_index=0, process_count=1, **kw).epoch(2))
        whole = list(pipeline.BatchPipeline(sub, batch, device="cpu", process_index=0,
                                            process_count=1, **kw).epoch(2))
        ranks = [pipeline.BatchPipeline(sub, batch, device="cpu", process_index=r,
                                        process_count=size, **kw) for r in range(size)]
        per_rank = [list(p.epoch(2)) for p in ranks]
        assert len(ref) == len(whole) == ranks[0].batches_per_epoch() == len(per_rank[0])
        for i, (ji, jm) in enumerate(ref):
            replicated = ranks[0].replicated(i)
            assert replicated == (ji.shape[0] % size != 0)
            for r in range(size):
                gi, gm = per_rank[r][i]
                if replicated:
                    assert np.array_equal(gi.numpy(), np.asarray(ji))
                else:
                    assert np.array_equal(gi.numpy(), _jax_rank_rows(ji, r, size))
                    assert np.array_equal(gm.numpy(), _jax_rank_rows(jm, r, size))
            if not replicated:
                cat = torch.cat([per_rank[r][i][0] for r in range(size)])
                assert torch.equal(cat, whole[i][0])


def test_indivisible_batch_raises_value_error():
    ds = datasets.synthetic_dataset(8, 4, 4)
    with pytest.raises(ValueError, match="not divisible by process_count"):
        pipeline.BatchPipeline(ds, 6, device="cpu", process_index=0, process_count=4)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.rows(6, 0, 4)
    assert mesh.rows(8, 3, 4) == slice(6, 8)


def test_prefetch_to_device_on_the_cpu_keeps_order_and_values():
    items = [(np.full((2, 3), i, np.uint8), torch.full((4,), i)) for i in range(5)]
    out = list(pipeline.prefetch_to_device(iter(items), size=3, device="cpu"))
    assert len(out) == 5
    for i, (a, b) in enumerate(out):
        assert isinstance(a, torch.Tensor) and int(a[0, 0]) == i and int(b[0]) == i


# ---- the native loader ------------------------------------------------------

@pytest.fixture(scope="module")
def native():
    if not native_loader.native_loader_available():
        pytest.skip("the native loader did not build (no g++)")
    return native_loader


@pytest.mark.parametrize("count", [1, 2])
def test_native_pipeline_equals_jax_native(native, count):
    """The port's C++ batches are JAX's NativeBatchPipeline's, bit for bit,
    for one seed, every rank of ``count``."""
    ds = datasets.synthetic_dataset(10, 8, 8, seed=4)
    jds = jax_datasets.ArrayDataset(ds.images, ds.masks)
    for r in range(count):
        kw = dict(augmentations_per_datapoint=1, shuffle=True, drop_last=True, seed=7,
                  process_index=r, process_count=count)
        got = list(native.NativeBatchPipeline(ds, 6, device="cpu", **kw).epoch(1))
        want = list(jax_native.NativeBatchPipeline(jds, 6, **kw).epoch(1))
        assert len(got) == len(want) == 3
        for (gi, gm), (wi, wm) in zip(got, want):
            assert np.array_equal(gi.numpy(), np.asarray(wi))
            assert np.array_equal(gm.numpy(), np.asarray(wm))


def test_native_pipeline_without_shuffle_equals_the_python_pipeline(native):
    ds = datasets.synthetic_dataset(10, 8, 8, seed=5)
    kw = dict(augmentations_per_datapoint=1, shuffle=False, drop_last=False)
    got = list(native.NativeBatchPipeline(ds, 6, device="cpu", **kw).epoch(0))
    want = list(pipeline.BatchPipeline(ds, 6, device="cpu", **kw).epoch(0))
    assert len(got) == len(want) == 4  # the remainder of 2 included
    for (gi, gm), (wi, wm) in zip(got, want):
        assert torch.equal(gi, wi) and torch.equal(gm, wm)
    with pytest.raises(ValueError, match="requires drop_last=True"):
        native.NativeBatchPipeline(ds, 6, device="cpu", drop_last=False, process_index=0,
                                   process_count=2)
