"""Tensor parallelism for the models and options whose steps
tests/test_torch_port_tensor_parallel.py leaves out: the autoencoder
(its fused and its unfused ``w2d_impl="pallas"`` blocks), the ClipRes
models with their frozen ResNet-34 sharded, ClipAutoencoder's coupler,
and ``fused_deep`` / ``remat`` on the U-Net, on the CPU, against
the port's world-1 step and JAX's Trainer on a ``(data=2, model=2)`` mesh.

Four gloo ranks are spawned once for the module (``mesh.launch``); each
runs ``tests/_torch_port_tp_models_worker.run`` on the grid (data=2,
model=2), and the same function runs in this process at world size 1.
The ``remat`` runs are the proof that the recomputed forward re-issues
the model group's gathers in the same order on every rank: were it
otherwise, the ranks would wait on each other until ``mesh.launch``'s
timeout.

Tolerances, each with its reason:

- (2, 2) against world 1, one step (float64 compute, the worker's doc):
  gradients, running statistics and parameters after Adam at
  tests/test_torch_port_distributed.py's ``STEP_TOL`` (rtol 1e-5, atol
  1e-7); the losses and the evaluation at rtol 1e-6;
- the four ranks after the step: bit for bit;
- (2, 2) against JAX's Trainer on ``make_mesh(n_data=2, n_model=2)``, one
  unaugmented step from the port's initial state, both in float64 (the
  port's step above; JAX under x64 with its model built in float64): the
  loss, the parameters after Adam and the running statistics at
  tests/test_torch_port_distributed.py's ``LOSS_TOL``, the gradients at
  its ``GRAD_TOL`` (rtol 1e-3, atol 1e-6).  JAX's folded Pallas kernels
  take no float64, so the JAX autoencoder there runs its standard blocks
  (``w2d_*`` off), the reference that tests/test_folded.py holds the
  folded ones to, over the same parameter tree.  ``clip_res`` and
  ``clip_res_class`` are held so in their unaugmented steps
  (``*_noaug``).  Measured on this batch
  (the port's world-1 step against JAX's (2, 2) for the autoencoder,
  against JAX's on one device for the others): every gradient leaf that
  is not zero by construction (the conv biases before BatchNorm, below
  1e-15 on both sides) has its largest element at 2e-4 or more in the
  autoencoder, 3.8e-4 in clip_autoencoder and 1.6e-3 in the ClipRes
  models, and JAX's and the port's differ by at most 3e-10, 3e-9, 2e-8
  (clip_res) and 4.9e-8 (clip_res_class), so ``GRAD_TOL``'s atol sits
  well below the gradients' size.  In fp32 the
  gradients would not hold to ``GRAD_TOL``: the order of the sums alone
  moves 9 of dec1's 64 bn1 bias gradients past it by up to 1.9e-6;
- save at (2, 2) -> restore -> one more step of ``clip_res`` against the
  unbroken run: bit for bit, every leaf of the state made whole.
"""

import dataclasses

import numpy as np
import pytest

import jax

from image_segmentation_tpu import config as jax_config
from image_segmentation_tpu_torch.parallel import mesh
from image_segmentation_tpu_torch.utils import checkpoint as ckpt_lib
from tests import _torch_port_tp_models_worker as worker
from tests import test_torch_port_tensor_parallel as tp_tests

jax.config.update("jax_default_matmul_precision", "highest")
STEP_TOL = dict(rtol=1e-5, atol=1e-7)
LOSS_TOL = dict(rtol=5e-4, atol=5e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
RANKS = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    one_dir, tp_dir = tmp_path_factory.mktemp("world1"), tmp_path_factory.mktemp("tp")
    one = worker.run(str(one_dir), 1)
    ranks = mesh.launch("tests._torch_port_tp_models_worker:run", RANKS, [str(tp_dir), 2],
                        timeout=300)
    arrays = [np.load(one_dir / "tpm1_0.npz")] + [np.load(tp_dir / f"tpm{RANKS}_{r}.npz")
                                                  for r in range(RANKS)]
    return dict(one=one, ranks=ranks, arrays=arrays, dirs=(one_dir, tp_dir))


def _group(arrays, prefix):
    return {k[len(prefix):]: arrays[k] for k in arrays.files if k.startswith(prefix)}


@pytest.mark.parametrize("what", ["grad", "buffer", "param"])
@pytest.mark.parametrize("name", list(worker.CONFIGS))
def test_step_at_2x2_equals_world_1(runs, name, what):
    one, tp0 = runs["arrays"][:2]
    got, want = _group(tp0, f"{name}/{what}/"), _group(one, f"{name}/{what}/")
    assert sorted(got) == sorted(want) and want
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **STEP_TOL)


def test_every_model_is_sharded(runs):
    plans = [r["plan"] for r in runs["ranks"]]
    assert all(p == plans[0] for p in plans)
    assert all(plans[0][name] for name in [*worker.CONFIGS, "prompt_fusion"])
    assert all(not p for p in runs["one"]["plan"].values())
    # the autoencoder's kernel blocks and ConvTransposes, dec3 on Co/2 = 16 included
    for key in ("encoder.enc1.block.0.conv.0.weight", "encoder.enc2.block.0.conv.3.weight",
                "decoder.dec1.up.weight", "decoder.dec3.up.weight",
                "decoder.dec3.conv.conv.3.weight"):
        assert key in plans[0]["autoencoder"], key
    assert "encoder.input.weight" not in plans[0]["autoencoder"]
    assert plans[0]["autoencoder_unfused"] == plans[0]["autoencoder"]
    assert "coupler.weight" in plans[0]["clip_autoencoder"]
    # clip_res: dec5 and the output block stay whole, the class head too
    assert not any(k.startswith(("dec5.", "out.")) for k in plans[0]["clip_res"])
    assert not any(k.startswith("class_head") for k in plans[0]["clip_res_class"])
    # the fold-1 fused blocks at both convs
    for key in ("enc3.block.0.conv.0.weight", "bottleneck.conv.3.weight",
                "dec1.conv.conv.0.weight", "dec2.conv.conv.3.weight"):
        assert key in plans[0]["unet_fused_deep"], key


def test_the_four_ranks_hold_identical_state(runs):
    tp = runs["arrays"][1:]
    for arrays in tp[1:]:
        assert sorted(arrays.files) == sorted(tp[0].files)
        for k in tp[0].files:
            assert np.array_equal(arrays[k], tp[0][k]), k


def test_losses_and_evaluation_at_2x2_equal_world_1(runs):
    losses = [r["loss"] for r in runs["ranks"]]
    assert all(loss == losses[0] for loss in losses)
    for name, loss in runs["one"]["loss"].items():
        np.testing.assert_allclose(losses[0][name], loss, rtol=1e-6, err_msg=name)
    evals = [r["eval"] for r in runs["ranks"]]
    assert all(e == evals[0] for e in evals)
    assert sorted(evals[0]) == ["autoencoder", "clip_res_class"]
    for name, metrics in runs["one"]["eval"].items():
        for k, v in metrics.items():
            np.testing.assert_allclose(evals[0][name][k], v, rtol=1e-6, err_msg=f"{name} {k}")


def test_the_sharded_backbone_stays_frozen_and_its_statistics_move(runs):
    for r in [runs["one"], *runs["ranks"]]:
        assert r["backbone_changed"] == []
        assert r["backbone_stats_moved"] == r["backbone_stats"] == 2 * (1 + 2 * 16 + 3)
        assert r["basic_blocks"] == 16
    assert len(runs["ranks"][0]["backbone_sharded"]) == 1 + 2 * 16 + 3


def test_resume_of_clip_res_at_2x2_equals_the_unbroken_run(runs):
    for r in [runs["one"], *runs["ranks"]]:
        assert r["restored_step"] == 1
        assert r["resume_differ"] == [] and r["resume_keys"] > 400


def test_a_2x2_clip_res_checkpoint_has_world_1_keys_and_shapes(runs):
    one_dir, tp_dir = runs["dirs"]
    one = ckpt_lib.load_checkpoint_flat(str(one_dir / "ckpt_clip_res1.npz"))
    tp = ckpt_lib.load_checkpoint_flat(str(tp_dir / f"ckpt_clip_res{RANKS}.npz"))
    assert sorted(tp) == sorted(one)
    for k in one:
        assert tp[k].shape == one[k].shape, k
    # the frozen ResNet-34 whole, as at world 1 (the stem conv: 7x7, 3 -> 64)
    assert tp["params/resnet_backbone/conv1/kernel"].shape == (7, 7, 3, 64)
    np.testing.assert_array_equal(tp["params/resnet_backbone/conv1/kernel"],
                                  one["params/resnet_backbone/conv1/kernel"])


def test_fused_deep_picks_the_same_blocks_at_two_model_shards(runs):
    blocks = [runs["one"]["blocks"]] + [r["blocks"] for r in runs["ranks"]]
    assert all(b == blocks[0] for b in blocks)
    kinds = dict(blocks[0])
    assert kinds["enc3"] == "FusedDeepConvBlockDownsample"
    assert kinds["bottleneck"] == "FusedConvBlock"
    assert kinds["dec1"] == kinds["dec2"] == "FusedDeepConvBlockUpsampleSkip"


def test_prompt_fusion_fails_at_its_first_step_as_at_world_1(runs):
    want = runs["one"]["prompt_fusion"]
    assert want.startswith("TypeError:") and "prompt" in want
    assert [r["prompt_fusion"] for r in runs["ranks"]] == [want] * RANKS


@pytest.mark.parametrize("name", list(worker.JAX_HELD))
def test_step_at_2x2_equals_jax_on_a_2x2_mesh(runs, name):
    """Both in float64; the JAX autoencoder on its standard blocks (module doc)."""
    cfg = worker.cfg(name, 2)
    pre = jax_config.preset(worker.CONFIGS[name][0])
    jcfg = jax_config.TrainConfig(
        model=cfg.model, loss=cfg.loss, batch_size=cfg.batch_size,
        model_args={k: v for k, v in cfg.model_args.items() if not k.startswith("w2d")},
        num_epochs=1, bf16=False, seed=0, n_model_shards=2,
        optimizer=jax_config.OptimizerConfig(eps=worker.ADAM_EPS),
        data=dataclasses.replace(pre.data, dataset="synthetic",
                                 synthetic_length=cfg.batch_size, image_size=worker.SIZE,
                                 augmentations_per_datapoint=0))
    tp_tests.hold_to_jax(
        jcfg, runs["arrays"][1], f"{name}/", *worker.global_batch(name),
        runs["ranks"][0]["loss"][name], LOSS_TOL, LOSS_TOL, GRAD_TOL, float64=True)
