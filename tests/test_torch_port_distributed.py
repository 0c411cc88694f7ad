"""The port's data parallelism (parallel/mesh.py, the Trainer and the
Evaluator over several ranks, BatchNorm over the global batch through the
kernel blocks) on the CPU: two gloo ranks against one process, and
against JAX's Trainer on a 2-device CPU mesh.

The two ranks are spawned once for the module (``mesh.launch``, a free
localhost port); each runs ``tests/_torch_port_dist_worker.run`` and
writes its arrays, and the same function runs in this process at world
size 1 on the same global batch.  The model: the ``large_unet`` preset's
model args at narrow widths (levels 0-1 on the kernel blocks, whose plain
versions run on the CPU; the deep levels on the plain BatchNorm), 32x32,
a global batch of 16 (8 rows a rank), fp32, Adam eps 1e-3.

Tolerances, each with its reason:

- two ranks against one, one augmented step: gradients, BatchNorm running
  statistics and parameters after Adam at rtol 1e-5, atol 1e-7.  The only
  difference is the order of the fp32 sums (the statistics' and the
  losses' over ranks, the gradients' all-reduce); the atol covers the
  components whose value is itself rounding noise (the conv biases in
  front of a training-mode BatchNorm have an exact gradient of 0, about
  1e-9 here);
- the two ranks' parameters after the step: bit for bit (the averaged
  gradients are one all-reduce result, so every rank applies the same
  update);
- the loss: rtol 1e-6 (one fp32 sum over ranks);
- two ranks against JAX's Trainer on a (data=2) mesh, one step without
  augmentation (JAX draws its own augmentation): the tolerances of
  tests/test_torch_port_train.py for one device (losses and parameters
  rtol 5e-4, atol 5e-5; gradients rtol 1e-3, atol 1e-6);
- the Evaluator's and ``Trainer.evaluate``'s metrics at two ranks against
  one: rel 1e-6, the bound of tests/test_multiprocess.py:128-140 (sums
  over ranks in another order), a remainder batch that two ranks do not
  divide present;
- save on rank 0 -> restore on both -> one more step, against two steps
  without the break: bit for bit;
- ``cli.train_distributed`` at two ranks, two epochs with a checkpoint
  each: every rank finishes, holds rank 0's run folder, and finds both
  checkpoints there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_segmentation_tpu import config as jax_config
from image_segmentation_tpu.engine.train import Trainer as JaxTrainer
from image_segmentation_tpu.parallel import mesh as jax_mesh
from image_segmentation_tpu_torch.entry import dryrun_multichip
from image_segmentation_tpu_torch.parallel import mesh
from image_segmentation_tpu_torch.utils.convert import jax_from_state_dict
from tests import _torch_port_dist_worker as worker

jax.config.update("jax_default_matmul_precision", "highest")
STEP_TOL = dict(rtol=1e-5, atol=1e-7)
LOSS_TOL = dict(rtol=5e-4, atol=5e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
METRIC_RTOL = 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    one_dir, two_dir = tmp_path_factory.mktemp("world1"), tmp_path_factory.mktemp("world2")
    one = worker.run(str(one_dir))
    two = mesh.launch("tests._torch_port_dist_worker:run", 2, [str(two_dir)], timeout=600)
    arrays = [np.load(one_dir / "rank0.npz")] + [np.load(two_dir / f"rank{r}.npz") for r in (0, 1)]
    return dict(one=one, two=two, arrays=arrays)


def _group(arrays, prefix):
    return {k[len(prefix):]: arrays[k] for k in arrays.files if k.startswith(prefix)}


def test_two_ranks_ran(runs):
    assert runs["one"]["world"] == 1 and [r["world"] for r in runs["two"]] == [2, 2]


@pytest.mark.parametrize("what", ["grad", "buffer", "param"])
def test_augmented_step_at_two_ranks_equals_one(runs, what):
    one, two0, _ = runs["arrays"]
    got, want = _group(two0, f"aug/{what}/"), _group(one, f"aug/{what}/")
    assert sorted(got) == sorted(want) and want
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **STEP_TOL)
    if what == "buffer":  # the running statistics moved off their initial values
        init = _group(one, "init/buffer/")
        assert any(not np.array_equal(init[k], want[k]) for k in want if "running" in k)


def test_ranks_hold_identical_state(runs):
    _, two0, two1 = runs["arrays"]
    assert sorted(two0.files) == sorted(two1.files)
    for k in two0.files:
        assert np.array_equal(two0[k], two1[k]), k


def test_loss_at_two_ranks_equals_one(runs):
    losses = [r["loss"] for r in runs["two"]]
    assert losses[0] == losses[1]
    np.testing.assert_allclose(losses[0], runs["one"]["loss"], rtol=1e-6)
    np.testing.assert_allclose(runs["two"][0]["loss_noaug"], runs["one"]["loss_noaug"], rtol=1e-6)


def _torch(arrays, prefix):
    return {k: torch.from_numpy(v) for k, v in _group(arrays, prefix).items()}


def test_step_at_two_ranks_equals_jax_on_a_two_device_mesh(runs):
    """One unaugmented step of the JAX Trainer, its batch sharded over a
    (data=2) CPU mesh, from the port's initial weights."""
    _, two0, _ = runs["arrays"]
    cfg = worker.cfg(0)
    jcfg = jax_config.TrainConfig(
        model=cfg.model, model_args=cfg.model_args, batch_size=cfg.batch_size, num_epochs=1,
        bf16=False, seed=0, optimizer=jax_config.OptimizerConfig(eps=worker.ADAM_EPS),
        data=jax_config.DataConfig(dataset="synthetic", synthetic_length=cfg.batch_size,
                                   image_size=worker.SIZE, augmentations_per_datapoint=0))
    init = {**_torch(two0, "init/param/"), **_torch(two0, "init/buffer/")}
    params, stats = jax_from_state_dict(init)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IMGSEG_PALLAS_MIN_WP", "1")
        jt = JaxTrainer(jcfg, mesh=jax_mesh.make_mesh(n_data=2, devices=jax.devices()[:2]),
                        make_artifacts=False)
        jt.state = jax_mesh.replicate(jt.mesh, dict(
            jt.state, params=jax.tree.map(jnp.asarray, params),
            batch_stats=jax.tree.map(jnp.asarray, stats)))
        images, masks = worker.global_batch()
        jt.state, loss = jt._train_step(jt.state, jnp.asarray(images), jnp.asarray(masks),
                                        jax.random.PRNGKey(0))
    np.testing.assert_allclose(runs["two"][0]["loss_noaug"], float(loss), **LOSS_TOL)
    got_params, got_stats = jax_from_state_dict(
        {**_torch(two0, "noaug/param/"), **_torch(two0, "noaug/buffer/")})
    got_grads = jax_from_state_dict(_torch(two0, "noaug/grad/"))[0]
    wd, b1 = jcfg.optimizer.weight_decay, jcfg.optimizer.b1
    mu = jax.device_get(jt.state["opt_state"][1].mu)
    jax_grads = jax.tree.map(lambda m, p: m / (1 - b1) - wd * p, mu, params)
    for got, want, tol, what in ((got_params, jt.state["params"], LOSS_TOL, "param"),
                                 (got_stats, jt.state["batch_stats"], LOSS_TOL, "batch_stats"),
                                 (got_grads, jax_grads, GRAD_TOL, "grad")):
        flat_want = dict(jax.tree_util.tree_flatten_with_path(jax.device_get(want))[0])
        flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert sorted(map(str, flat_got)) == sorted(map(str, flat_want)), what
        for path, w in flat_want.items():
            np.testing.assert_allclose(np.asarray(flat_got[path]), np.asarray(w),
                                       err_msg=f"{what} {jax.tree_util.keystr(path)}", **tol)


@pytest.mark.parametrize("what", ["clean", "random_point", "trainer_eval"])
def test_evaluation_at_two_ranks_equals_one(runs, what):
    one, (r0, r1) = runs["one"], runs["two"]
    assert r0[what] == r1[what]
    got, want = r0[what], one[what]
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        got, want = [got[k] for k in sorted(want)], [want[k] for k in sorted(want)]
    np.testing.assert_allclose(got, want, rtol=METRIC_RTOL, atol=0)


def test_resume_at_two_ranks_equals_the_unbroken_run(runs):
    for arrays in runs["arrays"]:
        unbroken, resumed = _group(arrays, "unbroken/"), _group(arrays, "resumed/")
        assert sorted(unbroken) == sorted(resumed)
        for k in unbroken:
            assert np.array_equal(unbroken[k], resumed[k]), k
    assert [r["restored_step"] for r in runs["two"]] == [1, 1]


def test_dryrun_multichip_two_ranks(capsys):
    loss = dryrun_multichip(2)
    assert np.isfinite(loss)
    assert "dryrun_multichip(2): ok" in capsys.readouterr().out


def test_train_distributed_cli_checkpoints_every_epoch_at_two_ranks(tmp_path):
    """Every rank reaches each checkpoint's wait: rank 0 alone saving would
    leave it waiting while the others run on to the next epoch's
    all-reduces."""
    ranks = mesh.launch("tests._torch_port_dist_worker:run_cli", 2, [str(tmp_path)],
                        timeout=300)
    assert [r["world"] for r in ranks] == [2, 2]
    assert ranks[0]["run_dir"] == ranks[1]["run_dir"]
    assert {"model_1.npz", "model_2.npz", "loss.csv", "model_settings.json"} <= set(
        ranks[0]["files"])
    with open(tmp_path / "UNet" / "run-001" / "loss.csv") as f:
        assert len(f.read().splitlines()) == 3  # the header and one row an epoch
