"""The port's tensor parallelism (``parallel.mesh.make_grid``,
``parallel/tensor.py``, ``utils.convert.tp_plan``, the column-parallel
layers and the TP form of the kernel blocks) on the CPU, against the
port's world-1 step and JAX's Trainer on a ``(data=2, model=2)`` mesh; the
sharding rule for all nine registry names, and every preset built at
M = 2.  The steps of the other models and of ``fused_deep`` and ``remat``:
tests/test_torch_port_tensor_parallel_models.py.

Four gloo ranks are spawned once for the module (``mesh.launch``); each
runs ``tests/_torch_port_tp_worker.run`` on the grid (data=2, model=2),
then the layouts (4, 1), (2, 2) and (1, 4) of tests/test_mesh_shapes.py in
the same processes, and the same function runs in this process at world
size 1.  Two more spawns: ``cli.train_distributed --model-shards 2`` at two
ranks, and ``entry.dryrun_multichip(8)``.

Tolerances, each with its reason:

- (2, 2) against world 1, one augmented step: gradients, running
  statistics and parameters after Adam at tests/test_torch_port_distributed
  .py's ``STEP_TOL`` (rtol 1e-5, atol 1e-7); the loss at rtol 1e-6.  Beyond
  the data axis's sums in another order, the model axis adds the partial
  sums over output channels of the dgrads (conv2's ``gy1, da1, db1`` and
  conv1's input gradient, summed over the model group), fp32 sums in
  another order: within the same tolerance;
- the four ranks after the step: bit for bit (the gathered slices, and the
  replicated leaves that every model rank updates alike);
- (2, 2) against JAX's Trainer on ``make_mesh(n_data=2, n_model=2)``, one
  step without augmentation from the port's initial weights (JAX's prompt
  points fed to the port): tests/test_torch_port_distributed.py's
  ``LOSS_TOL`` (loss, parameters after Adam, running statistics) and
  ``GRAD_TOL``.  ``large_unet`` steps in fp32.  ``clip_unet_prompt`` steps
  in float64 on both sides, at (2, 2) and at world 1 against JAX on one
  device (the port's model computing in float64, JAX under x64 with its
  model built in float64 on its standard blocks, the prompt points of its
  x64 draws): in fp32 about 1 % of dec1's conv1 gradient is off by up to
  3e-6 on values near 1e-4, fp32 rounding through the prompt branch
  (tests/test_torch_port_prompt.py measures JAX's own fp32 gradient at up
  to 14 % from its float64 one).  In float64 the world-1 gradients agree
  to 7.4e-8, the loss to 1.7e-7 relative (JAX's losses take fp32);
- the layouts (4, 1), (2, 2), (1, 4): the loss at rtol 1e-5 and the
  updated-parameter norm at rtol 1e-6 (one augmented fp32 step; the layouts
  differ only in the order of fp32 sums);
- save at (2, 2) -> restore -> one more step against two unbroken steps:
  bit for bit; the checkpoint has world 1's keys and shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_segmentation_tpu import config as jax_config
from image_segmentation_tpu.engine import train as jax_train
from image_segmentation_tpu.engine.train import Trainer as JaxTrainer
from image_segmentation_tpu.models.clip_models import FROZEN_PREFIXES
from image_segmentation_tpu.models.registry import build_model as jax_build_model
from image_segmentation_tpu.parallel import mesh as jax_mesh
from image_segmentation_tpu_torch import config
from image_segmentation_tpu_torch.engine.train import Trainer
from image_segmentation_tpu_torch.entry import SMALL_TOWER, dryrun_multichip
from image_segmentation_tpu_torch.models.registry import build_model
from image_segmentation_tpu_torch.parallel import mesh, tensor
from image_segmentation_tpu_torch.utils import checkpoint as ckpt_lib
from image_segmentation_tpu_torch.utils.convert import jax_from_state_dict, tp_plan
from tests import _torch_port_tp_worker as worker
from tests.test_torch_port_scripts import jax_points

jax.config.update("jax_default_matmul_precision", "highest")
STEP_TOL = dict(rtol=1e-5, atol=1e-7)
LOSS_TOL = dict(rtol=5e-4, atol=5e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
RANKS = 4


def _points(raw: np.ndarray, key) -> list:
    """JAX's prompt points ``(choice, cy, cx)`` of the step ``key``, as its
    ``_prepare_batch`` draws them from the key's first half
    (prompts.py:49-62)."""
    return jax_points(raw, jax.random.split(key)[0])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    one_dir, tp_dir = tmp_path_factory.mktemp("world1"), tmp_path_factory.mktemp("tp")
    raw = worker.global_batch("clip_unet_prompt")[1]
    points = _points(raw, jax.random.PRNGKey(0))
    with jax.enable_x64(True):  # the float64 step's: x64 draws other uniforms
        points64 = _points(raw, jax.random.PRNGKey(0))
    one = worker.run(str(one_dir), 1, points, points64)
    ranks = mesh.launch("tests._torch_port_tp_worker:run", RANKS,
                        [str(tp_dir), 2, points, points64], timeout=600)
    arrays = [np.load(one_dir / "tp1_0.npz")] + [np.load(tp_dir / f"tp{RANKS}_{r}.npz")
                                                 for r in range(RANKS)]
    return dict(one=one, ranks=ranks, arrays=arrays, dirs=(one_dir, tp_dir))


def _group(arrays, prefix):
    return {k[len(prefix):]: arrays[k] for k in arrays.files if k.startswith(prefix)}


# ---- the rule ---------------------------------------------------------------

MODELS = {
    "unet": dict(stem_features=16, encoder_features=(16, 32, 64)),
    "large_unet": worker.NARROW,
    "clip_unet": {"clip_kwargs": SMALL_TOWER},
    "clip_unet_prompt": {"clip_kwargs": SMALL_TOWER},
    "autoencoder": config.preset("autoencoder").model_args,
    "clip_res": {**config.preset("clip_res").model_args, "clip_kwargs": SMALL_TOWER},
    "clip_res_class": {**config.preset("segment_classifier").model_args,
                       "clip_kwargs": SMALL_TOWER},
    "clip_autoencoder": {"clip_kwargs": SMALL_TOWER},
    "prompt_fusion": {},
}
# leaves that the rule must shard: every ResNet-34 conv, the coupler
MUST_SHARD = {
    "clip_res": ("encoder.model.0.weight", "encoder.model.4.0.conv1.weight",
                 "encoder.model.5.0.downsample.0.weight", "encoder.model.7.2.conv2.weight"),
    "clip_autoencoder": ("coupler.weight",),
}
MUST_SHARD["clip_res_class"] = MUST_SHARD["clip_res"]


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("name", list(MODELS))
def test_the_rule_shards_what_jax_shards(name, n_model):
    """Every leaf's shape on model rank 0 equals the shard of JAX's
    ``shard_params_tp`` on device 0 of ``make_mesh(n_data=4/M, n_model=M)``,
    for every registry name (``prompt_fusion`` with its two inputs)."""
    import image_segmentation_tpu.models.prompt_fusion  # noqa: F401  (registers the name)

    args = MODELS[name]
    jmodel = jax_build_model(name, dtype=jnp.float32, **args)
    sample = jnp.zeros((1, 32, 32, 3), jnp.float32)
    two = name.endswith("prompt") or name == "prompt_fusion"
    inputs = (sample, jnp.zeros((1, 32, 32, 1), jnp.float32)) if two else (sample,)
    shapes = jax.eval_shape(lambda *a: jmodel.init(jax.random.PRNGKey(0), *a, train=False),
                            *inputs)["params"]
    jmesh = jax_mesh.make_mesh(n_data=4 // n_model, n_model=n_model, devices=jax.devices()[:4])
    placed = jax_mesh.shard_params_tp(jmesh, jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype), shapes))
    want = {jax.tree_util.keystr(p): tuple(a.sharding.shard_shape(a.shape))
            for p, a in jax.tree_util.tree_flatten_with_path(placed)[0]}

    model = build_model(name, device="cpu", dtype=torch.float32, **args)
    plan = tp_plan({k: tuple(p.shape) for k, p in model.named_parameters()}, n_model)
    tensor.shard_module_(model, plan, 0, n_model)
    got = {jax.tree_util.keystr(p): tuple(np.shape(a)) for p, a in
           jax.tree_util.tree_flatten_with_path(jax_from_state_dict(model.state_dict())[0])[0]}
    assert got == want
    assert plan  # the narrow widths shard something
    for key in MUST_SHARD.get(name, ()):
        assert plan[key][0] == 0, key  # conv (O, I, kH, kW), Dense (O, I): O
    if name.startswith("clip_res"):  # every ResNet-34 conv, the 7x7 stem and 1x1s included
        convs = [k for k in plan if k.startswith("encoder.model.")]
        assert len(convs) == 1 + 2 * 16 + 3


def test_the_narrow_large_unet_shards_both_kinds_of_block():
    """The widths of the worker's ``large_unet``: the kernel blocks of
    levels 0-1 (enc1, enc2), two ConvTransposes, and dec3 with its conv1
    sharded and its conv2 whole."""
    model = build_model("large_unet", device="meta", dtype=torch.float32,
                        **{**config.preset("large_unet").model_args, **worker.NARROW})
    plan = tp_plan({k: tuple(p.shape) for k, p in model.named_parameters()}, 2)
    for key in ("enc1.block.0.conv.0.weight", "enc1.block.0.conv.3.weight",
                "enc2.block.0.conv.0.weight", "enc2.block.0.conv.3.weight",
                "dec1.up.weight", "dec2.up.weight", "dec3.conv.conv.0.weight"):
        assert key in plan, key
    assert plan["dec1.up.weight"][0] == 1  # ConvTranspose2d (I, O, kH, kW): O
    assert "dec3.conv.conv.3.weight" not in plan
    assert len(plan) == 13 and len(dict(model.named_parameters())) == 58


# ---- (2, 2) against world 1 -------------------------------------------------

def test_the_ranks_form_the_grid(runs):
    assert runs["one"]["world"] == 1 and [r["world"] for r in runs["ranks"]] == [RANKS] * RANKS
    assert all(r["plan"] == runs["ranks"][0]["plan"] for r in runs["ranks"])
    assert runs["one"]["plan"] == []


@pytest.mark.parametrize("step", ["aug/", "noaug/large_unet/", "noaug/clip_unet_prompt/",
                                  "noaug64/clip_unet_prompt/"])
@pytest.mark.parametrize("what", ["grad", "buffer", "param"])
def test_step_at_2x2_equals_world_1(runs, what, step):
    one, tp0 = runs["arrays"][:2]
    got, want = _group(tp0, f"{step}{what}/"), _group(one, f"{step}{what}/")
    assert sorted(got) == sorted(want) and want
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **STEP_TOL)


def test_the_four_ranks_hold_identical_state(runs):
    tp = runs["arrays"][1:]
    for arrays in tp[1:]:
        assert sorted(arrays.files) == sorted(tp[0].files)
        for k in tp[0].files:
            assert np.array_equal(arrays[k], tp[0][k]), k


def test_loss_and_evaluation_at_2x2_equal_world_1(runs):
    losses = [r["loss"] for r in runs["ranks"]]
    assert len(set(losses)) == 1
    np.testing.assert_allclose(losses[0], runs["one"]["loss"], rtol=1e-6)
    for model, loss in runs["one"]["noaug"].items():
        np.testing.assert_allclose(runs["ranks"][0]["noaug"][model], loss, rtol=1e-6)
    evals = [r["eval"] for r in runs["ranks"]]
    assert all(e == evals[0] for e in evals)
    for k, v in runs["one"]["eval"].items():
        np.testing.assert_allclose(evals[0][k], v, rtol=1e-6, err_msg=k)


# ---- (2, 2) against JAX -----------------------------------------------------

def _torch(arrays, prefix):
    return {k: torch.from_numpy(v) for k, v in _group(arrays, prefix).items()}


def hold_to_jax(jcfg, arrays, prefix: str, images, masks, port_loss: float,
                loss_tol: dict, state_tol: dict, grad_tol=None, float64: bool = False,
                layout=(2, 2)) -> None:
    """One unaugmented step of the JAX Trainer of ``jcfg`` on
    ``make_mesh(n_data, n_model)`` of ``layout`` with ``shard_params_tp``,
    from the port's initial state (``arrays`` under ``prefix + "init/"``),
    on the global batch: the port's loss, parameters and running statistics
    after the step (under ``prefix``) against it, and with ``grad_tol`` its
    gradients against JAX's, taken back from Adam's first moment.  With
    ``float64`` the JAX Trainer runs under x64, its model built with
    ``dtype=float64`` and its state (Adam's included) float64."""
    init = {**_torch(arrays, prefix + "init/param/"), **_torch(arrays, prefix + "init/buffer/")}
    params, stats = jax_from_state_dict(init)
    wide = jnp.float64 if float64 else jnp.float32
    params, stats = (jax.tree.map(lambda a: np.asarray(a, wide), t) for t in (params, stats))
    build = jax_train.build_model
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(float64):
        mp.setenv("IMGSEG_PALLAS_MIN_WP", "1")
        if float64:
            mp.setattr(jax_train, "build_model",
                       lambda model, **kw: build(model, **dict(kw, dtype=jnp.float64)))
        n_data, n_model = layout
        jmesh = jax_mesh.make_mesh(n_data=n_data, n_model=n_model,
                                   devices=jax.devices()[:n_data * n_model])
        jt = JaxTrainer(jcfg, mesh=jmesh, make_artifacts=False)
        state = dict(jt.state, params=jax.tree.map(jnp.asarray, params),
                     batch_stats=jax.tree.map(jnp.asarray, stats))
        if float64:
            state["opt_state"] = jt.tx.init(state["params"])
        jt.state = jax_mesh.shard_params_tp(jt.mesh, state)
        jt.state, loss = jt._train_step(jt.state, jnp.asarray(images), jnp.asarray(masks),
                                        jax.random.PRNGKey(0))
    np.testing.assert_allclose(port_loss, float(loss), **loss_tol)
    got_params, got_stats = jax_from_state_dict(
        {**_torch(arrays, prefix + "param/"), **_torch(arrays, prefix + "buffer/")})
    got_grads = jax_from_state_dict(_torch(arrays, prefix + "grad/"))[0]
    wd, b1 = jcfg.optimizer.weight_decay, jcfg.optimizer.b1
    trainable = {k: v for k, v in params.items() if k not in FROZEN_PREFIXES}
    adam = jt.state["opt_state"]
    adam = (adam.inner_states["train"].inner_state if len(trainable) < len(params) else adam)[1]
    mu = jax.device_get(adam.mu)
    jax_grads = jax.tree.map(lambda m, p: m / (1 - b1) - wd * p,
                             {k: mu[k] for k in trainable}, trainable)
    got_grads = {k: v for k, v in got_grads.items() if k in jax_grads}
    checks = [(got_params, jt.state["params"], state_tol, "param"),
              (got_stats, jt.state["batch_stats"], state_tol, "batch_stats")]
    if grad_tol is not None:
        checks.append((got_grads, jax_grads, grad_tol, "grad"))
    for got, want, tol, what in checks:
        flat_want = dict(jax.tree_util.tree_flatten_with_path(jax.device_get(want))[0])
        flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert sorted(map(str, flat_got)) == sorted(map(str, flat_want)), what
        for path, w in flat_want.items():
            np.testing.assert_allclose(np.asarray(flat_got[path]), np.asarray(w),
                                       err_msg=f"{what} {jax.tree_util.keystr(path)}", **tol)


def _jax_cfg(model: str, n_model: int, float64: bool) -> jax_config.TrainConfig:
    """JAX's TrainConfig of the worker's unaugmented step of ``model``; in
    float64 its model on the standard blocks (``w2d_*`` off: JAX's folded
    Pallas kernels take no float64), the reference tests/test_folded.py
    holds the folded ones to, over the same parameter tree."""
    cfg = worker.cfg(model, n_model, 0)
    jpre = jax_config.preset(worker.PRESET[model])
    args = {k: v for k, v in cfg.model_args.items() if not (float64 and k.startswith("w2d"))}
    return jax_config.TrainConfig(
        model=model, model_args=args, loss=cfg.loss, batch_size=cfg.batch_size,
        num_epochs=1, bf16=False, seed=0, n_model_shards=n_model,
        optimizer=jax_config.OptimizerConfig(eps=worker.ADAM_EPS),
        data=dataclasses.replace(jpre.data, dataset="synthetic",
                                 synthetic_length=cfg.batch_size, image_size=worker.SIZE,
                                 augmentations_per_datapoint=0))


@pytest.mark.parametrize("model", ["large_unet", "clip_unet_prompt"])
def test_step_at_2x2_equals_jax_on_a_2x2_mesh(runs, model):
    """One unaugmented step of the JAX Trainer on ``make_mesh(n_data=2,
    n_model=2)`` with ``shard_params_tp``, from the port's initial weights;
    the prompt model's step in float64 on both sides (module doc)."""
    float64 = model == "clip_unet_prompt"
    prefix = f"noaug64/{model}/" if float64 else f"noaug/{model}/"
    loss = runs["ranks"][0]["noaug64" if float64 else "noaug"][model]
    hold_to_jax(_jax_cfg(model, 2, float64), runs["arrays"][1], prefix,
                *worker.global_batch(model), loss, LOSS_TOL, LOSS_TOL, GRAD_TOL,
                float64=float64)


def test_prompt_step_at_world_1_equals_jax_in_float64(runs):
    """The port's world-1 ``clip_unet_prompt`` step against JAX's Trainer on
    one device, both in float64: loss, gradients and the state after Adam
    at ``LOSS_TOL`` / ``GRAD_TOL`` (module doc)."""
    model = "clip_unet_prompt"
    hold_to_jax(_jax_cfg(model, 1, True), runs["arrays"][0], f"noaug64/{model}/",
                *worker.global_batch(model), runs["one"]["noaug64"][model],
                LOSS_TOL, LOSS_TOL, GRAD_TOL, float64=True, layout=(1, 1))


# ---- layouts, checkpoints, rows ---------------------------------------------

@pytest.mark.parametrize("model", ["clip_unet", "clip_unet_prompt"])
def test_mesh_shapes_agree(runs, model):
    """(4, 1), (2, 2) and (1, 4) at four ranks: the loss and the updated
    parameter norm, equal on every rank of a layout (tests/test_mesh_shapes.py)."""
    layouts = [r["layouts"] for r in runs["ranks"]]
    assert all(lay == layouts[0] for lay in layouts)
    (l1, n1), *rest = [layouts[0][f"{model}/{m}"] for m in worker.LAYOUTS]
    assert np.isfinite(l1) and np.isfinite(n1)
    for loss, norm in rest:
        np.testing.assert_allclose(loss, l1, rtol=1e-5)
        np.testing.assert_allclose(norm, n1, rtol=1e-6)


def test_the_fusion_and_the_tower_are_sharded_in_clip_unet(runs):
    plan = runs["ranks"][0]["clip_plan"]
    assert "cross_attention_fusion.cross_attn.in_proj_weight" in plan
    assert "cross_attention_fusion.cross_attn.out_proj.weight" in plan
    assert "clip_feature_extractor.clip_model.visual_projection.weight" in plan


def test_resume_at_2x2_equals_the_unbroken_run(runs):
    for arrays in runs["arrays"]:
        unbroken, resumed = _group(arrays, "unbroken/"), _group(arrays, "resumed/")
        assert sorted(unbroken) == sorted(resumed) and unbroken
        for k in unbroken:
            assert np.array_equal(unbroken[k], resumed[k]), k
    assert [r["restored_step"] for r in runs["ranks"]] == [1] * RANKS


def test_a_2x2_checkpoint_has_world_1_keys_and_restores_at_world_1(runs):
    one_dir, tp_dir = runs["dirs"]
    one = ckpt_lib.load_checkpoint_flat(str(one_dir / "ckpt1.npz"))
    tp = ckpt_lib.load_checkpoint_flat(str(tp_dir / f"ckpt{RANKS}.npz"))
    assert sorted(tp) == sorted(one)
    for k in one:
        assert tp[k].shape == one[k].shape, k
    t = Trainer(worker.cfg("large_unet", 1, 1), device="cpu", make_artifacts=False)
    t.restore(str(tp_dir / f"ckpt{RANKS}.npz"))
    assert t.step == 1
    want = _group(runs["arrays"][1], "aug/param/")
    for k, p in t.model.named_parameters():
        assert np.array_equal(p.detach().numpy(), want[k]), k


def test_model_ranks_get_their_data_rows_and_the_native_loader_refuses(runs):
    rows = [r["rows"] for r in runs["ranks"]]
    assert rows[0] == rows[1] and rows[2] == rows[3] and rows[0] != rows[2]
    assert len(rows[0]) == worker.GLOBAL_BATCH // 2
    for r in runs["ranks"]:
        assert "sub-row process layouts need native_loader=False" in r["native_loader"]


# ---- the entry points ---------------------------------------------------------

def test_train_distributed_cli_with_two_model_shards(tmp_path):
    ranks = mesh.launch("tests._torch_port_tp_worker:run_cli", 2, [str(tmp_path)],
                        timeout=300)
    assert [r["world"] for r in ranks] == [2, 2]
    assert ranks[0]["run_dir"] == ranks[1]["run_dir"] and ranks[0]["plan"]
    assert {"model_1.npz", "loss.csv", "model_settings.json"} <= set(ranks[0]["files"])
    # the checkpoint is whole: world 1 restores it
    cfg = dataclasses.replace(config.preset("smoke"), n_model_shards=1)
    t = Trainer(cfg, device="cpu", make_artifacts=False)
    t.restore(f"{ranks[0]['run_dir']}/model_1.npz")
    assert t.step > 0


def test_dryrun_multichip_eight_ranks(capsys):
    loss = dryrun_multichip(8)
    out = capsys.readouterr().out
    assert np.isfinite(loss)
    assert "mesh=(data=4, model=2)" in out and "frozen_tower=verified" in out
    assert "fusion_sharded=cross_attention_fusion.cross_attn" in out


def test_every_preset_and_option_builds_at_two_model_shards(runs):
    """What was refused at M > 1 before (the autoencoder, the ClipRes
    models, ClipAutoencoder, ``fused_deep``, ``remat``) builds at (2, 2)
    like every other preset, each with weights sharded; one rank cannot
    form a model group of 2."""
    built = [r["built"] for r in runs["ranks"]]
    assert all(b == built[0] for b in built)
    assert sorted(built[0]) == sorted([*worker.PRESETS, "unet fused_deep", "unet remat"])
    assert all(n > 0 for n in built[0].values()), built[0]
    smoke = config.preset("smoke")
    with pytest.raises(ValueError, match="model groups of 2"):  # one rank, M = 2
        Trainer(dataclasses.replace(smoke, n_model_shards=2), device="cpu",
                make_artifacts=False)
