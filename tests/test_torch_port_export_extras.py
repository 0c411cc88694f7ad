"""The port's export extras and profiling (engine/export.py
``torch_format`` / ``export_program`` / ``load_program``, the
``imgseg::`` operators of ops/fused_conv.py, cli/export_torch.py,
utils/profiling.py, cli/profiler.py) against the JAX package on the CPU.

Parameter trees are drawn from a numpy seed in the shapes the JAX modules
declare (tests/test_torch_port_clip.py ``jax_variables``, its small CLIP
tower at proj_dim 512, as the converter tests use it).

Tolerances, each with its reason:

- ``model_torch.pt`` and the ``export_torch`` files: bit for bit (both
  packages write the same fp32 values under the same keys);
- the exported program against JAX's StableHLO module: rtol 2e-4, atol
  2e-4, the port's forward tolerance (tests/test_torch_port_slice.py).
  The JAX module is the standard LargeUNet's (the folded variants share
  its tree and equal it, tests/test_folded.py); the port's program is the
  preset model, whose kernels are operators in the graph;
- the program against the eager forward it was made from: bit for bit
  (the operators call the same wrappers).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_segmentation_tpu.engine import export as jax_export
from image_segmentation_tpu.models import clip_models as jax_models
from image_segmentation_tpu.models.unet import LargeUNet as JaxLargeUNet
from image_segmentation_tpu.models.unet import UNet as JaxUNet
from image_segmentation_tpu.utils import profiling as jax_profiling
from image_segmentation_tpu_torch import config
from image_segmentation_tpu_torch.cli import export_torch, profiler
from image_segmentation_tpu_torch.engine import export
from image_segmentation_tpu_torch.models.registry import build_model
from image_segmentation_tpu_torch.ops import fused_conv
from image_segmentation_tpu_torch.utils import convert, profiling
from tests.test_torch_port_clip import CLIP_KW, jax_variables

jax.config.update("jax_default_matmul_precision", "highest")
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
SMALL = dict(stem_features=8, encoder_features=(16, 32, 64, 128))
TOWER = dict(CLIP_KW, proj_dim=512)
X32 = jnp.zeros((1, 32, 32, 3))
JAX_MODELS = {
    "unet": (lambda: JaxUNet(dtype=jnp.float32, stem_features=8, encoder_features=(16, 32)),
             dict(stem_features=8, encoder_features=(16, 32))),
    "large_unet": (lambda: JaxLargeUNet(dtype=jnp.float32, **SMALL), SMALL),
    "clip_unet": (lambda: jax_models.ClipUnet(dtype=jnp.float32, clip_kwargs=TOWER),
                  dict(clip_kwargs=TOWER)),
    "clip_res": (lambda: jax_models.ClipResSegmentationModel(dtype=jnp.float32,
                                                             clip_kwargs=TOWER),
                 dict(clip_kwargs=TOWER)),
    "clip_autoencoder": (lambda: jax_models.ClipAutoencoder(dtype=jnp.float32, clip_kwargs=TOWER),
                         dict(clip_kwargs=TOWER)),
    "clip_unet_prompt": (lambda: jax_models.ClipUnetPrompt(dtype=jnp.float32, clip_kwargs=TOWER),
                         dict(clip_kwargs=TOWER)),
}


def _port_model(name, params, stats, args):
    model = build_model(name, device="cpu", dtype=torch.float32, **args)
    model.load_state_dict(convert.state_dict_from_jax(params, stats), strict=True)
    return model.eval()


def _variables(name, seed=3):
    inputs = (X32, jnp.zeros((1, 32, 32, 1))) if name == "clip_unet_prompt" else (X32,)
    v = jax_variables(JAX_MODELS[name][0](), *inputs, seed=seed)
    return v["params"], v["batch_stats"]


@pytest.mark.parametrize("name", sorted(JAX_MODELS))
def test_torch_format_equals_jax(name, tmp_path):
    params, stats = _variables(name)
    args = JAX_MODELS[name][1]
    export.export_model(_port_model(name, params, stats, args), name, args,
                        out_dir=str(tmp_path / "port"), torch_format=True)
    jax_export.export_model({"params": params, "batch_stats": stats}, name, args,
                            out_dir=str(tmp_path / "jax"), torch_format=True)
    got = torch.load(tmp_path / "port" / "model_torch.pt")
    want = torch.load(tmp_path / "jax" / "model_torch.pt")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", ["autoencoder", "clip_res_class", "prompt_fusion"])
def test_torch_format_refuses_what_jax_refuses(name, tmp_path):
    model = build_model("unet", device="cpu", dtype=torch.float32, stem_features=4,
                        encoder_features=(8,))
    with pytest.raises(ValueError, match="torch_format supports"):
        export.export_model(model, name, out_dir=str(tmp_path), torch_format=True)
    with pytest.raises(ValueError, match="torch_format supports"):
        jax_export.export_model({"params": {}, "batch_stats": {}}, name,
                                out_dir=str(tmp_path / "jax"), torch_format=True)


def test_cli_export_torch_equals_the_jax_script(tmp_path, monkeypatch):
    params, stats = _variables("large_unet", seed=5)
    ckpt = str(tmp_path / "model_1.npz")
    convert.write_flat_npz(ckpt, {"params": params, "batch_stats": stats})
    export_torch.main(["--ckpt", ckpt, "--model", "large_unet", "--out",
                       str(tmp_path / "port.pt")])
    from scripts import export_torch as jax_script

    monkeypatch.setattr(sys, "argv", ["export_torch", "--ckpt", ckpt, "--model", "large_unet",
                                      "--out", str(tmp_path / "jax.pt")])
    jax_script.main()
    got, want = torch.load(tmp_path / "port.pt"), torch.load(tmp_path / "jax.pt")
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(SystemExit):
        export_torch.main(["--ckpt", ckpt, "--model", "autoencoder", "--out", "x.pt"])


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    """The preset LargeUNet at narrow widths exported with
    ``exported_program=True``; JAX's standard LargeUNet on the same tree as
    a StableHLO module."""
    tmp = tmp_path_factory.mktemp("program")
    params, stats = _variables("large_unet", seed=7)
    args = {**config.preset("large_unet").model_args, **SMALL}
    model = _port_model("large_unet", params, stats, args)
    export.export_model(model, "large_unet", args, out_dir=str(tmp / "port"),
                        exported_program=True, image_size=32)
    jax_export.export_stablehlo(JaxLargeUNet(dtype=jnp.float32, **SMALL),
                                {"params": params, "batch_stats": stats},
                                str(tmp / "model.stablehlo"), image_size=32)
    return dict(model=model, fn=export.load_program(str(tmp / "port" / "model.pt2")),
                jax_fn=jax_export.load_stablehlo(str(tmp / "model.stablehlo")))


def test_exported_program_holds_the_imgseg_operators(program):
    targets = [str(n.target) for n in program["fn"].program.graph.nodes]
    for op in ("imgseg.conv3x3", "imgseg.maxpool2x2_affine_relu", "imgseg.convtranspose2x2"):
        assert any(t.startswith(op) for t in targets), op
    assert sum(t.startswith("imgseg.conv3x3") for t in targets) == 8  # levels 0-1, 2 a block


@pytest.mark.parametrize("batch", [1, 3])
def test_exported_program_equals_jax_stablehlo(program, batch):
    x = np.random.default_rng(batch).random((batch, 32, 32, 3), np.float32)
    got = program["fn"](torch.from_numpy(x))
    want = np.asarray(program["jax_fn"](jnp.asarray(x)))
    assert got.shape == want.shape == (batch, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    with torch.no_grad():
        assert torch.equal(got, program["model"](torch.from_numpy(x), train=False))


def test_operators_equal_their_wrappers_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    x, xb = torch.randn(2, 8, 8, 4, generator=g), torch.randn(2, 8, 8, 3, generator=g)
    w, b = torch.randn(5, 7, 3, 3, generator=g), torch.randn(5, generator=g)
    a1, b1 = torch.rand(4, generator=g) + 0.5, torch.randn(4, generator=g)
    assert torch.equal(torch.ops.imgseg.conv3x3(x, w, b, xb, None, None),
                       fused_conv.conv3x3(x, w, b, x_b=xb))
    w2 = torch.randn(5, 4, 3, 3, generator=g)
    assert torch.equal(torch.ops.imgseg.conv3x3(x, w2, b, None, a1, b1),
                       fused_conv.conv3x3(x, w2, b, a=a1, b=b1))
    assert torch.equal(torch.ops.imgseg.maxpool2x2_affine_relu(x, a1, b1),
                       fused_conv.maxpool2x2_affine_relu(x, a1, b1))
    wt, bt = torch.randn(4, 6, 2, 2, generator=g), torch.randn(6, generator=g)
    assert torch.equal(torch.ops.imgseg.convtranspose2x2(x, wt, bt),
                       fused_conv.convtranspose2x2(x, wt, bt))


# ---- profiling --------------------------------------------------------------

def test_memory_report_on_the_cpu_equals_jax():
    assert profiling.device_memory_stats() == {}
    assert profiling.format_memory_report() == jax_profiling.format_memory_report()


def test_throughput_meter(monkeypatch):
    """Datapoints over the seconds between start and stop, as JAX's."""
    clock = iter([10.0, 12.5, 10.0, 12.5])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    monkeypatch.setattr(jax_profiling.time, "perf_counter", lambda: next(clock))
    for meter in (profiling.ThroughputMeter(), jax_profiling.ThroughputMeter()):
        assert meter.rate == 0.0
        meter.start()
        assert meter.stop(100) == meter.rate == 40.0


def test_cli_profiler_writes_a_trace(tmp_path, capsys):
    path = profiler.main(["--preset", "smoke", "--steps", "1", "--device", "cpu",
                          "--log-dir", str(tmp_path / "prof")])
    out = capsys.readouterr().out
    assert os.path.exists(path) and os.path.getsize(path) > 0
    assert "Rate:" in out and "datapoints/s" in out and f"trace -> {path}" in out
    assert "no device memory stats available" in out
