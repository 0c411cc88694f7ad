"""Nothing in the benchmark loads JAX or the JAX package, judged by whole
top-level module names (``image_segmentation_tpu_torch`` begins with
``image_segmentation_tpu``), and the references load nothing of the
program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness as H

PROGRAM = "image_segmentation_tpu_torch"


def imported_top_levels(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_whole_names_are_compared():
    assert H.forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                                "image_segmentation_tpu", "image_segmentation_tpu.ops"]) == [
        "flax.linen", "image_segmentation_tpu", "image_segmentation_tpu.ops", "jax",
        "jax.numpy", "jaxlib.xla_client"]
    assert H.forbidden_modules([PROGRAM, f"{PROGRAM}.ops.fused_conv", "jaxtyping",
                                "image_segmentation_tpu_x", "benchmark.harness"]) == []


def test_no_file_imports_jax_or_the_jax_package():
    for path in sorted(H.BENCH.rglob("*.py")):
        found = imported_top_levels(path) & set(H.FORBIDDEN)
        assert not found, f"{path} imports {found}"


def test_the_references_import_nothing_of_the_program():
    plain_files = [H.BENCH / "plain.py", H.BENCH / "flops.py",
                   *sorted((H.BENCH / "reference").glob("*.py"))]
    for path in plain_files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level:
                # relative imports stay inside the plain files
                assert node.module in (None, "plain", "flops"), (path, node.module)
        assert PROGRAM not in imported_top_levels(path), path


@pytest.mark.parametrize("name", [w["name"] for w in H.load_json(H.ROOT / "BENCHMARK.json")[
    "workloads"]])
def test_a_run_loads_no_jax(name):
    """A whole small run in a fresh interpreter (no test configuration,
    which loads JAX for the other tests), then the harness's own look."""
    code = ("from benchmark.tests.small import small_cell\n"
            "from benchmark import harness as H\n"
            f"H.run_cell(small_cell({name!r}), 5, 0.2, True, 'cpu', t_start=0.0,"
            " log=lambda m: None)\n"
            "print(H.forbidden_modules())\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=H.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_a_card():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "large_unet.train", "--seed", "1", "--seconds", "1"],
                         cwd=H.ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
