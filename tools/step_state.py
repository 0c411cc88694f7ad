#!/usr/bin/env python3
"""One world-1 training step of the PyTorch port, written to a file for
comparing two trees' steps bit for bit.

    python3 tools/step_state.py OUT.npz [--tree DIR]   # needs a CUDA card
    python3 tools/step_state.py --compare A.npz B.npz

The step is ``chip_smoke.py``'s: ``train_config()`` (the large_unet preset,
batch 16 at 512x512, bf16), a fixed batch drawn from ``SEED + 7`` and
``STEP_KEY``, from the seeded weights; its loss and every step-0 gradient
go to OUT, beside the world-1 step at batch 8 of each run of
``chip_smoke.py``'s tensor-parallel phase (``TP_RUNS``: large_unet,
clip_unet, the autoencoder, clip_res, segment_classifier,
clip_autoencoder, unet with ``fused_deep`` and ``remat``) and of the
``prompt`` preset, each on its fixed batch (``tp_batch``), keyed
``<run>/loss`` and ``<run>/grad/...``.  ``--tree DIR`` runs the
``image_segmentation_tpu_torch`` of another checkout (an earlier commit
unpacked with ``git archive`` into ``build/parent``, say); the step's
settings always come from this checkout's ``chip_smoke.py``.
``--compare`` prints, per step, whether it is bit for bit the other
file's and its largest leaf difference, and exits 1 if the two files
differ.
"""

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _step(smoke, cfg, images, masks, prefix: str) -> dict:
    """One step of a fresh Trainer of ``cfg`` on the card: its loss and
    step-0 gradients under ``prefix``."""
    import torch

    from image_segmentation_tpu_torch.engine.train import Trainer

    trainer = Trainer(cfg, device="cuda", make_artifacts=False)
    loss = trainer.train_step(torch.from_numpy(images).cuda(), torch.from_numpy(masks).cuda(),
                              smoke.STEP_KEY)
    arrays = {f"{prefix}loss": loss.float().cpu().numpy()}
    arrays.update({f"{prefix}grad/{k}": v.cpu().numpy()
                   for k, v in smoke._grads(trainer.model).items()})
    print(f"step state {prefix or cfg.model}: loss {float(loss)!r}, {len(arrays) - 1} "
          "gradients", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return arrays


def step_state(out: str) -> None:
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(smoke.SEED + 7)
    b, s = smoke.BATCH, smoke.SIZE
    images = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    masks = rng.integers(0, smoke.NUM_CLASSES, (b, s, s), dtype=np.uint8)
    arrays = _step(smoke, smoke.train_config(), images, masks, "")
    for name in (*smoke.TP_RUNS, "prompt"):
        cfg = smoke._tp_config(name, 1)
        arrays.update(_step(smoke, cfg, *smoke.tp_batch(name, cfg.data.image_size),
                            f"{name}/"))
    np.savez(out, **arrays)
    print(f"card: {smoke.card_line()}; step state: {len(arrays)} arrays -> {out}", flush=True)


def compare(a: str, b: str) -> bool:
    """Whether two dumps are bit-identical; prints, per step (the
    large_unet step, then each ``<run>/``), whether it is, its largest
    leaf difference, and how many of its arrays moved, naming those that
    did not."""
    za, zb = np.load(a), np.load(b)
    same = sorted(za.files) == sorted(zb.files)
    worst, steps, kept = 0.0, {}, {}
    for k in za.files:
        if k in zb.files:
            equal = bool(np.array_equal(za[k], zb[k]))
            diff = float(np.max(np.abs(za[k] - zb[k])))
            step = k.split("/")[0] + "/" if "/" in k.split("grad/")[0] else "large_unet"
            eq, big, leaf = steps.get(step, (True, 0.0, ""))
            steps[step] = (eq and equal, max(big, diff), k if diff > big else leaf)
            kept.setdefault(step, []).append((k, equal))
            same &= equal
            worst = max(worst, diff)
    for step, (eq, big, leaf) in steps.items():
        moved = [k for k, equal in kept[step] if not equal]
        unmoved = [k.split("grad/")[-1] for k, equal in kept[step] if equal]
        print(f"  {step}: bit-identical {eq}" + ("" if eq else f", largest |difference| {big!r} "
                                                 f"at {leaf}; {len(moved)} of {len(kept[step])} "
                                                 f"arrays moved, unmoved: {unmoved}"), flush=True)
    print(f"step states {a} and {b}: bit-identical {same}, largest |difference| {worst!r} "
          f"({len(za.files)} arrays)", flush=True)
    return same


def main(args) -> int:
    if args[:1] == ["--compare"]:
        return 0 if compare(args[1], args[2]) else 1
    tree = Path(args[args.index("--tree") + 1]).resolve() if "--tree" in args else ROOT
    sys.path.insert(0, str(tree))
    step_state(args[0])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
