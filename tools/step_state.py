#!/usr/bin/env python3
"""One world-1 training step of the PyTorch port, written to a file for
comparing two trees' steps bit for bit.

    python3 tools/step_state.py OUT.npz [--tree DIR]   # needs a CUDA card
    python3 tools/step_state.py --compare A.npz B.npz

The step is ``chip_smoke.py``'s: ``train_config()`` (the large_unet preset,
batch 16 at 512x512, bf16), a fixed batch drawn from ``SEED + 7`` and
``STEP_KEY``, from the seeded weights; its loss and every step-0 gradient
go to OUT.  ``--tree DIR`` runs the ``image_segmentation_tpu_torch`` of
another checkout (an earlier commit unpacked with ``git archive`` into
``build/parent``, say); the step's settings always come from this
checkout's ``chip_smoke.py``.  ``--compare`` prints the largest difference
and exits 1 if the two files differ.
"""

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def step_state(out: str) -> None:
    import importlib.util

    import torch

    from image_segmentation_tpu_torch.engine.train import Trainer

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer = Trainer(smoke.train_config(), device="cuda", make_artifacts=False)
    rng = np.random.default_rng(smoke.SEED + 7)
    b, s = smoke.BATCH, smoke.SIZE
    images = torch.from_numpy(rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)).cuda()
    masks = torch.from_numpy(rng.integers(0, smoke.NUM_CLASSES, (b, s, s), dtype=np.uint8)).cuda()
    loss = trainer.train_step(images, masks, smoke.STEP_KEY)
    arrays = {"loss": loss.float().cpu().numpy()}
    arrays.update({f"grad/{k}": v.cpu().numpy() for k, v in smoke._grads(trainer.model).items()})
    np.savez(out, **arrays)
    print(f"card: {smoke.card_line()}; step state: loss {float(loss)!r}, {len(arrays) - 1} "
          f"gradients -> {out}", flush=True)


def compare(a: str, b: str) -> bool:
    za, zb = np.load(a), np.load(b)
    same = sorted(za.files) == sorted(zb.files)
    worst = 0.0
    for k in za.files:
        if k in zb.files:
            same &= bool(np.array_equal(za[k], zb[k]))
            worst = max(worst, float(np.max(np.abs(za[k] - zb[k]))))
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
