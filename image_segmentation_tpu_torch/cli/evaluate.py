"""Evaluation and robustness entry point; counterpart of
``scripts/evaluate.py``, with the same flags and ``--device``:

    python -m image_segmentation_tpu_torch.cli.evaluate --preset clip_unet \\
        --ckpt run-001/model_200.npz --robustness   # float battery -> augmentation-results/
    python -m image_segmentation_tpu_torch.cli.evaluate --preset clip_unet --ckpt ... \\
        --robustness-int           # integer grid -> results/robustness_scores.csv
    python -m image_segmentation_tpu_torch.cli.evaluate --preset clip_unet --ckpt ... --plot

The checkpoint (either package's) is restored into a Trainer of the
preset, and the ``Evaluator`` runs its model over the test split.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    """Parse ``argv`` and evaluate; returns the clean metrics."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="clip_unet")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--split", default="test",
                    help="the Oxford-IIIT-Pet split (the synthetic data has one evaluation split)")
    ap.add_argument("--dataset-loc", default=None, help="the Oxford-IIIT-Pet folder")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--robustness", action="store_true",
                    help="float-space battery -> augmentation-results/*.csv")
    ap.add_argument("--robustness-int", action="store_true",
                    help="integer-space grid -> results/robustness_scores.csv")
    ap.add_argument("--plot", action="store_true",
                    help="save a 4-sample prediction overlay grid (needs matplotlib)")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from image_segmentation_tpu_torch.config import preset
    from image_segmentation_tpu_torch.engine.evaluate import Evaluator
    from image_segmentation_tpu_torch.engine.train import Trainer, _dataset_from_config
    from image_segmentation_tpu_torch.utils import plotting

    if args.plot:
        plotting.require_matplotlib()
    cfg = preset(args.preset)
    if args.dataset is not None:
        cfg.data.dataset = args.dataset
    if args.dataset_loc is not None:
        cfg.data.dataset_loc = args.dataset_loc
    trainer = Trainer(cfg, device=args.device, make_artifacts=False)
    trainer.restore(args.ckpt)
    test_data = _dataset_from_config(cfg, False, split=args.split)

    ev = Evaluator(trainer.model, test_data, batch_size=args.batch_size,
                   binary=cfg.loss == "hybrid_binary", device=args.device)
    clean = ev.test()
    print("clean:", clean)
    if args.robustness:
        ev.test_robustness(os.path.join(args.out_dir, "augmentation-results"))
        print("float battery -> augmentation-results/")
    if args.robustness_int:
        csv_path = os.path.join(args.out_dir, "results/robustness_scores.csv")
        ev.robustness_evaluation(csv_path)
        print(f"integer battery -> {csv_path}")
    if args.plot:
        idx = np.random.default_rng(0).choice(len(test_data), 4, replace=False)
        images = test_data.images[idx].astype(np.float32) / 255.0
        with torch.no_grad():
            logits = trainer.model(torch.from_numpy(images).to(args.device), train=False)
        path = plotting.plot_segmentations(
            images, logits.float().cpu().numpy(),
            save_path=os.path.join(args.out_dir, "results/predictions.png"))
        print(f"prediction overlays -> {path}")
    return clean


if __name__ == "__main__":
    main()
