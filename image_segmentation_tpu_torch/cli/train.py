"""Training entry point; counterpart of ``scripts/train.py``, with the
same flags and ``--device``:

    python -m image_segmentation_tpu_torch.cli.train --preset unet --epochs 200
    python -m image_segmentation_tpu_torch.cli.train --preset smoke --dataset synthetic \\
        --device cpu
    python -m image_segmentation_tpu_torch.cli.train --preset large_unet \\
        --dataset synthetic --resume saved-models/LargeUNet/run-001/model_1.npz
    python -m image_segmentation_tpu_torch.cli.train --preset large_unet \\
        --dataset oxford-pet --dataset-loc Data/Oxford-IIIT-Pet-Augmented --native-loader

Writes the run folder ``<save-dir>/<ModelName>/run-NNN/`` (``loss.csv``,
``model_settings.json``, ``model_<epoch>.npz``), as the JAX script does.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Parse ``argv``, train, print the last epoch; returns the Trainer."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="unet",
                    help="unet | large_unet | clip_unet | clip_res | "
                         "clip_autoencoder | autoencoder | segment_classifier | prompt | smoke")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--dataset", default=None, help="oxford-pet | synthetic")
    ap.add_argument("--dataset-loc", default=None,
                    help="the Oxford-IIIT-Pet folder: <split>_arrays.npz files, or a dataset "
                         "directory that HF datasets reads")
    ap.add_argument("--native-loader", action="store_true",
                    help="assemble the train batches with the C++ loader (runtime/loader.cpp)")
    ap.add_argument("--save-dir", default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--resume", default=None, help="checkpoint .npz to resume from")
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    args = ap.parse_args(argv)

    from image_segmentation_tpu_torch.config import preset
    from image_segmentation_tpu_torch.engine.train import Trainer

    cfg = preset(args.preset)
    if args.epochs is not None:
        cfg.num_epochs = args.epochs
    if args.batch_size is not None:
        cfg.batch_size = args.batch_size
    if args.dataset is not None:
        cfg.data.dataset = args.dataset
    if args.dataset_loc is not None:
        cfg.data.dataset_loc = args.dataset_loc
    if args.native_loader:
        cfg.native_loader = True
    if args.save_dir is not None:
        cfg.save_dir = args.save_dir
    if args.seed is not None:
        cfg.seed = args.seed

    trainer = Trainer(cfg, device=args.device)
    if args.resume:
        trainer.restore(args.resume)
    out = trainer.train()
    last = out["history"][-1]
    print(f"done: epoch={last['epoch']} train_loss={last['train_loss']:.4f} "
          f"val_iou={last['val_iou']:.4f} rate={last['rate']:.1f} datapoints/s "
          f"run_dir={trainer.run_dir}")
    return trainer


if __name__ == "__main__":
    main()
