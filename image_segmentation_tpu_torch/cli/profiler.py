"""Profile the training hot loop to a trace; counterpart of
``scripts/profiler.py``, with its flags and ``--device``,
``--dataset`` and ``--batch-size``:

    python -m image_segmentation_tpu_torch.cli.profiler --preset smoke --steps 10 \\
        --log-dir ./profile-log
    python -m image_segmentation_tpu_torch.cli.profiler --preset large_unet \\
        --dataset synthetic --batch-size 16 --steps 3

One train step runs outside the trace (warm-up: the kernels' first launch
and cuDNN's choices), then ``--steps`` steps on the first batch inside
``utils.profiling.trace`` (``torch.profiler``, a Chrome trace file in
``--log-dir``); prints ``Rate: ... datapoints/s``, the memory report and
the trace path.  The trace holds the program's spans
(``utils/spans.py``): each step's ``train_step`` range, whose argument is
its step key, and under it ``prepare``, ``augment.geometry``,
``augment.colour``, every model block's forward and ``.bwd`` (the
backward's on autograd's thread), ``loss``, ``loss.bwd`` and
``optimizer``, each with the device time of the kernels launched in it.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> str:
    """Parse ``argv`` and profile; returns the trace path."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="smoke")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--log-dir", default="./profile-log")
    ap.add_argument("--dataset", default=None, help="oxford-pet | synthetic")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    args = ap.parse_args(argv)

    import torch

    from image_segmentation_tpu_torch.config import preset
    from image_segmentation_tpu_torch.engine.train import Trainer
    from image_segmentation_tpu_torch.utils import profiling

    cfg = preset(args.preset)
    if args.dataset is not None:
        cfg.data.dataset = args.dataset
    if args.batch_size is not None:
        cfg.batch_size = args.batch_size
    trainer = Trainer(cfg, device=args.device, make_artifacts=False)
    train_pipe, _ = trainer._pipelines()
    images, masks = next(iter(train_pipe.epoch(0)))

    def sync():
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)

    float(trainer.train_step(images, masks, 0))  # warm-up, outside the trace
    meter = profiling.ThroughputMeter()
    meter.start()
    with profiling.trace(args.log_dir) as path:
        for i in range(args.steps):
            loss = trainer.train_step(images, masks, i)
        float(loss)
        sync()
    rate = meter.stop(args.steps * cfg.batch_size)
    print(f"Rate: {rate:.1f} datapoints/s")
    print(profiling.format_memory_report())
    print(f"trace -> {path}")
    return path


if __name__ == "__main__":
    main()
