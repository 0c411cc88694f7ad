"""Data- and tensor-parallel training entry point; counterpart of
``scripts/train_distributed.py``, with its flags and ``--device``,
``--dataset``, ``--batch-size``, ``--image-size`` and
``--synthetic-length``.

One process per rank, each in the process group of ``parallel.mesh``:
launched by torchrun, which sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
and ``MASTER_PORT``, or with the explicit flags, one process per rank::

    torchrun --nproc-per-node 4 -m image_segmentation_tpu_torch.cli.train_distributed \\
        --preset large_unet --epochs 2
    python -m image_segmentation_tpu_torch.cli.train_distributed --preset unet \\
        --coordinator host0:29500 --num-processes 2 --process-id 0   # on each host

The backend is ``nccl`` with a card (each rank takes the card
``LOCAL_RANK``), ``gloo`` on the CPU (``--device cpu``).  NCCL runs one rank
per card.  Each rank trains on its rows of every global batch, the
gradients averaged and the BatchNorm statistics taken over the global batch
(``engine/train.py``); rank 0 writes the run folder.  ``--model-shards M``
(tensor parallelism, the config's ``n_model_shards``; any preset) lays
the ranks out as ``(data=R/M, model=M)``: the M ranks of a data row share
its rows and each holds 1/M of the output channels of every large weight,
frozen ones included (``parallel/tensor.py``); R must divide by M and the
batch by R/M.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Parse ``argv``, join the process group, train; returns the Trainer."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="unet")
    ap.add_argument("--epochs", type=int, default=2)  # the reference trains 2
    ap.add_argument("--model-shards", type=int, default=1,
                    help="tensor-parallel shards M: ranks per model group, any preset "
                         "(default 1)")
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group even as one process")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="rendezvous address (implies --multihost)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--dataset", default=None, help="oxford-pet | synthetic")
    ap.add_argument("--batch-size", type=int, default=None, help="the global batch")
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--synthetic-length", type=int, default=None)
    ap.add_argument("--save-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    args = ap.parse_args(argv)

    if args.coordinator and (args.num_processes is None or args.process_id is None):
        ap.error("--coordinator requires --num-processes and --process-id")

    from image_segmentation_tpu_torch.config import preset
    from image_segmentation_tpu_torch.engine.train import Trainer
    from image_segmentation_tpu_torch.parallel import mesh

    mesh.distributed_init(force=args.multihost or args.coordinator is not None,
                          coordinator_address=args.coordinator,
                          num_processes=args.num_processes, process_id=args.process_id,
                          backend=None if args.device == "cuda" else "gloo")
    cfg = preset(args.preset)
    cfg.num_epochs = args.epochs
    for field, value in (("dataset", args.dataset), ("image_size", args.image_size),
                         ("synthetic_length", args.synthetic_length)):
        if value is not None:
            setattr(cfg.data, field, value)
    if args.batch_size is not None:
        cfg.batch_size = args.batch_size
    if args.save_dir is not None:
        cfg.save_dir = args.save_dir
    cfg.n_model_shards = args.model_shards
    trainer = Trainer(cfg, device=args.device)
    out = trainer.train(verbose=True)
    last = out["history"][-1]
    if mesh.is_main():
        print(f"done: world={mesh.world_size()} model_shards={args.model_shards} "
              f"epochs={args.epochs} "
              f"val_iou={last['val_iou']:.4f}", flush=True)
    return trainer


if __name__ == "__main__":
    main()
