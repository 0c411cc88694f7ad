"""Plotting entry point; counterpart of ``scripts/plot_results.py``, with
the same subcommands and ``--device``:

    python -m image_segmentation_tpu_torch.cli.plot_results loss \\
        saved-models/UNet/run-001/loss.csv
    python -m image_segmentation_tpu_torch.cli.plot_results robustness \\
        results/robustness_scores.csv
    python -m image_segmentation_tpu_torch.cli.plot_results perturbations \\
        --name gaussian_noise --param 10

Needs matplotlib.  Every subcommand takes ``--device`` (default
``cuda``); only ``perturbations`` computes on it.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Parse ``argv`` and plot; returns the written paths."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", default="cuda", help="cuda (default) | cpu")

    p_loss = sub.add_parser("loss", parents=[device])
    p_loss.add_argument("csv")
    p_loss.add_argument("--out", default="results/plots/loss.png")

    p_rob = sub.add_parser("robustness", parents=[device])
    p_rob.add_argument("csv")
    p_rob.add_argument("--out-dir", default="results/plots")

    p_pert = sub.add_parser("perturbations", parents=[device])
    p_pert.add_argument("--name", default="gaussian_noise")
    p_pert.add_argument("--param", type=float, default=10.0)
    p_pert.add_argument("--out", default="results/plots/perturbation.png")

    args = ap.parse_args(argv)

    from image_segmentation_tpu_torch.utils import plotting

    if args.cmd == "loss":
        paths = [plotting.plot_loss_curves(args.csv, args.out)]
    elif args.cmd == "robustness":
        paths = list(plotting.plot_robustness_scores(args.csv, args.out_dir))
    else:
        import torch

        from image_segmentation_tpu_torch.data import perturbations as pert
        from image_segmentation_tpu_torch.data.datasets import synthetic_dataset

        plotting.require_matplotlib()
        clean = torch.from_numpy(synthetic_dataset(length=4, seed=0).images).to(args.device)
        out = pert.apply_perturbation(args.name, clean, args.param)
        paths = [plotting.plot_perturbation_examples(clean.cpu().numpy(), out.cpu().numpy(),
                                                     args.out)]
    for p in paths:
        print(p)
    return paths


if __name__ == "__main__":
    main()
