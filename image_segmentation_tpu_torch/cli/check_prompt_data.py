"""Check of the prompt path on four samples; counterpart of
``scripts/test_prompt_data.py``, with the same flags and ``--device``,
``--seed`` and ``--no-plot``:

    python -m image_segmentation_tpu_torch.cli.check_prompt_data \\
        --out results/plots/prompt_check.png

It prints the shapes and, for each sample, the heatmap's peak and the
label there, asserts that the label at the peak is 1.0, and writes the
grid of image, heatmap and label (matplotlib; ``--no-plot`` skips it where
matplotlib is not installed).  The prompts are ``data.prompts
.make_prompt_batch``'s, in its two halves: the points from the draws of a
``torch.Generator`` seeded with ``--seed`` on ``--device``
(``prompt_points``), then the maps (``prompt_maps``, in :func:`check`,
which a caller can give other points, JAX's among them).
"""

from __future__ import annotations

import argparse

N = 4


def check(images_u8, raw_masks_u8, choice, cy, cx, sigma=10.0, out=None) -> dict:
    """The heatmaps and labels of the points ``(choice, cy, cx)`` of the
    palette masks ``raw_masks_u8`` (a tensor, on the device the maps are
    made on): prints the script's lines, asserts the label check, and
    with ``out`` writes the grid.  Returns ``{"heat", "label"}`` (numpy,
    ``(n, H, W)``) and the printed ``"lines"``."""
    import numpy as np

    from image_segmentation_tpu_torch.data.prompts import prompt_maps

    heat, label = prompt_maps(raw_masks_u8, choice, cy, cx, sigma)
    heat, label = heat[..., 0].cpu().numpy(), label.cpu().numpy()
    lines = [f"image: {np.shape(images_u8)} prompt: {heat.shape} label: {label.shape}"]
    print(lines[0])
    for i in range(len(heat)):
        py, px = np.unravel_index(np.argmax(heat[i]), heat[i].shape)
        lines.append(f"sample {i}: prompt peak at ({py},{px}); "
                     f"label at peak = {label[i, py, px]} (must be 1.0)")
        print(lines[-1])
        assert label[i, py, px] == 1.0, lines[-1]
    if out is not None:
        from image_segmentation_tpu_torch.utils.plotting import plot_prompt_check

        plot_prompt_check(np.asarray(images_u8), heat, label, out)
        lines.append(f"saved {out}")
        print(lines[-1])
    return {"heat": heat, "label": label, "lines": lines}


def main(argv=None):
    """Parse ``argv`` and check; returns :func:`check`'s result."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="results/plots/prompt_check.png")
    ap.add_argument("--sigma", type=float, default=10.0)
    ap.add_argument("--dataset", default="synthetic", choices=["synthetic", "pet"])
    ap.add_argument("--dataset-loc", default="Data/Oxford-IIIT-Pet-Augmented")
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-plot", action="store_true", help="print and check only")
    args = ap.parse_args(argv)

    import torch

    from image_segmentation_tpu_torch.data.datasets import load_pet_dataset, synthetic_dataset
    from image_segmentation_tpu_torch.data.prompts import prompt_points, sample_prompt_draws
    from image_segmentation_tpu_torch.utils import plotting

    if not args.no_plot:
        plotting.require_matplotlib()
    if args.dataset == "synthetic":
        ds = synthetic_dataset(length=N, keep_raw_masks=True)
    else:
        ds = load_pet_dataset(split="validation", dataset_loc=args.dataset_loc,
                              keep_raw_masks=True)
    raw = torch.from_numpy(ds.raw_masks[:N]).to(args.device)
    generator = torch.Generator(device=args.device).manual_seed(args.seed)
    points = prompt_points(raw, sample_prompt_draws(N, generator))
    return check(ds.images[:N], raw, *points, args.sigma, None if args.no_plot else args.out)


if __name__ == "__main__":
    main()
