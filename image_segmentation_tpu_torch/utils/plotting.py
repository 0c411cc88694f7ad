"""Visualization helpers; counterpart of
``image_segmentation_tpu/utils/plotting.py`` (plot_segmentations :34,
plot_loss_curves :76, plot_robustness_scores :103,
plot_perturbation_examples :135, plot_autoencoder_pairs :159), the
reference's helperFunctions.py:210-266, scripts/plot_*.py and the grid of
scripts/test_prompt_data.py (:55-74, :func:`plot_prompt_check`).  It takes
numpy arrays (``tensor.cpu().numpy()``).  matplotlib is imported inside
the functions, with the Agg backend: importing this module needs none, and
a call without matplotlib raises an ``ImportError`` that says so.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

CLASS_LABELS = ("Background", "Cat", "Dog")
CLASS_COLORS = {
    0: (0, 0, 0),      # background (transparent)
    1: (0, 0, 255),    # cat (blue)
    2: (0, 255, 0),    # dog (green)
}


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not installed here") from e

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def require_matplotlib() -> None:
    """Raise the ``ImportError`` of :func:`_plt` now, before a caller's
    work, when matplotlib is not installed."""
    _plt()


def logits_to_class_map(logits_nhwc: np.ndarray) -> np.ndarray:
    """(N,H,W,C) logits -> (N,H,W) argmax class ids (helperFunctions.py:228)."""
    return np.argmax(np.asarray(logits_nhwc), axis=-1)


def plot_segmentations(
    images: np.ndarray,
    predictions: np.ndarray,
    class_colors: Optional[Dict[int, tuple]] = None,
    alpha: float = 0.5,
    n_cols: int = 4,
    save_path: Optional[str] = None,
):
    """Blended class-colour overlay grid (helperFunctions.py:210-266).

    images: (N,H,W,3) in [0,1]; predictions: (N,H,W) class ids or
    (N,H,W,C) logits.
    """
    plt = _plt()
    images = np.asarray(images)
    predictions = np.asarray(predictions)
    if predictions.ndim == 4:
        predictions = logits_to_class_map(predictions)
    colors = class_colors or CLASS_COLORS

    n = len(images)
    n_rows = (n + n_cols - 1) // n_cols
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(n_cols * 4, n_rows * 4))
    axes = np.atleast_1d(axes).flatten()
    for i, (img, pred) in enumerate(zip(images, predictions)):
        overlay = np.zeros_like(img)
        for cls, color in colors.items():
            overlay[pred == cls] = np.array(color) / 255.0
        blended = (1 - alpha) * img + alpha * overlay
        axes[i].imshow(np.clip(blended, 0, 1))
        axes[i].axis("off")
    for j in range(n, len(axes)):
        axes[j].axis("off")
    plt.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return save_path
    return fig


def plot_loss_curves(loss_csv: str, save_path: Optional[str] = None):
    """Train/val loss curve from loss.csv (scripts/plot_train_val_loss.py)."""
    import csv

    plt = _plt()
    epochs, train, val = [], [], []
    with open(loss_csv) as f:
        reader = csv.DictReader(f)
        for row in reader:
            epochs.append(float(row["Epoch"]))
            train.append(float(row["Train Loss"]))
            val.append(float(row["Validation Loss"]))
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(epochs, train, label="Train Loss")
    ax.plot(epochs, val, label="Validation Loss")
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Loss")
    ax.legend()
    fig.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return save_path
    return fig


def plot_robustness_scores(
    results_csv: str, out_dir: str = "results/plots"
) -> Sequence[str]:
    """One Dice-vs-param PNG per perturbation type
    (scripts/plot_robustness_evaluation.py)."""
    import csv
    from collections import defaultdict

    plt = _plt()
    series = defaultdict(list)
    with open(results_csv) as f:
        for row in csv.DictReader(f):
            series[row["perturbation_type"]].append(
                (float(row["param_value"]), float(row["mean_dice"]))
            )
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, pts in series.items():
        xs, ys = zip(*pts)
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(xs, ys, marker="o")
        ax.set_title(name)
        ax.set_xlabel("parameter")
        ax.set_ylabel("mean Dice")
        fig.tight_layout()
        path = os.path.join(out_dir, f"{name}.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        paths.append(path)
    return paths


def plot_perturbation_examples(
    clean_u8: np.ndarray, perturbed_u8: np.ndarray, save_path: Optional[str] = None
):
    """Side-by-side original/perturbed grid (scripts/plot_perturbations.py)."""
    plt = _plt()
    n = len(clean_u8)
    fig, axes = plt.subplots(2, n, figsize=(4 * n, 8))
    axes = np.atleast_2d(axes)
    for i in range(n):
        axes[0, i].imshow(clean_u8[i])
        axes[0, i].set_title("original")
        axes[0, i].axis("off")
        axes[1, i].imshow(perturbed_u8[i])
        axes[1, i].set_title("perturbed")
        axes[1, i].axis("off")
    fig.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return save_path
    return fig


def plot_autoencoder_pairs(
    inputs: np.ndarray, reconstructions: np.ndarray, save_path: Optional[str] = None
):
    """Input/reconstruction pairs (scripts/plot_autoencoder.py)."""
    return plot_perturbation_examples(
        np.asarray(inputs), np.asarray(reconstructions), save_path
    )


def plot_prompt_check(images_u8: np.ndarray, heat: np.ndarray, labels: np.ndarray,
                      save_path: str) -> str:
    """One row per sample: the image, its prompt heatmap and its label mask
    (scripts/test_prompt_data.py :55-74)."""
    plt = _plt()
    n = len(images_u8)
    fig, axes = plt.subplots(n, 3, figsize=(9, 3 * n))
    axes = np.atleast_2d(axes)
    for i in range(n):
        axes[i, 0].imshow(images_u8[i])
        axes[i, 0].set_title("image")
        axes[i, 1].imshow(heat[i], cmap="hot")
        axes[i, 1].set_title("prompt heatmap")
        axes[i, 2].imshow(labels[i], cmap="gray")
        axes[i, 2].set_title("label mask")
        for ax in axes[i]:
            ax.axis("off")
    fig.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=100)
    plt.close(fig)
    return save_path
