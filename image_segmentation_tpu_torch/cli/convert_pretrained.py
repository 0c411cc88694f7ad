"""Convert a pretrained tower's torch state dict into a tower ``.npz``;
counterpart of ``scripts/convert_pretrained.py``, with the same arguments:

    # CLIP ViT-B/32 (transformers; a vision-only or a whole CLIPModel state dict)
    python -m image_segmentation_tpu_torch.cli.convert_pretrained clip \\
        --torch-state-dict clip_vision.pt --out clip_tower.npz

    # ResNet-34 IMAGENET1K_V1 (a torchvision state-dict file)
    python -m image_segmentation_tpu_torch.cli.convert_pretrained resnet34 \\
        --torch-state-dict resnet34.pth --out resnet34.npz

The input is a ``torch.save``'d state dict, read with ``weights_only=True``
(no pickled module code), ``torch.compile``'s ``_orig_mod.`` prefix
stripped.  The output is the JAX package's flat ``.npz``
(``utils/checkpoint.py``): ``params/...`` of the CLIP ``clip_tower``, or
``params/...`` and ``batch_stats/...`` of ``ResNet34Features``, in the
source's dtype.  ``utils.convert.state_dict_from_jax`` loads either back
into the port's tower.  Nothing is computed, so there is no ``--device``.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Parse ``argv``, convert and write; returns the written tree."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("tower", choices=["clip", "resnet34"])
    ap.add_argument("--torch-state-dict", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from image_segmentation_tpu_torch.utils import checkpoint, convert

    sd = torch.load(args.torch_state_dict, map_location="cpu", weights_only=True)
    sd = convert.strip_compile_prefix(sd)
    if args.tower == "clip":
        tree = {"params": convert.clip_tree_from_torch(sd)}
    else:
        params, stats = convert.resnet34_tree_from_torch(sd)
        tree = {"params": params, "batch_stats": stats}
    checkpoint.save_checkpoint(args.out, tree)
    n = sum(int(np.prod(np.shape(v))) for _, v in convert.leaves(tree))
    print(f"{args.tower}: {n:,} parameters -> {args.out}")
    return tree


if __name__ == "__main__":
    main()
