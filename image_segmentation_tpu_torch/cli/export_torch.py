"""Export a training checkpoint as a torch state dict in the REFERENCE's
key layout; counterpart of ``scripts/export_torch.py``, with its flags:

    python -m image_segmentation_tpu_torch.cli.export_torch \\
        --ckpt saved-models/LargeUNet/run-001/model_200.npz --model large_unet \\
        --out large_unet_state_dict.pt

The checkpoint is the JAX ``.npz`` layout that both packages write; its
``params`` and ``batch_stats`` become the reference-layout state dict
through ``utils/convert.state_dict_from_jax`` (the port's own layout, held
equal to JAX's ``utils/torch_export.EXPORTERS`` by the tests), written as
JAX's script writes it.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> str:
    """Parse ``argv`` and write the state dict; returns the output path."""
    from image_segmentation_tpu_torch.engine.export import TORCH_FORMAT_MODELS

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True, help="model_<epoch>.npz checkpoint")
    ap.add_argument("--model", required=True, help=" | ".join(TORCH_FORMAT_MODELS))
    ap.add_argument("--out", required=True, help="output .pt path")
    args = ap.parse_args(argv)

    import torch

    from image_segmentation_tpu_torch.utils import convert

    if args.model not in TORCH_FORMAT_MODELS:
        ap.error(f"--model must be one of {sorted(TORCH_FORMAT_MODELS)}")
    tree = convert.read_flat_npz(args.ckpt)
    sd = convert.state_dict_from_jax(tree["params"], tree.get("batch_stats", {}))
    torch.save({k: v.contiguous() for k, v in sd.items()}, args.out)
    print(f"wrote {len(sd)} tensors to {args.out}")
    return args.out


if __name__ == "__main__":
    main()
