"""Entry points of the port; the twin of the repository's
``__graft_entry__.py`` (entry :55, dryrun_multichip :72).

- :func:`entry` — the ClipUnet eval forward (reference CLIP_models.py:63-134)
  and example inputs, on the card unless the caller asks for the CPU;
- :func:`dryrun_multichip` — ``n`` ranks on the CPU, one process each in a
  gloo process group, each training ONE ClipUnet step with a small CLIP
  tower (uint8 batch -> augmentation -> forward -> loss -> backward ->
  gradients averaged over the data axis -> Adam) on the grid
  ``(data=n/2, model=2)`` for an even ``n >= 4``, as
  ``__graft_entry__.py:83-86`` builds its mesh (else ``(data=n, model=1)``);
  it asserts a finite loss, equal on every rank, the cross-attention
  fusion's weights sharded over the model axis (with M = 2), and a frozen
  tower bit-identical after the step.
"""

from __future__ import annotations

import math

import torch

# the small tower of __graft_entry__.py:94-112
SMALL_TOWER = dict(hidden=32, layers=1, heads=2, mlp_dim=64, patch=32, proj_dim=512)


def entry(device="cuda"):
    """``(forward, (model, images))``: ``forward(model, images)`` is the
    eval forward of a ClipUnet (full tower, weights from seed 0) on a
    batch of 4 zero 256x256 images."""
    from .engine.train import init_weights_
    from .models.registry import build_model

    model = build_model("clip_unet", device=device, dtype=torch.float32, out_channels=3)
    init_weights_(model, torch.Generator().manual_seed(0))
    model.eval()
    images = torch.zeros((4, 256, 256, 3), device=device)

    @torch.no_grad()
    def forward(model, images):
        return model(images, train=False)

    return forward, (model, images)


def model_shards(n_devices: int) -> int:
    """The model axis of the dryrun's grid (``__graft_entry__.py:83``)."""
    return 2 if n_devices % 2 == 0 and n_devices >= 4 else 1


def _dryrun_rank(n_ranks: int) -> dict:
    """One rank of :func:`dryrun_multichip`: its rows of the first global
    batch, one train step, the checks."""
    from .config import DataConfig, TrainConfig
    from .engine.train import Trainer
    from .parallel import mesh

    n_model = model_shards(n_ranks)
    n_data = n_ranks // n_model
    cfg = TrainConfig(
        model="clip_unet", model_args={"clip_kwargs": SMALL_TOWER},
        batch_size=2 * n_data, num_epochs=1, n_model_shards=n_model,
        data=DataConfig(dataset="synthetic", synthetic_length=2 * n_data, image_size=32,
                        augmentations_per_datapoint=1))
    trainer = Trainer(cfg, device="cpu", make_artifacts=False)
    fusion = [k for k in trainer.tp_plan if k.startswith("cross_attention_fusion.")]
    if n_model > 1 and not fusion:
        raise AssertionError("expected tensor-sharded cross-attention weights, got none")
    tower = {k: v.clone() for k, v in trainer.model.state_dict().items()
             if k.startswith("clip_feature_extractor.")}
    train_pipe, _ = trainer._pipelines()
    images, masks = next(iter(train_pipe.epoch(0)))
    loss = float(trainer.train_step(images, masks, 0))
    if not math.isfinite(loss):
        raise AssertionError(f"rank {mesh.rank()}: non-finite loss {loss}")
    losses = [v[0] for v in mesh.all_gather_floats([loss])]
    if len(set(losses)) != 1:
        raise AssertionError(f"the ranks' losses differ: {losses}")
    after = trainer.model.state_dict()
    for k, v in tower.items():
        if not torch.equal(v, after[k]):
            raise AssertionError(f"frozen CLIP parameter changed: {k}")
    return {"rank": mesh.rank(), "rows": int(images.shape[0]), "loss": loss,
            "fusion_sharded": fusion}


def dryrun_multichip(n_devices: int) -> float:
    """``n_devices`` gloo ranks on the CPU, one ClipUnet train step each
    (see the module doc); prints a line and returns the loss."""
    from .parallel import mesh

    results = mesh.launch("image_segmentation_tpu_torch.entry:_dryrun_rank", n_devices,
                          [n_devices])
    loss = results[0]["loss"]
    n_model = model_shards(n_devices)
    sharded = ",".join(results[0]["fusion_sharded"]) or "none"
    print(f"dryrun_multichip({n_devices}): ok, model=ClipUnet, ranks={n_devices} (gloo), "
          f"mesh=(data={n_devices // n_model}, model={n_model}), rows per rank="
          f"{results[0]['rows']}, loss={loss:.4f}, fusion_sharded={sharded}, "
          "frozen_tower=verified", flush=True)
    return loss
