#!/usr/bin/env python3
"""Where the peak memory of a tensor-parallel train step goes, against
world 1, from the CUDA caching allocator's recorded history.

    python3 tools/tp_memory.py [--run clip_res] [--out results/tp_memory]   # one card

The run is one of ``chip_smoke.py``'s tensor-parallel runs (``TP_RUNS``),
on its fixed batch (``tp_batch``): world 1 in this process, then
``TP_RANKS`` gloo ranks at (data=1, model=TP_RANKS) on the same card, as
the smoke's tensor-parallel phase runs them.  Each side records the
allocator's history (Python stacks) from before its Trainer is built,
takes one step, then a second after ``empty_cache`` and
``reset_peak_memory_stats``, and writes ``torch.cuda.memory._snapshot()``
to ``<out>/<side>.pickle``.  It prints for each side the second step's
peak (``max_memory_allocated``) and the state the step starts from
(parameters by part, the frozen tower's bf16 copy, gradients, Adam's
moments), and, from the history, the bytes alive at the second step's
peak grouped by the innermost frame of the port that allocated them;
then the groups whose bytes differ most between world 1 and rank 0.
"""

import argparse
import json
import os
import pickle
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "image_segmentation_tpu_torch/"
MAX_ENTRIES = 2_000_000


def _site(frames: list) -> str:
    """The innermost frame in the port's package (with the innermost frame
    of all, where that is another), else the innermost frame."""
    if not frames:
        return "(no stack)"
    inner = f"{Path(frames[0]['filename']).name}:{frames[0]['name']}"
    for f in frames:
        if PACKAGE in f["filename"]:
            site = f"{f['filename'].split(PACKAGE)[-1]}:{f['line']} {f['name']}"
            return site if f is frames[0] else f"{site} <- {inner}"
    return inner


def live_at_peak(snapshot: dict, start: int) -> tuple:
    """Replay the device's trace: the largest total of live allocations at
    or after event ``start``, and the live bytes then, by ``_site``."""
    live, total, peak, at_peak = {}, 0, -1, {}
    for i, e in enumerate(snapshot["device_traces"][0]):
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], _site(e.get("frames", [])))
            total += e["size"]
            if i >= start and total > peak:
                peak, at_peak = total, dict(live)
        elif e["action"] in ("free_requested", "free_completed"):
            size = live.pop(e["addr"], (0, None))[0]
            total -= size
    groups = {}
    for size, site in at_peak.values():
        groups[site] = groups.get(site, 0) + size
    return peak, groups


def _state_bytes(trainer) -> dict:
    """The bytes of the state a step starts from, by part."""
    from image_segmentation_tpu_torch.utils.convert import CLIP, RESNET

    parts = {"parameters: CLIP tower": 0, "parameters: ResNet-34": 0, "parameters: the rest": 0}
    for k, p in trainer.model.named_parameters():
        part = ("CLIP tower" if k.startswith(CLIP) else "ResNet-34" if k.startswith(RESNET)
                else "the rest")
        parts[f"parameters: {part}"] += p.numel() * p.element_size()
    fe = getattr(trainer.model, "clip_feature_extractor", None)
    cast = getattr(fe, "_cast", {}).get("tower")
    parts["the tower's bf16 copy (compute_tower)"] = 0 if cast is None else sum(
        p.numel() * p.element_size() for p in cast.parameters())
    parts["gradients"] = sum(p.grad.numel() * p.grad.element_size()
                             for p in trainer.model.parameters() if p.grad is not None)
    parts["Adam moments"] = sum(t.numel() * t.element_size() for s in
                                trainer.optimizer.state.values() for t in s.values()
                                if hasattr(t, "is_cuda") and t.is_cuda)
    return parts


def side(run: str, n_model: int, out: str, tag: str) -> dict:
    """Two steps of ``run`` at ``n_model`` shards with the history recorded;
    the second step's peak, the state's bytes and the live bytes at the
    peak by site."""
    import torch

    import chip_smoke as smoke
    from image_segmentation_tpu_torch.engine.train import Trainer
    from image_segmentation_tpu_torch.parallel import mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke._tp_config(run, n_model)
    images, masks = (torch.from_numpy(a) for a in smoke.tp_batch(run, cfg.data.image_size))
    torch.cuda.memory._record_memory_history(max_entries=MAX_ENTRIES, stacks="python")
    trainer = Trainer(cfg, device="cuda", make_artifacts=False)
    rows = mesh.rows(smoke.TP_BATCH) if mesh.active() else slice(None)
    mine = images[rows].cuda(), masks[rows].cuda()
    trainer.train_step(*mine, smoke.STEP_KEY)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = len(torch.cuda.memory._snapshot()["device_traces"][0])
    state = _state_bytes(trainer)
    trainer.train_step(*mine, smoke.STEP_KEY + 1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    snapshot = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    replay, groups = live_at_peak(snapshot, start)
    if not mesh.active() or mesh.rank() == 0:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"{tag}.pickle"), "wb") as f:
            pickle.dump(snapshot, f)
    del trainer, snapshot
    torch.cuda.empty_cache()
    return {"peak": peak, "replay_peak": replay, "state": state, "groups": groups,
            "trace_events": start}


def _rank(run: str, out: str) -> dict:
    """One gloo rank of the tensor-parallel side (``mesh.launch``)."""
    import chip_smoke as smoke

    return side(run, smoke.TP_RANKS, out, f"{run}_tp_rank0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--run", default="clip_res")
    ap.add_argument("--out", default="results/tp_memory")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from image_segmentation_tpu_torch.parallel import mesh

    print(f"card: {smoke.card_line()}", flush=True)
    one = side(args.run, 1, args.out, f"{args.run}_world1")
    tp = mesh.launch("tools.tp_memory:_rank", smoke.TP_RANKS, [args.run, args.out],
                     backend="gloo", timeout=900)
    sides = {"world 1": one, **{f"rank {r}": t for r, t in enumerate(tp)}}
    gb = 1e-9
    for name, s in sides.items():
        print(f"{args.run} {name}: second step's peak {s['peak'] * gb!r} GB "
              f"(replayed {s['replay_peak'] * gb!r}); state "
              + ", ".join(f"{k} {v * gb!r}" for k, v in s["state"].items()), flush=True)
        top = sorted(s["groups"].items(), key=lambda kv: -kv[1])[:12]
        for site, b in top:
            print(f"  {name} at the peak: {b * gb!r} GB  {site}")
    keys = set(one["groups"]) | set(tp[0]["groups"])
    diff = sorted(((one["groups"].get(k, 0) - tp[0]["groups"].get(k, 0), k) for k in keys),
                  key=lambda d: -abs(d[0]))
    total = one["replay_peak"] - tp[0]["replay_peak"]
    print(f"{args.run}: world 1 minus rank 0 at the peak {total * gb!r} GB; by site:")
    for d, k in diff[:15]:
        print(f"  {d * gb!r} GB  {k}")
    with open(os.path.join(args.out, f"{args.run}_summary.json"), "w") as f:
        json.dump(sides, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
