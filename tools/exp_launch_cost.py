#!/usr/bin/env python3
"""Whether a cooperative kernel launch makes the host's later kernel launches
dearer, on one NVIDIA GPU.

    python3 tools/exp_launch_cost.py [--ops 2000] [--reps 7]

K3 (``bn_relu_bwd_reduce``) and the pool backward are cooperative launches
(``cudaLaunchCooperativeKernel``); every other kernel of the port, and
every PyTorch op, is an ordinary launch.  In one process this times the
host's cost of an ordinary launch (``--ops`` in-place adds on a one-element
CUDA tensor, a host clock with no synchronise, the median of ``--reps``
rounds) at three points: first; after an ordinary launch of one of the
port's kernels (the pool forward); after a cooperative one (K3).  One JSON
line: the three medians in µs an op, the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def host_us(torch, x, ops: int, reps: int) -> float:
    """Median host µs of one ``x.add_(1)`` over ``reps`` rounds of ``ops``."""
    rounds = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ops):
            x.add_(1)
        rounds.append((time.perf_counter() - t0) / ops * 1e6)
    torch.cuda.synchronize()
    return statistics.median(rounds)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ops", type=int, default=2000)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    import torch

    import chip_smoke as smoke
    from image_segmentation_tpu_torch.ops import fused_conv as fc

    if not torch.cuda.is_available():
        raise SystemExit("exp_launch_cost: no CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    z = torch.randn((2, 64, 64, 64), generator=g, device="cuda").to(torch.bfloat16)
    a = torch.rand(64, generator=g, device="cuda") + 0.5
    b = torch.rand(64, generator=g, device="cuda") - 0.5
    x = torch.zeros(1, device="cuda")
    row = {"card": smoke.card_line(), "ops": args.ops, "reps": args.reps}
    row["first_us"] = host_us(torch, x, args.ops, args.reps)
    fc.maxpool2x2_affine_relu(z, a, b)  # an ordinary launch of the port's library
    torch.cuda.synchronize()
    row["after_ordinary_us"] = host_us(torch, x, args.ops, args.reps)
    fc.bn_relu_bwd_reduce(z, z, a, b)  # a cooperative launch
    torch.cuda.synchronize()
    row["after_cooperative_us"] = host_us(torch, x, args.ops, args.reps)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
