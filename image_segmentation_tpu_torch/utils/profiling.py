"""Profiling, tracing and memory reports; counterpart of
``image_segmentation_tpu/utils/profiling.py`` (trace :24, device_memory_stats
:33, format_memory_report :47, ThroughputMeter :60).

- :func:`trace`: ``torch.profiler`` over the CPU and, where a card is
  present, CUDA activity, written as a Chrome trace into ``log_dir``;
- :func:`device_memory_stats`: per card, the allocator's current and peak
  bytes (``torch.cuda.memory_stats``) and the card's size
  (``torch.cuda.mem_get_info``); empty without a card;
- :func:`format_memory_report`: JAX's text over those;
- :class:`ThroughputMeter`: the per-epoch "Rate: datapoints/s".
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str = "./profile-log") -> Iterator[str]:
    """``with trace(dir) as path: run_steps()`` writes the Chrome trace
    ``path`` (``<dir>/trace-<pid>.json``) when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{os.getpid()}.json")
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def device_memory_stats() -> Dict[str, Dict]:
    """``{"cuda:i": {bytes_in_use, peak_bytes_in_use, bytes_limit}}`` for
    every card; ``{}`` on the CPU."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total,
        }
    return out


def format_memory_report() -> str:
    """Human-readable device memory report (the reference's per-epoch CUDA
    memory print, model_wrappers.py:236-243), in JAX's words."""
    lines = []
    for dev, s in device_memory_stats().items():
        gib = 1024 ** 3
        cur = (s["bytes_in_use"] or 0) / gib
        peak = (s["peak_bytes_in_use"] or 0) / gib
        lim = (s["bytes_limit"] or 0) / gib
        lines.append(f"{dev}: {cur:.2f} GiB in use (peak {peak:.2f} / {lim:.2f})")
    return "\n".join(lines) or "no device memory stats available"


class ThroughputMeter:
    """Datapoints/s per epoch (reference model_wrappers.py:182-187)."""

    def __init__(self):
        self._t0: Optional[float] = None
        self.rate = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, datapoints: int) -> float:
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self.rate = datapoints / dt if dt > 0 else 0.0
        return self.rate
