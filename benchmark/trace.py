"""The traced window: ``torch.profiler`` over a bounded number of steps,
reduced to what the per-layer metrics read.

Kept from the trace: every device operation (kernels, copies, sets) with
its name, start and duration; the device span of each of the benchmark's
own ranges (``RANGE_PREFIX``), put around calls into the program's layers
by :func:`ranged`; and the host op running while the device idles.
Kernels fall into the groups of the port's hand-written kernels by their
whole names (:func:`group`, after the grouping that
``scripts/profile_torch_port.py`` measured on the card).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

RANGE_PREFIX = "bench: "
SHORT_GAP_S = 5e-6

# whole kernel name (:func:`kernel_name`) -> group; the conv kernels'
# vector, narrow and deep paths (vec_kernel<LOAD, ...>, narrow_kernel<LOAD,
# ...>, deep_kernel<LOAD, ...>) give (forward, dgrad): LOAD 0 is the
# forward, 1 to 3 the dgrad
OWN_KERNELS = {
    "wgrad_vec_kernel": "conv3x3_wgrad", "wgrad_narrow_kernel": "conv3x3_wgrad (narrow)",
    "wgrad_deep_kernel": "conv3x3_wgrad (deep)", "wgrad_ge_prepass": "conv3x3_wgrad (deep)",
    "wgrad_x_prepass": "conv3x3_wgrad (deep)",
    "vec_kernel": ("conv3x3 (forward)", "conv3x3_dgrad"),
    "deep_kernel": ("conv3x3 (forward, deep)", "conv3x3_dgrad (deep)"),
    "narrow_kernel": ("conv3x3 (forward, narrow)", "conv3x3_dgrad (narrow)"),
    "conv1x1_bwd_kernel": "conv1x1_bwd", "bnred_kernel": "bn_relu_bwd_reduce",
    "pool_bwd_kernel": "maxpool2x2_affine_relu_bwd",
    "pool_bwd_narrow_kernel": "maxpool2x2_affine_relu_bwd (narrow)",
    "pool_kernel": "maxpool2x2_affine_relu", "ct_bwd_kernel": "convtranspose2x2_bwd",
    "ct_fwd_kernel": "convtranspose2x2", "sum_rows_kernel": "second pass of the sums",
    "row_shift_kernel": "row_shift / col_shift", "col_shift_kernel": "row_shift / col_shift",
    "gray_sum_kernel": "preprocess (gray sums)", "colour_blur_kernel": "preprocess (colour, blur)",
    "attn_mma_kernel": "cross_attention", "attn_kernel": "cross_attention (long context)",
}


def kernel_name(name: str) -> str:
    """A device operation's whole kernel name, without return type,
    namespaces, template arguments and parameters:
    ``void imgseg::(anonymous namespace)::sum_rows_kernel<2>(float*)`` ->
    ``sum_rows_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in "<(":
        name = name.split(stop, 1)[0]
    return name.rsplit("::", 1)[-1].strip()


def _template_head(name: str) -> str:
    """The first template argument of a kernel name, or ''."""
    if "<" not in name:
        return ""
    return name.split("<", 1)[1].split(",", 1)[0].split(">", 1)[0].strip()


def group(name: str) -> str:
    label = OWN_KERNELS.get(kernel_name(name))
    if isinstance(label, tuple):
        return label[0] if _template_head(name) == "0" else label[1]
    if label is not None:
        return label
    if any(s in name for s in ("xmma", "cudnn", "gemm", "cutlass", "conv2d", "wgrad", "dgrad")):
        return "cudnn conv/gemm"
    if "multi_tensor" in name or "foreach" in name.lower():
        return "optimizer (foreach)"
    if any(s in name for s in ("reduce", "Reduce")):
        return "reductions"
    if any(s in name for s in ("elementwise", "copy", "Copy", "Memcpy", "Memset")):
        return "elementwise/copy"
    return "other: " + name[:60]


def ranged(label: str, fn):
    """``fn`` inside a profiler range ``RANGE_PREFIX + label``."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(RANGE_PREFIX + label):
            return fn(*args, **kwargs)
    return wrapped


@dataclasses.dataclass
class Trace:
    """The reduced trace of ``steps`` steps over ``window_s`` seconds, and
    the same number of steps run just before without the profiler, whose
    host clock the profiler's own cost does not inflate."""

    steps: int
    window_s: float
    ops: List[Tuple[str, float, float]]                 # (name, start_s, duration_s)
    ranges: Dict[str, List[Tuple[float, float]]]        # device spans (start_s, end_s)
    idle_host: Dict[str, float]                         # idle device s by host op
    plain_window_s: float = 0.0                         # the untraced steps' seconds

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        busy, end = 0.0, None
        for _, start, dur in sorted(self.ops, key=lambda o: o[1]):
            stop = start + dur
            if end is None or start >= end:
                busy += dur
                end = stop
            elif stop > end:
                busy += stop - end
                end = stop
        return busy

    def kernel_seconds(self, names, second_pass=()) -> float:
        """Device seconds of the operations whose whole kernel name is in
        ``names``, and of each one named in ``second_pass`` that directly
        follows one of those on the device."""
        total, prev = 0.0, None
        for name, _, dur in sorted(self.ops, key=lambda o: o[1]):
            k = kernel_name(name)
            if k in names or (k in second_pass and prev in names):
                total += dur
            prev = k
        return total

    def in_range(self, label: str) -> float:
        """Device seconds of the operations that start inside the device
        spans of range ``label``."""
        spans = sorted(self.ranges.get(RANGE_PREFIX + label, []))
        total = 0.0
        for name, start, dur in self.ops:
            if any(a <= start < b for a, b in spans):
                total += dur
        return total

    def breakdown(self) -> dict:
        groups = defaultdict(float)
        for name, _, dur in self.ops:
            groups[group(name)] += dur
        top = sorted(groups.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(self.idle_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle]}


def _is_annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith(
        (RANGE_PREFIX, "Optimizer.", "ProfilerStep"))


@contextlib.contextmanager
def traced(device: torch.device):
    """Profile the body (device and host); yields a dict that holds the
    profiler once the body has ended."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    out = {}
    with profile(activities=acts) as prof:
        yield out
    out["prof"] = prof


def reduce_trace(prof, steps: int, window_s: float) -> Trace:
    """The profiler's events -> :class:`Trace`: device operations, range
    spans, and each idle gap on the device charged to the innermost host op
    that was running at its middle."""
    events = list(prof.events())
    dev = torch.autograd.DeviceType.CUDA
    ops, ranges = [], defaultdict(list)
    host = []
    for e in events:
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == dev:
            if _is_annotation(e):
                ranges[e.name].append((start, end))
            else:
                ops.append((e.name, start, end - start))
        else:
            host.append((start, end, e.name))
    idle = defaultdict(float)
    spans = sorted((s, s + d) for _, s, d in ops)
    gaps, last = [], None
    for s, t in spans:
        if last is not None and s > last:
            gaps.append((last, s))
        last = t if last is None else max(last, t)
    host.sort()
    starts = [h[0] for h in host]
    for a, b in gaps:
        if b - a < SHORT_GAP_S:
            idle["gaps under 5 us"] += b - a
            continue
        mid = (a + b) / 2
        label = "(no host op)"
        # the latest-starting host op that still runs at mid: the innermost
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 400, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        idle["host: " + label[:60]] += b - a
    return Trace(steps, window_s, ops, dict(ranges), dict(idle))
