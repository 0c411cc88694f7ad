"""Validation: one closed loop of ``Trainer.eval_step`` calls, the step of
the program's validation pass (``Trainer.evaluate``), at the
configuration's batch, each on the next batch of the cell's pool.

Set-up builds the program's ``Trainer`` from the configuration file, makes
the pool of batches on the card (the validation pipeline hands
``eval_step`` device batches), loads the benchmark's weights (drawn on the
card from the seed) with BatchNorm running statistics that the reference
sets from the first rows of the pool's first batch (a model that has seen
data, not one whose running statistics are 0 and 1), and calls each batch
twice.  The device's memory peak is counted from after that reference
forward: it is the benchmark's, not the program's.

A forward hook keeps the logits that the model returns inside
``eval_step`` on a sample of the calls drawn from the seed (the first call
of a window and about one in ``SAMPLE_EVERY`` after it, at most
``SAMPLE_CAP``): a reference to the tensor, with no copy and no device
work.  Once the window has closed and the program is freed, the reference
computes the logits of the pool's batches in float32, in blocks of rows,
and each sampled call's served classes (the argmax of its logits) are
compared with those of its batch:

- ``mask_gap``: the widest gap by which the reference's logit of a pixel's
  served class lies below the reference's best, over the reference
  logits' standard deviation;
- ``mask_mismatch``: the share of pixels whose served class is not the
  reference's best.

``loss_gap``, the relative gap of the loss ``eval_step`` returned on a
sampled call to the reference's cross-entropy of its batch, is logged.
"""

from __future__ import annotations

import random
import time
from typing import Optional

import torch

from .. import data, flops
from .. import plain as P
from .. import trace as T
from . import base

CALIBRATION_ROWS = 16
REFERENCE_ROWS = 16
SAMPLE_EVERY = 16
SAMPLE_CAP = 16


class Driver:
    def __init__(self, run, ref, log=print):
        self.ref, self.log = ref, log
        self.cfg, self.traffic = run.cell.config, base.checked_traffic(run.cell.traffic)
        self.seed, self.device = run.seed, run.device
        self.batch = int(self.traffic.get("batch") or self.cfg["batch_size"])
        self.size = int(self.cfg["image_size"])
        self.spec = ref.spec(self.cfg["architecture"])
        self.failed = 0
        self.calls = 0
        self.sampler = random.Random(self.seed)
        self.take = False
        self.kept = []        # (pool index, logits, loss) of the sampled calls

    def describe(self) -> str:
        pool_bytes = sum(t.numel() * t.element_size() for b in self.pool for t in b)
        return (f"{self.cfg['model']} eval, batch {self.batch} at {self.size}x{self.size}, "
                f"pool of {len(self.pool)} batches ({pool_bytes} bytes on the card)")

    def layers(self, batch: int):
        return self.ref.layers(self.cfg["architecture"], base.kernel_levels(self.cfg), batch,
                               self.size)

    def weights(self) -> dict:
        """The seed's weights with running statistics set by the reference
        from the first rows of the pool's first batch (made once)."""
        w = P.make_weights(self.spec, self.seed, self.device)
        if not hasattr(self, "running"):
            stats = {}
            images = self.pool[0][0][:CALIBRATION_ROWS].float() / 255.0
            with torch.no_grad(), P.no_tf32():
                self.ref.forward(w, (images,), self.cfg["architecture"], train=True, stats=stats)
            self.running = {k: (m.clone(), v.clone()) for k, (m, v) in stats.items()}
        for name, (mean, var) in self.running.items():
            w[name + ".running_mean"], w[name + ".running_var"] = mean, var
        return w

    def make_pool(self) -> None:
        self.pool = data.make_pool(int(self.traffic["pool_batches"]), self.batch, self.size,
                                   self.seed, self.device)

    def setup(self) -> None:
        from image_segmentation_tpu_torch.engine.train import Trainer

        t = [time.perf_counter()]
        self.make_pool()
        weights = self.weights()
        self._sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t.append(time.perf_counter())
        cfg = base.train_config(self.cfg, self.seed, self.batch)
        self.trainer = Trainer(cfg, device=self.device, make_artifacts=False)
        t.append(time.perf_counter())
        self.trainer.model.load_state_dict(weights, strict=True)
        del weights
        self.trainer.model.register_forward_hook(self._keep)
        self._sync()
        t.append(time.perf_counter())
        for _ in range(2):
            for i in range(len(self.pool)):
                self.trainer.eval_step(*self.pool[i])
        self._sync()
        t.append(time.perf_counter())
        self.log("set-up seconds: " + ", ".join(
            f"{k} {b - a!r}" for k, a, b in zip(
                ("pool and running statistics", "Trainer", "weights", "warm calls"), t, t[1:])))

    def _keep(self, module, args, out) -> None:
        if self.take:
            self.kept.append((self.calls % len(self.pool), out))

    def call(self, first: bool = False):
        self.take = len(self.kept) < SAMPLE_CAP and (
            first or self.sampler.randrange(SAMPLE_EVERY) == 0)
        i = self.calls % len(self.pool)
        out = self.trainer.eval_step(*self.pool[i])
        if self.take:
            self.kept[-1] += (out[0],)
        self.take = False
        self.calls += 1
        return out[0]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # ------------------------------------------------------------ measuring
    def _failed(self, losses) -> int:
        return int((~torch.isfinite(torch.stack(losses))).sum())

    def window(self, seconds: float) -> dict:
        self._sync()
        losses = []
        t0 = time.perf_counter()
        while True:
            losses.append(self.call(first=not losses))
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        t1 = time.perf_counter()
        self.failed = self._failed(losses)
        n = len(losses)
        return {"seconds": t1 - t0, "images": n * self.batch, "attempted": n,
                "failed": self.failed}

    def traced(self, steps: int) -> T.Trace:
        """``steps`` calls timed without the profiler, then ``steps`` more
        under it."""
        self._sync()
        losses = []
        t0 = time.perf_counter()
        for _ in range(steps):
            losses.append(self.call(first=not losses))
        self._sync()
        plain_s = time.perf_counter() - t0
        with T.traced(self.device) as t:
            t0 = time.perf_counter()
            for _ in range(steps):
                losses.append(self.call())
            self._sync()
            t1 = time.perf_counter()
        self.failed = self._failed(losses)
        trace = T.reduce_trace(t["prof"], steps, t1 - t0)
        trace.plain_window_s = plain_s
        return trace

    def flops_per_step(self) -> float:
        return flops.model_flops(self.layers(self.batch), train=False)

    def conv3x3_bound_s(self) -> float:
        return flops.conv3x3_bound_s(self.layers(self.batch), train=False)

    # ------------------------------------------------------------ checking
    def release(self) -> None:
        """Free the program's state; keep each sampled call's served
        classes and loss."""
        self.kept = [(i, logits.argmax(-1).to(torch.uint8), float(loss))
                     for i, logits, loss in self.kept]
        del self.trainer

    def reference_logits(self, i: int, q: Optional[P.Precision] = None) -> torch.Tensor:
        """The reference's eval logits (n, h, w, classes) of pool batch i,
        in blocks of rows."""
        q = q or P.FP32
        w = self.weights()
        images = self.pool[i % len(self.pool)][0]
        out = []
        with torch.no_grad(), P.no_tf32():
            for r in range(0, images.shape[0], REFERENCE_ROWS):
                x = q(images[r:r + REFERENCE_ROWS].float() / 255.0)
                out.append(self.ref.forward(w, (x,), self.cfg["architecture"], q, train=False))
        return torch.cat(out)

    def reference_all(self, q: Optional[P.Precision] = None) -> list:
        return [self.reference_logits(i, q) for i in range(len(self.pool))]

    @staticmethod
    def gaps(masks: torch.Tensor, ref: torch.Tensor) -> dict:
        """The widest gap and the mismatch share of served classes
        ``masks`` (n, h, w) against reference logits ``ref``."""
        best = ref.amax(-1)
        served = ref.gather(-1, masks.to(ref.device).long()[..., None])[..., 0]
        return {"mask_gap": float((best - served).amax() / ref.std()),
                "mask_mismatch": float((ref.argmax(-1) != masks.to(ref.device).long())
                                       .float().mean())}

    def compare(self, refs: list, samples=None) -> dict:
        """The worst numbers over the sampled calls (or ``samples``: (pool
        index, served classes) pairs), each against the reference logits
        of its batch; none sampled reads NaN."""
        samples = samples if samples is not None else [(i, m) for i, m, _ in self.kept]
        worst = {"mask_gap": 0.0, "mask_mismatch": 0.0} if samples else {}
        for i, masks in samples:
            for k, v in self.gaps(masks, refs[i]).items():
                worst[k] = max(worst[k], v)
        return worst

    def check(self) -> dict:
        refs = self.reference_all()
        numbers = self.compare(refs)
        gaps = [base.relative_gap(loss, float(self.ref.loss(refs[i], self.pool[i][1])))
                for i, _, loss in self.kept]
        self.log(f"checked {len(self.kept)} sampled calls of {self.calls}; loss_gap "
                 f"{max(gaps, default=float('nan'))!r}")
        return numbers
