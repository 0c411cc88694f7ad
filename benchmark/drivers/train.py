"""Training: one closed loop of ``Trainer.train_step`` calls, each on the
next batch of the cell's pool with a fresh step key.

Set-up builds the program's ``Trainer`` from the configuration file, loads
the benchmark's weights (drawn on the card from the seed), makes the pool
of batches on the card, and runs the first three steps through the same
call the window makes, on three different batches: they warm every shape
up and are the steps the reference follows.  Of them it keeps each loss,
the first step's gradient as Adam took it (its first moment over 1 - b1),
the change of every trainable leaf over the three, and the first step's
model inputs (the augmented images).

The check runs once the window has closed and the program is freed: the
reference makes the same weights and batches, applies the same draws, and
takes the same three steps in float32 (blocks recomputed in the backward,
so the full batch fits), and the numbers below are compared:

- ``loss_gap``: the largest relative gap of the three losses;
- ``grad_gap``, ``change_gap``: the worst leaf's gap between the program's
  norm and the reference's, of the first gradient and of the change over
  three steps, against the larger of that leaf's and the median leaf's
  reference norm; leaves whose reference gradient is nought to rounding
  are left out (``base.NOUGHT_SHARE``); ``*_median``: the median leaf's;
- ``grad_gap_kernels``, ``grad_gap_kernels_median``: the same of the first
  gradient, over the weights whose gradient the program's hand-written
  wgrad makes alone (``reference.kernel_leaves``);
- ``input_gap``: the mean absolute gap of the first step's model inputs.

The cell's limits file names the numbers that decide ``correct``; the
rest are logged.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from .. import data, flops
from .. import plain as P
from .. import trace as T
from . import base

CHECK_STEPS = 3


class Driver:
    def __init__(self, run, ref, log=print):
        self.ref, self.log = ref, log
        self.cfg, self.traffic = run.cell.config, base.checked_traffic(run.cell.traffic)
        self.seed, self.device = run.seed, run.device
        self.batch = int(self.traffic.get("batch") or self.cfg["batch_size"])
        self.size = int(self.cfg["image_size"])
        self.spec = ref.spec(self.cfg["architecture"])
        self.names = P.trainable_names(self.spec)
        on_kernels = set(ref.kernel_leaves(self.cfg["architecture"], base.kernel_levels(self.cfg)))
        self.kernel_leaves = torch.tensor([n in on_kernels for n in self.names])
        self.failed = 0
        self.step_key = 0

    # ------------------------------------------------------------ set-up
    def describe(self) -> str:
        pool_bytes = sum(t.numel() * t.element_size() for b in self.pool for t in b)
        return (f"{self.cfg['model']} train, batch {self.batch} at {self.size}x{self.size}, "
                f"pool of {len(self.pool)} batches ({pool_bytes} bytes on the card)")

    def layers(self, batch: int):
        return self.ref.layers(self.cfg["architecture"], base.kernel_levels(self.cfg), batch,
                               self.size)

    def make_pool(self) -> None:
        self.pool = data.make_pool(int(self.traffic["pool_batches"]), self.batch, self.size,
                                   self.seed, self.device)

    def setup(self) -> None:
        from image_segmentation_tpu_torch.engine.train import Trainer

        t = [time.perf_counter()]
        self.make_pool()
        self._sync()
        t.append(time.perf_counter())
        cfg = base.train_config(self.cfg, self.seed, self.batch)
        self.trainer = Trainer(cfg, device=self.device, make_artifacts=False)
        t.append(time.perf_counter())
        self.trainer.model.load_state_dict(P.make_weights(self.spec, self.seed, self.device),
                                           strict=True)
        self._sync()
        t.append(time.perf_counter())
        self._first_steps()
        t.append(time.perf_counter())
        self.log("set-up seconds: " + ", ".join(
            f"{k} {b - a!r}" for k, a, b in zip(("pool", "Trainer", "weights", "first steps"),
                                               t, t[1:])))

    def step(self) -> torch.Tensor:
        images, masks = self.pool[self.step_key % len(self.pool)]
        loss = self.trainer.train_step(images, masks, self.step_key)
        self.step_key += 1
        return loss

    def _first_steps(self) -> None:
        tr = self.trainer
        params = dict(tr.model.named_parameters())
        leaves = [params[n] for n in self.names]
        start = [t.detach().clone() for t in leaves]
        captured = {}
        prepare = tr._prepare_batch

        def capture(*args, **kwargs):
            out = prepare(*args, **kwargs)
            captured.setdefault("inputs", out[0] if isinstance(out[0], tuple) else (out[0],))
            return out

        tr._prepare_batch = capture
        try:
            losses = []
            for k in range(CHECK_STEPS):
                losses.append(self.step())
                if k == 0:
                    self.grad_norms = self._first_moments(leaves)
        finally:
            del tr._prepare_batch
        with torch.no_grad():
            self.change_norms = torch.stack([(t - s).double().norm()
                                             for t, s in zip(leaves, start)])
        self.losses = torch.stack(losses)
        self.inputs = captured["inputs"]
        del start
        self._sync()

    def _first_moments(self, leaves) -> torch.Tensor:
        """Each leaf's gradient as Adam took it, from its state after one
        step: exp_avg = (1 - b1) * (grad + weight_decay * p)."""
        b1 = self.cfg["optimizer"]["b1"]
        state = self.trainer.optimizer.state
        out = []
        for t in leaves:
            m = state.get(t, {}).get("exp_avg")
            out.append(torch.zeros((), dtype=torch.float64, device=t.device) if m is None
                       else m.double().norm() / (1 - b1))
        return torch.stack(out)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # ------------------------------------------------------------ measuring
    def window(self, seconds: float) -> dict:
        self._sync()
        losses = []
        t0 = time.perf_counter()
        while True:
            losses.append(self.step())
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        t1 = time.perf_counter()
        self.failed = int((~torch.isfinite(torch.stack(losses))).sum())
        n = len(losses)
        return {"seconds": t1 - t0, "images": n * self.batch, "attempted": n,
                "failed": self.failed}

    def traced(self, steps: int) -> T.Trace:
        """``steps`` steps timed without the profiler, then ``steps`` more
        under it; a range around the batch preparation."""
        tr = self.trainer
        tr._prepare_batch = T.ranged("augment", tr._prepare_batch)
        self._sync()
        losses = []
        t0 = time.perf_counter()
        for _ in range(steps):
            losses.append(self.step())
        self._sync()
        plain_s = time.perf_counter() - t0
        with T.traced(self.device) as t:
            t0 = time.perf_counter()
            for _ in range(steps):
                losses.append(self.step())
            self._sync()
            t1 = time.perf_counter()
        self.failed = int((~torch.isfinite(torch.stack(losses))).sum())
        trace = T.reduce_trace(t["prof"], steps, t1 - t0)
        trace.plain_window_s = plain_s
        return trace

    def flops_per_step(self) -> float:
        return flops.model_flops(self.layers(self.batch), train=True)

    def conv3x3_bound_s(self) -> float:
        return flops.conv3x3_bound_s(self.layers(self.batch), train=True)

    # ------------------------------------------------------------ checking
    def release(self) -> None:
        """Free the program's state; keep what the check compares."""
        self.grad_norms = self.grad_norms.cpu()
        self.change_norms = self.change_norms.cpu()
        self.losses = self.losses.cpu()
        del self.trainer

    def reference(self, q: Optional[P.Precision] = None, rows: Optional[int] = None) -> dict:
        """The reference's three steps from the same weights and batches,
        computed at precision ``q`` (float32, or the control's); with
        ``rows``, on the first rows of each batch only (a fault: part of the
        batch left out, the mean taken over the rest)."""
        q = q or P.FP32
        params = P.make_weights(self.spec, self.seed, self.device)
        first = {}
        arch, cfg = self.cfg["architecture"], self.cfg

        def loss_fn(p, k):
            images, masks = self.pool[k % len(self.pool)]
            images, masks = images[:rows], masks[:rows]
            inputs, targets = self.ref.prepare(images, masks, self.seed, k, cfg, q)
            first.setdefault("inputs", tuple(t.detach() for t in inputs))
            logits = self.ref.forward(p, inputs, arch, q, train=True, checkpoint=True)
            return self.ref.loss(logits, targets)

        with P.no_tf32():
            out = P.train_steps(params, self.names, cfg["optimizer"], range(CHECK_STEPS), loss_fn)
        out["inputs"] = first["inputs"]
        return out

    def compare(self, ref: dict, prog: Optional[dict] = None) -> dict:
        """The compared numbers of the program's (or ``prog``'s) readings
        against the reference's."""
        prog = prog or {"losses": self.losses.tolist(), "grad_norms": self.grad_norms,
                        "change_norms": self.change_norms, "inputs": self.inputs}
        keep = base.kept_leaves(ref["grad_norms"])
        for what in ("grad_norms", "change_norms"):
            self.log(f"{what}, the worst leaves: " + base.worst_leaves(
                prog[what], ref[what], keep, self.names))
        gaps = [(a[:len(b)] - b[:len(a)]).abs().float().mean().item()
                for a, b in zip(prog["inputs"], ref["inputs"])]
        g, c = (prog["grad_norms"], ref["grad_norms"]), (prog["change_norms"], ref["change_norms"])
        kern = self.kernel_leaves & keep
        self.log("grad_norms, the kernels' weights: " + base.worst_leaves(
            *g, keep, self.names, n=int(kern.sum()), among=self.kernel_leaves))
        numbers = {
            "loss_gap": max(base.relative_gap(a, b) for a, b in zip(prog["losses"], ref["losses"])),
            "grad_gap": base.worst_leaf_gap(*g, keep),
            "grad_gap_median": base.median_leaf_gap(*g, keep),
            "change_gap": base.worst_leaf_gap(*c, keep),
            "change_gap_median": base.median_leaf_gap(*c, keep),
            "input_gap": max(gaps),
        }
        if bool(kern.any()):
            numbers["grad_gap_kernels"] = base.worst_leaf_gap(*g, keep, self.kernel_leaves)
            numbers["grad_gap_kernels_median"] = base.median_leaf_gap(*g, keep, self.kernel_leaves)
        return numbers

    def check(self) -> dict:
        ref = self.reference()
        numbers = self.compare(ref)
        self.log(f"program losses {self.losses.tolist()}; reference {ref['losses']}; "
                 f"leaves {len(self.names)}, kept {int(base.kept_leaves(ref['grad_norms']).sum())}")
        return numbers
