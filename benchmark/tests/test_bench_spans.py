"""The readers of the program's spans (``benchmark/span_time.py`` and the
``*_ms`` metrics that use it) on hand-built traces: which operations each
counts, each once, the division by the steps, and nothing where the
program's spans never ran."""

from __future__ import annotations

import pytest

from benchmark import harness as H
from benchmark.trace import Trace

P = "imgseg: "
STEPS = 2
NEW = ("kernel_levels_ms", "deep_levels_ms", "loss_ms", "optimizer_ms", "augment_colour_ms",
       "metrics_ms", "prepare_ms", "unspanned_ms")


def read(metric: str, trace, cell: str = "large_unet.train"):
    reader = H.load_module(H.metric_file(H.BENCH, metric), "test_" + metric.replace(".", "_"))
    return reader.read(H.Run(H.Cell.find(cell), 0, "cpu", trace=trace))


def step_trace() -> Trace:
    """Two training steps of 10 s each on a made-up clock: every span of
    the program and the ranges others open inside them, and one operation
    of 1 ms at each whole second and half second from 0 to 19.5 s."""
    ranges = {}
    for k in range(STEPS):
        t = 10.0 * k

        def at(name, a, b):
            ranges.setdefault(name, []).append((t + a, t + b))

        at("bench: augment", 0.0, 0.6)               # the training cell's range: copies, blend
        at(P + "augment.geometry", 0.5, 1.0)
        at(P + "augment.colour", 1.0, 2.0)
        at(P + "model.input", 2.0, 2.5)               # levels 0-1
        at(P + "model.enc1", 2.5, 3.0)
        at(P + "model.enc3", 3.0, 4.0)                # deep
        at(P + "model.enc3", 3.5, 4.5)                # overlapping: counted once
        at(P + "model.bottleneck", 4.5, 5.0)
        at(P + "model.out", 5.0, 5.5)
        at(P + "loss", 5.5, 6.0)
        at(P + "loss.bwd", 6.0, 6.5)
        at(P + "model.out.bwd", 6.5, 7.0)
        at(P + "model.enc3.bwd", 7.0, 8.0)
        at(P + "model.input.bwd", 8.0, 8.5)
        at("Optimizer.step#Adam.step", 9.0, 9.5)      # torch's, inside "optimizer"
        at("Optimizer.zero_grad#Adam.zero_grad", 9.5, 9.6)
    ops = [("k", s / 2, 1e-3) for s in range(40)]     # 0, 0.5, ..., 19.5 s
    return Trace(STEPS, 20.0, ops, ranges, {})


def ms(*seconds_of_one_step: float) -> float:
    """The ms a step of the 1 ms operations that start at these seconds of
    each step."""
    return float(len(seconds_of_one_step))


def test_each_reader_counts_its_spans_once_a_step():
    t = step_trace()
    # kernel levels 0-1: input [2, 2.5), enc1 [2.5, 3), out [5, 5.5),
    # out.bwd [6.5, 7), input.bwd [8, 8.5)
    assert read("kernel_levels_ms.train", t) == pytest.approx(ms(2.0, 2.5, 5.0, 6.5, 8.0))
    # deep: enc3 [3, 4.5) once, bottleneck [4.5, 5), enc3.bwd [7, 8)
    assert read("deep_levels_ms.train", t) == pytest.approx(ms(3.0, 3.5, 4.0, 4.5, 7.0, 7.5))
    assert read("loss_ms.train", t) == pytest.approx(ms(5.5, 6.0))
    assert read("optimizer_ms.train", t) == pytest.approx(ms(9.0))
    assert read("augment_colour_ms.train", t) == pytest.approx(ms(1.0, 1.5))
    assert read("prepare_ms.train", t) == pytest.approx(ms(0.0, 0.5, 1.0, 1.5))
    assert read("unspanned_ms.train", t) == pytest.approx(ms(8.5, 9.5))


def test_the_readers_partition_the_device_time():
    """Levels, loss, optimizer, preparation and the rest sum to every
    operation's time, each counted once."""
    t = step_trace()
    parts = ("kernel_levels_ms", "deep_levels_ms", "loss_ms", "optimizer_ms", "prepare_ms",
             "unspanned_ms")
    total = sum(read(m + ".train", t) for m in parts)
    assert total == pytest.approx(1e3 * sum(d for _, _, d in t.ops) / t.steps)


def test_the_steps_divide():
    t = step_trace()
    one = read("deep_levels_ms.train", t)
    t.steps = 4
    assert read("deep_levels_ms.train", t) == pytest.approx(one / 2)


@pytest.mark.parametrize("metric", NEW)
def test_nothing_where_the_programs_spans_never_ran(metric):
    """No trace, a trace without ranges (the CPU), and one with only the
    ranges of torch and the benchmark (a program without spans): None."""
    cell = "large_unet.eval" if metric == "metrics_ms" else "large_unet.train"
    others = {k: v for k, v in step_trace().ranges.items() if not k.startswith(P)}
    assert read(f"{metric}.x", None, cell) is None
    for ranges in ({}, others):
        t = Trace(STEPS, 20.0, [("k", 1.0, 1e-3)], ranges, {})
        assert read(f"{metric}.x", t, cell) is None


def test_an_eval_step_reads_its_metrics_phase():
    t = Trace(1, 1.0, [("k", s / 10, 1e-4) for s in range(10)],
              {P + "model.enc1": [(0.0, 0.3)], P + "model.enc4": [(0.3, 0.6)],
               P + "metrics": [(0.6, 0.8)], P + "prepare": [(0.8, 0.9)]}, {})
    cell = "large_unet.eval"
    assert read("metrics_ms.eval", t, cell) == pytest.approx(0.2)
    assert read("kernel_levels_ms.eval", t, cell) == pytest.approx(0.3)
    assert read("deep_levels_ms.eval", t, cell) == pytest.approx(0.3)
    assert read("prepare_ms.eval", t, cell) == pytest.approx(0.1)
    assert read("unspanned_ms.eval", t, cell) == pytest.approx(0.1)
