"""The whole step's share of the chip's bf16 peak: the model FLOPs of the
steps (a training step: forward, weight and input gradients; a serving
call: the eval forward; ``driver.flops_per_step``, from
``benchmark/flops.py``) that a traced run times without the profiler just
before its profiled ones, over their host-clock seconds, over 989 TFLOP/s,
in percent.  Read for every ``mfu.<mode>`` metric."""

from benchmark.flops import BF16_FLOP_PER_S


def read(run):
    t = run.trace
    if t is None or t.plain_window_s <= 0:
        return None
    return 100.0 * run.driver.flops_per_step() * t.steps / t.plain_window_s / BF16_FLOP_PER_S
