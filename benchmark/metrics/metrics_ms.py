"""Device milliseconds a step of the evaluation's loss and metrics
(``metrics``: the loss, IoU, pixel accuracy and Dice), from the program's
spans (``benchmark/span_time.py``); nothing where none ran.  Read for
every ``metrics_ms.<mode>`` metric."""

from benchmark import span_time as S


def read(run):
    t = run.trace
    if t is None:
        return None
    return S.per_step_ms(t, S.phase(t, "metrics"))
