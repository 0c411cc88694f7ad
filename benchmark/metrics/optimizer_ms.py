"""Device milliseconds a step of the optimizer phase (``optimizer``: the
zero-fill of missing gradients, their average over ranks and Adam, whose
own range torch opens inside it), from the program's spans
(``benchmark/span_time.py``); nothing where none ran.  Read for every
``optimizer_ms.<mode>`` metric."""

from benchmark import span_time as S


def read(run):
    t = run.trace
    if t is None:
        return None
    return S.per_step_ms(t, S.phase(t, "optimizer"))
