"""Device milliseconds a step of the augmentor's colour stage (jitter and
blur, either backend: the program's span ``augment.colour``,
``benchmark/span_time.py``); nothing where none ran.  Read for every
``augment_colour_ms.<mode>`` metric."""

from benchmark import span_time as S


def read(run):
    t = run.trace
    if t is None:
        return None
    return S.per_step_ms(t, S.extents(t, ["augment.colour"]))
