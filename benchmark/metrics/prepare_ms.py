"""Device milliseconds a step of the batch preparation (``prepare``: the
draws, their copy to the device and the augmentor, with the spans of its
stages and the training cell's own range inside it), from the program's
spans (``benchmark/span_time.py``); nothing where none ran.  Read for
every ``prepare_ms.<mode>`` metric."""

from benchmark import span_time as S


def read(run):
    t = run.trace
    if t is None:
        return None
    return S.per_step_ms(t, S.phase(t, "prepare"))
