"""Device milliseconds a step of the operations outside every model block
and step phase of the program's spans (``benchmark/span_time.py``): what
no layer metric holds, the spans' coverage of the step; nothing where no
span ran.  Read for every ``unspanned_ms.<mode>`` metric."""

from benchmark import span_time as S


def read(run):
    t = run.trace
    if t is None:
        return None
    return S.per_step_ms(t, S.spanned(t), inside=False)
