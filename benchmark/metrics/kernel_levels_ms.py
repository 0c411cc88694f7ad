"""Device milliseconds a step of the model blocks of the levels that the
configuration's model args put on the program's hand-written kernels
(levels 0-1 of ``large_unet``: the stem, enc1, enc2, dec4, dec5 and the
output conv), forward and backward, from the program's block spans
(``benchmark/span_time.py``); nothing where none ran.  Read for every
``kernel_levels_ms.<mode>`` metric."""

from benchmark import span_time as S


def read(run):
    t = run.trace
    if t is None:
        return None
    return S.per_step_ms(t, S.extents(t, S.kernel_blocks(run.cell.config)))
