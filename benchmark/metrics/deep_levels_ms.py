"""Device milliseconds a step of every other model block (levels 2-4 of
``large_unet``: enc3, enc4, the bottleneck, dec1, dec2 and dec3, on cuDNN
and PyTorch's BatchNorm), forward and backward, from the program's block
spans (``benchmark/span_time.py``); nothing where none ran.  Read for
every ``deep_levels_ms.<mode>`` metric."""

from benchmark import span_time as S


def read(run):
    t = run.trace
    if t is None:
        return None
    return S.per_step_ms(t, S.extents(t, S.deep_blocks(t, run.cell.config)))
