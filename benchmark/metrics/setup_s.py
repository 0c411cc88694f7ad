"""Seconds from the process's start to the first timed step: imports,
the kernels' build or load, the program's set-up, the weights, the pool and
the warm-up steps (host clock)."""


def read(run):
    return run.setup_s
