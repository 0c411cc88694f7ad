"""Device milliseconds per step of the operations under the range that
the training driver puts around the Trainer's batch preparation (the
augmentor); nothing where no such range ran.  Read for every
``augment_ms.<mode>`` metric."""


def read(run):
    t = run.trace
    if t is None:
        return None
    ms = 1e3 * t.in_range("augment") / t.steps
    return ms if ms > 0 else None
