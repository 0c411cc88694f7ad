"""The hand-written 3x3 conv kernels' share of their roofline, in percent:
the least time of the launches of every 3x3 conv that the configuration's
model args put on the kernels (the forward's stats form, dgrad and wgrad
in training, the eval form in serving; ``driver.conv3x3_bound_s``, from
``benchmark/flops.py``), over their device time in the traced window.

The device time counts every launch whose whole kernel name is in
``KERNELS``, and each launch of the sums' second pass (``sum_rows_kernel``)
that directly follows one of them: the 1x1 conv's and the ConvTranspose's
backward launch that pass too, and those are not counted.  Read for every
``conv3x3_roofline.<mode>`` metric."""

KERNELS = ("vec_kernel", "narrow_kernel", "deep_kernel", "wgrad_vec_kernel",
           "wgrad_narrow_kernel", "wgrad_deep_kernel", "wgrad_ge_prepass", "wgrad_x_prepass")
SECOND_PASS = ("sum_rows_kernel",)


def read(run):
    t = run.trace
    if t is None:
        return None
    device_s = t.kernel_seconds(KERNELS, SECOND_PASS)
    if device_s <= 0:
        return None
    return 100.0 * run.driver.conv3x3_bound_s() * t.steps / device_s
