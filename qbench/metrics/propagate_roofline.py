"""Kernel (``csrc/frontier.cu`` behind ``PropagateBackend.propagate``):
the least time the counted bytes of the window's propagate calls
(``roofline.propagate_bytes``) take at the chip's HBM bandwidth, over the
device time of everything launched inside the ``qbench.propagate`` spans,
in %."""


def read(ctx):
    s = ctx.summary
    if s is None or ctx.peaks is None or not ctx.bytes_counted:
        return None
    lo, hi = s.window
    t = sum(b - a for a, b, _, region in s.device if region == "propagate" and lo <= a < hi)
    if t <= 0:
        return None
    return ctx.bytes_counted / ctx.peaks["hbm_bytes_per_s"] / t * 100.0
