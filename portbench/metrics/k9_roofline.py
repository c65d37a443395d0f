"""Kernel K9's share of its roofline, in %: the sum over the traced window's
launches of ``rooflines/k9.py``'s least time, over the sum of the kernel's
device time in the trace (matched by kernel name).  Nothing is read when the
window launched no K9, or when the launches and the kernel records disagree
in number."""

from .. import peaks
from ..rooflines import k9


def read(trace, cell):
    kernels = trace.kernels(k9.KERNEL)
    launches = k9.launches(trace)
    if not kernels or not launches or len(launches) != len(kernels):
        return None
    least = sum(peaks.bound_s(f, b) for f, b in launches)
    return 100.0 * least / (sum(k.end - k.start for k in kernels) / 1e9)
