"""The whole step's share of the card's peak, in %: the least time of a unit of
the cell's work -- its operations, counted on the plain reference at the cell's
shapes (``Entry.flops_per_unit``), split by the dtype the configuration states,
each part over its published peak -- times the units the measured window
completed a second.  The count is the same whatever implements the work; the
rate is the untraced window's."""

from .. import peaks


def read(trace, cell):
    if not trace.device or not trace.rate:
        return None
    least = sum(f / peaks.FLOPS_PER_S[dt] for dt, f in trace.flops().items())
    return 100.0 * least * trace.rate
