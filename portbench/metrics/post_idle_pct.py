"""Share of the traced device phase in which the card sat idle while the program's
innermost open span was ``seam.readback``: the runner's host copy and per-image
results (``eval/runner.py``), in %. Self time: an idle instant inside a nested span
counts under that span alone. Read from the program's own span records
(``spans.py``); None where the program records no such span."""

from .. import spans


def read(trace, cell):
    return spans.idle_pct(trace, "seam.readback")
