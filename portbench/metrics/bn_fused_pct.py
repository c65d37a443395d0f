"""Share of the backbone's FrozenBN applications over the traced device phase
that ran inside kernel K8, in %: the program's ``bn.fused`` counter over
``bn.fused`` + ``bn.plain`` (``models/resnet.py``, once a backbone forward).
None where the program counts neither, as a program without K8 does."""

from .. import spans


def read(trace, cell):
    ph = spans.phase(trace, spans.program_records())
    if ph is None:
        return None
    fused = sum(c.n for c in ph["counts"] if c.name == "bn.fused")
    plain = sum(c.n for c in ph["counts"] if c.name == "bn.plain")
    return 100.0 * fused / (fused + plain) if fused + plain else None
