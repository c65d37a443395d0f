"""Share of the ViTDet backbone's LayerNorm applications on its residual stream
over the traced device phase that ran inside kernel K10, in %: the program's
``vit.ln.fused`` counter over ``vit.ln.fused`` + ``vit.ln.plain``
(``models/vit.py``, once a backbone forward, two for each block).  None where
the program counts neither, as a program without K10 does."""

from .. import spans


def read(trace, cell):
    ph = spans.phase(trace, spans.program_records())
    if ph is None:
        return None
    fused = sum(c.n for c in ph["counts"] if c.name == "vit.ln.fused")
    plain = sum(c.n for c in ph["counts"] if c.name == "vit.ln.plain")
    return 100.0 * fused / (fused + plain) if fused + plain else None
