"""Share of the ViTDet backbone's attention calls over the traced device phase
that ran inside kernel K9, in %: the program's ``vit.attn.fused`` counter over
``vit.attn.fused`` + ``vit.attn.plain`` (``models/vit.py``, once a backbone
forward, one for each block).  None where the program counts neither, as a
program without the ViTDet backbone does."""

from .. import spans


def read(trace, cell):
    ph = spans.phase(trace, spans.program_records())
    if ph is None:
        return None
    fused = sum(c.n for c in ph["counts"] if c.name == "vit.attn.fused")
    plain = sum(c.n for c in ph["counts"] if c.name == "vit.attn.plain")
    return 100.0 * fused / (fused + plain) if fused + plain else None
