"""Share of the traced device phase in which the card sat idle while the program's
innermost open span was ``seam.vit``: the ViTDet trunk and its feature pyramid
(``models/vit.py``), inside ``seam.forward``, in %.  Self time, read from the
program's own span records (``spans.py``); None where the program records no
such span, as a program without the ViTDet backbone does."""

from .. import spans


def read(trace, cell):
    return spans.idle_pct(trace, "seam.vit")
