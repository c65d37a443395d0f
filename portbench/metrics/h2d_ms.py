"""Device time of host-to-device copies a frame, in ms: the CUPTI memcpy
records of the traced device phase over the frames its items ingested."""


def read(trace, cell):
    copies = trace.copies("HtoD")
    if not copies or not trace.units:
        return None
    return sum(c.end - c.start for c in copies) / 1e6 / trace.units
