"""Share of the traced device phase in which no kernel, copy or set ran on the
card (the union of the CUPTI records over the phase's host-clock length), in %."""


def read(trace, cell):
    if not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
