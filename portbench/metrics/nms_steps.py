"""Mean Jacobi steps an NMS call over the traced device phase: the program's
``nms.steps`` counter over its ``nms.calls`` (``ops/nms.py``).  Each step
reads a flag back on the host, so this is also the read-backs a call.  None
where the program counts no NMS call."""

from .. import spans


def read(trace, cell):
    return spans.steps_per_call(trace)
