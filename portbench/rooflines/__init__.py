"""Operation and byte counts of the port's hand-written kernels, from shapes.

One file a kernel, ``<kernel>.py``, with ``launches(trace)``: the launches of
that kernel in a traced window as (flops, bytes) pairs, worked out from the
shapes of the calls that launched them.  Each input byte is counted read once
and each output byte written once, whatever the kernel reads again."""
