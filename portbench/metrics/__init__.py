"""Per-layer metric readers, one file a quantity: the metric ``<q>.<cell kind>``
is read by ``metrics/<q>.py``'s ``read(trace, cell)``, which returns the number
or None when the trace holds nothing to read (the harness then leaves the
metric out of the line)."""
