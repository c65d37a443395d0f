"""The benchmark of ``seam_match_rcnn_tpu_torch`` on one NVIDIA H100 a cell.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line.  Everything that
belongs to one configuration, traffic mix, per-layer metric or kernel count is a
file of its own here, found by name: ``configs/<config>.json``,
``traffic/<mix>.json`` (read by the entry named in its ``entry`` key,
``entries/<entry>.py``), ``metrics/<metric>.py`` (by the part of the metric's
name before its first dot), ``rooflines/<kernel>.py`` and ``limits/<cell>.json``.
``reference/`` is the plain PyTorch model that decides ``correct``; it imports
nothing of the port.
"""
