"""Run one cell of ``BENCHMARK.json`` on the card and print one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from process start to the first measured item): the kernel
library is built or loaded from its fixed directory inside the checkout, the
configuration's weights are drawn from the seed on the card, the mix's inputs are
made from the seed, and the entry warms up the cell's own shapes.  The window
then drives the entry's items for ``--seconds`` (the last item started before
the deadline runs to its end; a rate is all the work over all the time).  With
``--trace 1`` the window is followed by a few items under ``torch.profiler``
(``trace.py``), and the line carries the cell's per-layer metrics instead of its
end-to-end ones.  Then the port is freed and the float32 reference decides ``correct``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "seam_match_rcnn_tpu")

# every build and kernel cache of the program at a fixed path inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "portbench" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "portbench" / "triton"))

import torch  # noqa: E402

from . import generate  # noqa: E402
from . import model as M  # noqa: E402
from . import trace as T  # noqa: E402


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, cell: dict, section: str) -> list:
    """The metrics of ``section`` this cell reports: those that list it, or list
    no cells at all."""
    return [m for m in bench[section]
            if "workloads" not in m or cell["name"] in m["workloads"]]


def reader(metric_name: str):
    """``metrics/<q>.py`` for the metric ``<q>.<kind>``."""
    return importlib.import_module(f"portbench.metrics.{metric_name.split('.')[0]}")


def make_entry(cell: dict, seed: int, device):
    """The cell's entry: ``entries/<entry>.py`` of its mix, with its configuration."""
    cfg = M.load_config(cell["config"])
    mix = generate.load_mix(cell["traffic"])
    mod = importlib.import_module(f"portbench.entries.{mix['entry']}")
    return mod.Entry(cfg, mix, seed, device)


def load_limits(cell: dict) -> dict:
    return json.loads((HERE / "limits" / f"{cell['name']}.json").read_text())


def forbidden_modules() -> list:
    return sorted(k for k in sys.modules if k.split(".")[0] in FORBIDDEN)


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, device="cuda",
             entry=None, log=print):
    """One run of ``cell`` -> the result dict (without the device block's
    name).  ``entry``: a prepared entry (the tests hand one in); ``log``
    takes the lines printed before the result."""
    laps = {"import": time.perf_counter() - T0}
    if device == "cuda":
        from seam_match_rcnn_tpu_torch.ops import native

        t = time.perf_counter()
        torch.zeros(1, device=device)
        _sync(device)
        laps["CUDA context"] = time.perf_counter() - t
        t = time.perf_counter()
        native.library()
        laps["kernel load"] = time.perf_counter() - t
    entry = entry or make_entry(cell, seed, device)
    entry.setup()
    _sync(device)
    setup_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T0
    laps.update(entry.phases)
    log("setup_s: " + ", ".join(f"{k} {v:.3f} s" for k, v in laps.items())
        + f"; total {setup_s:.3f} s")

    lat, attempted, failed = [], 0, 0
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        t = time.perf_counter()
        n, bad = entry.item()
        lat.append(time.perf_counter() - t)
        attempted += n
        failed += bad
    _sync(device)
    elapsed = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    own = entry.end_to_end(attempted - failed, elapsed, lat)
    e2e = dict(own, peak_mem_gib=peak / 2**30, setup_s=setup_s)
    for name, v in own.items():
        log(f"{name}: {v!r} from {len(lat)} items ({attempted} {entry.unit}) over "
            f"{elapsed:.3f} s, median item {statistics.median(lat) * 1e3:.3f} ms, "
            f"{failed} {entry.unit} failed")

    result = {"attempted": attempted, "failed": failed}
    dev = {"peak_bytes": max(setup_peak, peak)}
    if trace:
        k = entry.mix["trace_items"]
        _sync(device)
        with T.capture(device, host=False) as dev_box:
            t, units = time.perf_counter(), 0
            for _ in range(k):
                units += entry.item()[0]
            _sync(device)
            window_s = time.perf_counter() - t
        with T.capture(device, host=True) as host_box:
            with torch.profiler.record_function(T.WINDOW):
                for _ in range(k):
                    with torch.profiler.record_function(T.ITEM):
                        entry.item()
                _sync(device)
        tr = T.reduce(dev_box["events"], window_s, units, host_box["events"],
                      (attempted - failed) / elapsed, entry)
        per_layer = {}
        for m in metrics_for(bench, cell, "per_layer"):
            v = reader(m["name"]).read(tr, cell)
            if v is not None:
                per_layer[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = per_layer
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    else:
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in metrics_for(bench, cell, "end_to_end")}
    entry.release()
    _sync(device)
    limits = load_limits(cell)
    numbers = entry.check()
    checks = {k: {"value": v, "limit": limits.get(k, 0.0)} for k, v in numbers.items()}
    result["correct"] = failed == 0 and attempted > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    result["device"] = dev
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_benchmark()
    cell = find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    res = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                   log=lambda s: print(s, file=sys.stderr))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 4
    dev = res.pop("device")
    checks = res.pop("checks")
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": res["metrics"],
           "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                      "count": cell["chips"], "memory_peak_bytes": dev["peak_bytes"],
                      **{k: dev[k] for k in ("busy_s", "window_s") if k in dev}}}
    if "breakdown" in res:
        out["breakdown"] = res["breakdown"]
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
