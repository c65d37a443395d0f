"""Metric logging: smoothed meters, a console logger and a JSONL scalar sink.

Port of ``seam_match_rcnn_tpu/utils/logging.py`` (the reference's
``SmoothedValue`` and ``MetricLogger``): windowed medians and global
averages, a console line every ``print_freq`` iterations with iteration and
data time, ETA and peak device memory, and scalars appended to
``<log_dir>/scalars.jsonl``.
"""

from __future__ import annotations

import collections
import datetime
import json
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        v = float(value)
        self.deque.append(v)
        self.count += n
        self.total += v * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               value=self.value)


def device_memory_mb() -> float:
    """Peak memory allocated on the current CUDA device (what the reference
    logs), 0 without one."""
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated() / (1024.0 * 1024.0)


class ScalarWriter:
    """Scalars as JSON lines ``{"tag", "value", "step", "time"}`` in
    ``<log_dir>/scalars.jsonl``; no sink when ``log_dir`` is None."""

    def __init__(self, log_dir: Optional[str]):
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, global_step: int):
        if self._jsonl:
            self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                          "step": int(global_step), "time": time.time()}) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._jsonl:
            self._jsonl.close()


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = "",
                  total: Optional[int] = None):
        i = 0
        start = end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")

        def line(head):
            return self.delimiter.join([head, str(self), f"time: {iter_time}",
                                        f"data: {data_time}",
                                        f"mem: {device_memory_mb():.0f}MB"])

        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                eta = "?"
                if total:
                    eta = str(datetime.timedelta(seconds=int(iter_time.global_avg * (total - i))))
                print(line(self.delimiter.join(
                    [header, f"[{i}" + (f"/{total}]" if total else "]"), f"eta: {eta}"])))
            i += 1
            end = time.time()
        if i and (i - 1) % print_freq != 0:  # the last iteration's line
            print(line(self.delimiter.join([header, f"[{i - 1}" + (f"/{total}]" if total
                                                                   else "]")])))
        dur = time.time() - start
        print(f"{header} Total time: {str(datetime.timedelta(seconds=int(dur)))}")
