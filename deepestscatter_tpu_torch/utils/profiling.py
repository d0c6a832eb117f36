"""Profiling and observability hooks.

The port of ``deepestscatter_tpu.utils.profiling``.  The reference's only
instrumentation is wall-clock prints (MS/FRAME, GuiExecutionLoop.cpp:
116-121; MS/Render, RadianceCollector.cpp:87-97); here:

- ``trace``: a context manager around ``torch.profiler`` (host and CUDA
  activity) that writes a Chrome trace (``chrome://tracing``, Perfetto);
- ``Throughput``: rays/s or samples/s counters with wall-clock timing;
- ``annotate``: a named region in the trace (``record_function``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the block (CPU, and CUDA where a card is present) and write
    ``<log_dir>/trace.json``; yields the profiler (``key_averages()``)."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region in the trace."""
    return record_function(name)


class Throughput:
    """Counter for rays/samples per second.

    >>> t = Throughput("rays")
    >>> with t.measure(n_items=512*256*10):
    ...     tick()
    >>> t.report()
    """

    def __init__(self, unit: str = "items"):
        self.unit = unit
        self.total_items = 0
        self.total_seconds = 0.0
        self.calls = 0

    @contextlib.contextmanager
    def measure(self, n_items: int) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.total_items += n_items
            self.total_seconds += dt
            self.calls += 1

    @property
    def per_second(self) -> float:
        return self.total_items / self.total_seconds if self.total_seconds else 0.0

    def report(self) -> str:
        return (
            f"{self.total_items:,} {self.unit} in {self.total_seconds:.2f}s "
            f"over {self.calls} calls = {self.per_second / 1e6:.3f} M{self.unit}/s"
        )
