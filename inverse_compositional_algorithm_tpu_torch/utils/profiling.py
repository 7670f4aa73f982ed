"""Profiling and tracing utilities.

Per-stage wall timers that wait for the device, and a thin wrapper over
`torch.profiler` that writes a Chrome trace (viewable in Perfetto or
chrome://tracing). The JAX package's `enable_compilation_cache` has no
counterpart: PyTorch runs eagerly and the kernels' library is already
cached by a hash of its sources (ops/kernels/_build.py).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict

import torch

__all__ = ["StageTimer", "trace"]


def _on_cuda(value) -> bool:
    if isinstance(value, torch.Tensor):
        return value.is_cuda
    if isinstance(value, (list, tuple)):
        return any(_on_cuda(v) for v in value)
    if isinstance(value, dict):
        return any(_on_cuda(v) for v in value.values())
    if hasattr(value, "__dataclass_fields__"):
        return any(_on_cuda(getattr(value, f)) for f in value.__dataclass_fields__)
    return False


class StageTimer:
    """Accumulating wall-clock timer keyed by stage name.

    Waits for the device at scope exit (torch.cuda.synchronize when the
    value registered with `observe` holds a CUDA tensor), so times are real,
    not enqueue latencies::

        timer = StageTimer()
        with timer("warp"):
            iw = timer.observe(warp_fn(...))
        print(timer.report())
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._live = []

    @contextlib.contextmanager
    def __call__(self, name: str, value=None):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if self._live and _on_cuda(self._live.pop()):
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def observe(self, value):
        """Register the stage's output so the timer can wait for it."""
        self._live.append(value)
        return value

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        width = max((len(k) for k in self.totals), default=4)
        lines = [f"{k:<{width}}  {v * 1e3:10.3f} ms  x{self.counts[k]}"
                 for k, v in rows]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the enclosed block (CPU and, where present, CUDA activity)
    and write `trace.json`, a Chrome trace, into `log_dir` (default: an
    `ica-trace` directory under the temporary directory). Yields the
    profiler, whose `key_averages()` gives the per-kernel sums."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "ica-trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
