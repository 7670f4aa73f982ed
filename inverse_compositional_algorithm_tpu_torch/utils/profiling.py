"""Profiling and tracing utilities.

`span(name)`, the program's own ranges at its layer boundaries (the
`ica.*` names: the call, the pyramid and each of its zooms, each level and
its set-up, each solver trip and its stages, the final warp); a thin wrapper over
`torch.profiler` that writes a Chrome trace of a call with those spans
(viewable in Perfetto or chrome://tracing); and `device_ms`, the kernels'
device-only time of a call from the same profiler, with a warm or a cold
L2. The JAX package's `enable_compilation_cache` has no counterpart:
PyTorch runs eagerly and the kernels' library is already cached by a hash
of its sources (ops/kernels/_build.py).
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import torch

__all__ = ["span", "trace", "device_ms"]

# Profiler windows device_ms runs before it gives up on one that records no
# device activity.
_DEVICE_MS_WINDOWS = 5

_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A range named `name` on the profiler's clock while `torch.profiler`
    runs (a `record_function`, which the profiler also images on the device
    over the kernels launched inside it); else one shared null context,
    which starts nothing, launches nothing and never waits for the device.
    A running profiler is the only switch."""
    return torch.profiler.record_function(name) if _profiler_enabled() else _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the enclosed block (CPU and, where present, CUDA activity)
    and write `trace.json`, a Chrome trace holding the program's `ica.*`
    spans, into `log_dir` (default: an `ica-trace` directory under the
    temporary directory). Yields the profiler, whose `key_averages()` gives
    the per-kernel sums."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "ica-trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _kernel_ms(run) -> dict:
    """{kernel: total ms} of the device kernels `run()` launches, from
    torch.profiler. Now and then the profiler records no device activity for
    a window (seen on the H100); such a window is run again, up to
    `_DEVICE_MS_WINDOWS` windows in all, and RuntimeError is raised when
    none recorded any."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(_DEVICE_MS_WINDOWS):
        with torch.profiler.profile(activities=acts) as prof:
            run()
            torch.cuda.synchronize()
        per_kernel = {}
        for avg in prof.key_averages():
            if avg.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(avg, "self_device_time_total", None)
            if us is None:
                us = avg.self_cuda_time_total
            if us > 0:
                per_kernel[avg.key] = us / 1e3
        if per_kernel:
            return per_kernel
    raise RuntimeError(f"torch.profiler recorded no device time in {_DEVICE_MS_WINDOWS} "
                       "windows")


def device_ms(fn, repeats: int = 50, cold_l2: bool = False) -> tuple[float, dict]:
    """Device-only time of `fn()` on the card: (ms per call, {kernel: ms per
    call}) from `torch.profiler`'s per-kernel CUDA durations, summed over
    every kernel `fn` launches and averaged over `repeats` calls after one
    warm-up call. Host gaps between the kernels are left out, unlike a CUDA
    event span.

    Back-to-back calls find in the L2 what the last call left there. With
    cold_l2=True every call is preceded by a read of a buffer four times
    the L2's size (at least 256 MiB), so `fn` starts on an L2 that holds
    none of its data and no dirty lines; the read's kernels are left out of
    the sum, and ValueError is raised if `fn` launches a kernel of the same
    name."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms measures a CUDA device, and none is available")
    fn()
    torch.cuda.synchronize()
    if not cold_l2:
        per_kernel = _kernel_ms(lambda: [fn() for _ in range(repeats)])
    else:
        l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 0)
        buf = torch.empty(max(4 * l2, 256 << 20) // 4, dtype=torch.float32, device="cuda")
        # Each name is learnt from a window of `repeats` calls: windows of
        # one short kernel were seen to record nothing on the H100.
        flush = _kernel_ms(lambda: [buf.sum() for _ in range(repeats)])
        shared = set(flush) & set(_kernel_ms(lambda: [fn() for _ in range(repeats)]))
        if shared:
            raise ValueError(f"fn launches the L2 flush's kernels {sorted(shared)}: "
                             "its cold time cannot be told apart")

        def run():
            for _ in range(repeats):
                buf.sum()
                fn()

        per_kernel = {k: v for k, v in _kernel_ms(run).items() if k not in flush}
        if not per_kernel:
            raise RuntimeError("torch.profiler recorded no device time of fn")
    per_kernel = {k: v / repeats for k, v in per_kernel.items()}
    return sum(per_kernel.values()), per_kernel
