"""The port's spans (`utils/profiling.py::span`) and per-level counts
(`AlignResult.level_niters`) on the CPU, at 2 pairs of 48x64 on 2 scales.

Without a profiler a span is one shared null context that dispatches no op
and never waits for the device; under torch.profiler an `align` call emits
the `ica.*` spans nested as the layers are, one `ica.trip` a solver trip.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import inverse_compositional_algorithm_tpu_torch as ica
from inverse_compositional_algorithm_tpu_torch.models.pyramidal import pyramidal_solve
from inverse_compositional_algorithm_tpu_torch.utils.profiling import span

torch.set_num_threads(1)

T = ica.TransformType
CFG = ica.AlignConfig(transform=T.HOMOGRAPHY, robust=ica.RobustLoss.CHARBONNIER, nscales=2,
                      delta=4)

# The span each span sits in directly; the loop's first check sits in the level.
PARENT = {"ica.pyramid": {"ica.align"}, "ica.pyramid.zoom": {"ica.pyramid"},
          "ica.level": {"ica.align"},
          "ica.level.setup": {"ica.level"}, "ica.trip": {"ica.level"},
          "ica.trip.system": {"ica.trip"}, "ica.trip.update": {"ica.trip"},
          "ica.trip.sync": {"ica.trip", "ica.level"}, "ica.final_warp": {"ica.align"},
          "ica.align": {None}}


@pytest.fixture(scope="module")
def pairs():
    base = torch.tensor(np.random.default_rng(5).uniform(0, 255, (1, 48, 64, 3)),
                        dtype=torch.float32)
    base = ica.ops.pyramid.gaussian_blur(base, 2.0).expand(2, -1, -1, -1).contiguous()
    p = torch.tensor([[0.01, -0.005, 1.5, 0.008, -0.01, -1.0, 5e-5, -3e-5],
                      [-0.02, 0.01, -2.5, 0.0, 0.015, 0.8, 0.0, 1e-4]])
    i1 = ica.ops.warp.bicubic_sample(base, *ica.transform_grid(p, T.HOMOGRAPHY, 48, 64))
    return i1, base


class Dispatched(TorchDispatchMode):
    """Records every op dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def profiled_spans(fn):
    """(result, [(name, start, end)] of the ica.* host spans) of fn() under a
    CPU torch.profiler, sorted outer before inner."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    rows = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
            for ev in prof.profiler.kineto_results.events()
            if ev.is_user_annotation() and ev.name().startswith("ica.")]
    return out, sorted(rows, key=lambda r: (r[1], -r[2]))


def parents(rows):
    """The innermost span each span of `rows` (sorted outer first) lies in."""
    out, stack = [], []
    for name, a, b in rows:
        while stack and stack[-1][2] <= a:
            stack.pop()
        out.append(stack[-1] if stack else None)
        stack.append((name, a, b))
    return out


@pytest.fixture(scope="module")
def traced(pairs):
    return profiled_spans(lambda: ica.align(*pairs, CFG))


def test_span_off_is_one_null_context(monkeypatch, pairs):
    """No profiler: every span is the one shared null context, which
    dispatches no op and never waits for the device, and an align call
    starts no range."""
    assert span("ica.trip") is span("ica.align")
    assert not torch._C._autograd._profiler_enabled()

    def refuse(*a, **k):
        raise AssertionError("called with no profiler running")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with Dispatched() as seen:
        with span("ica.trip"):
            pass
    assert seen.ops == []
    res = ica.align(*pairs, CFG)
    assert res.p.shape == (2, 8)


def test_span_on_is_a_record_function():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        s = span("ica.trip")
        assert isinstance(s, torch.profiler.record_function) and s is not span("ica.trip")


def test_align_spans_nest_as_the_layers(traced):
    res, rows = traced
    names = [r[0] for r in rows]
    assert names.count("ica.align") == 1 and names.count("ica.pyramid") == 1
    assert names.count("ica.level") == CFG.nscales == names.count("ica.level.setup")
    assert names.count("ica.final_warp") == 1
    assert names.count("ica.pyramid.zoom") == 2 * (CFG.nscales - 1)
    for (name, _, _), parent in zip(rows, parents(rows)):
        assert (parent[0] if parent else None) in PARENT[name], name
    n = names.count("ica.trip")
    assert n > 0
    assert names.count("ica.trip.system") == names.count("ica.trip.update") == n
    assert names.count("ica.trip.sync") == n + CFG.nscales


def test_trips_per_level_are_max_level_niters(traced):
    """Each level runs one trip a loop pass: as many `ica.trip` spans as the
    most iterations a pair took there; the first sync of each level sits
    before its trips, directly in the level."""
    res, rows = traced
    assert len(res.level_niters) == CFG.nscales
    levels = [r for r in rows if r[0] == "ica.level"]
    for (_, a, b), niters in zip(levels, res.level_niters):
        inside = [r for r in rows if a < r[1] and r[2] <= b]
        assert sum(r[0] == "ica.trip" for r in inside) == int(niters.max())
        assert [r[0] for r in inside if r[0] != "ica.level.setup"][0] == "ica.trip.sync"
    assert torch.equal(res.level_niters[-1], res.niters)


def test_level_niters_equal_pyramidal_solve(pairs):
    i1, i2 = pairs
    res = ica.align(i1, i2, CFG)
    _, per_scale = pyramidal_solve(
        i1, i2, torch.zeros(2, 8), CFG.transform, nscales=CFG.nscales, nu=CFG.nu,
        tol=CFG.tol, max_iter=CFG.max_iter, robust=CFG.robust, lam=CFG.lam,
        nanifoutside=CFG.nanifoutside, delta=CFG.delta, pyramid_method=CFG.pyramid_method,
        precondition=CFG.precondition, divergence_guard=CFG.divergence_guard,
        delta_cap=CFG.delta_cap)
    assert len(res.level_niters) == len(per_scale) == CFG.nscales
    for got, state in zip(res.level_niters, per_scale):
        assert got.dtype == torch.int32 and torch.equal(got, state.niters)
    one = ica.align(i1[1], i2[1], CFG)
    assert [int(n) for n in one.level_niters] == [int(n[1]) for n in res.level_niters]
    assert all(n.ndim == 0 for n in one.level_niters)



def test_row_tiled_spans_nest_as_the_layers(pairs):
    """The row-tiled solver runs `pyramidal_solve`'s coarse-to-fine loop and
    `ic_solve`'s level: on a one-rank mesh (gloo, in this process) its call
    emits one `ica.pyramid` and, each level, an `ica.level` holding the
    level's set-up, its trips and its first sync; one rank's tile holds
    the whole frame, so its state is `pyramidal_solve`'s, bit for bit."""
    import socket

    import torch.distributed as dist

    from inverse_compositional_algorithm_tpu_torch.parallel.mesh import make_mesh
    from inverse_compositional_algorithm_tpu_torch.parallel.sharded import init_distributed
    from inverse_compositional_algorithm_tpu_torch.parallel.tiled import tiled_pyramidal_solve

    i1, i2 = pairs
    kw = dict(nscales=CFG.nscales, robust=CFG.robust, delta=CFG.delta)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed("cpu", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1, device_type="cpu")
        (state, per_scale), rows = profiled_spans(
            lambda: tiled_pyramidal_solve(i1, i2, torch.zeros(2, 8), CFG.transform, mesh=mesh,
                                          **kw))
    finally:
        dist.destroy_process_group()
    names = [r[0] for r in rows]
    assert names.count("ica.pyramid") == 1
    assert names.count("ica.level") == CFG.nscales == names.count("ica.level.setup")
    top = {**PARENT, "ica.pyramid": {None}, "ica.level": {None}}
    for (name, _, _), parent in zip(rows, parents(rows)):
        assert (parent[0] if parent else None) in top[name], name
    n = names.count("ica.trip")
    assert n == sum(s.it for s in per_scale) > 0
    assert names.count("ica.trip.sync") == n + CFG.nscales
    want, want_per_scale = pyramidal_solve(i1, i2, torch.zeros(2, 8), CFG.transform, **kw)
    for got, ref in zip(per_scale + [state], want_per_scale + [want]):
        for f in ("p", "error", "lam", "niters", "active", "diverged"):
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
