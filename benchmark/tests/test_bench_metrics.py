"""The metric arithmetic on synthetic data: whole calls only, the union of
device intervals and the idle gaps, the attribution of the shared moment
pass, and the frozen byte and flop models."""

import time
import types

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.yardstick import peaks, trace, work


def test_only_whole_calls_count():
    """A call that ends after the window is left out of pairs_per_s."""
    pool = [types.SimpleNamespace(i1=torch.zeros(4, 2, 2, 3), i2=torch.zeros(4, 2, 2, 3))] * 2

    def system(i1, i2, cfg):
        time.sleep(0.3)
        z = torch.zeros(4)
        return types.SimpleNamespace(p=torch.zeros(4, 8), diverged=z.bool(), niters=z.int(),
                                     iw=i1.float(), di=i1.float(), valid=i1[..., 0].bool())

    port = types.SimpleNamespace(__name__="benchmark_fake_port")
    import sys
    sys.modules["benchmark_fake_port.ops.kernels.fused_iter"] = types.SimpleNamespace(LAUNCHES=0)
    cell = harness.Cell(name="x", config={}, mix={"batch": 4, "check_pairs": 2}, chips=1,
                        end_to_end=[], per_layer=[])
    run = harness.Run(cell=cell, seed=1, seconds=1.0, device=torch.device("cpu"), system=system,
                      port=port, cfg=None, t0=time.perf_counter(), pool=pool)
    harness.window(run)
    assert len(run.calls) == 3            # the fourth ends at about 1.2 s
    assert run.calls[-1].end - run.window_start <= 1.0
    pps = harness.load_reader("pairs_per_s").read(run)
    assert pps == pytest.approx(12 / (run.calls[-1].end - run.window_start))
    assert set(run.samples) == {0, 1}


def test_union_and_gaps():
    s = np.array([0, 5, 7, 20, 30], np.int64)
    e = np.array([4, 10, 8, 25, 50], np.int64)
    assert trace.union_ns(s, e, 0, 40) == 4 + 5 + 5 + 10
    assert trace.idle_gaps(s, e, 0, 40) == [(4, 5), (10, 20), (25, 30)]
    assert trace.union_ns(s, e, 6, 22) == 4 + 2


def make_trace():
    dev = [("fused_iter_kernel<3>", 0, 10), ("finalize_kernel", 10, 12),
           ("elementwise", 20, 21), ("weighted_moments_kernel", 30, 40),
           ("finalize_kernel", 40, 41), ("Memcpy DtoH", 50, 52),
           ("fused_iter_kernel<3>", 60, 70), ("finalize_kernel", 71, 73),
           ("warp_planar_kernel", 80, 90)]
    host = [("aten::add", 11, 19), ("cudaLaunchKernel", 12, 14), ("aten::copy_", 41, 60)]
    spans = [(trace.SPAN, 0, 100)]
    return trace.Trace(trace.Intervals.of(dev), trace.Intervals.of(host), trace.Intervals.of(spans))


def test_trace_attribution():
    tr = make_trace()
    own = tr.owner(r"fused_iter_kernel")
    assert tr.device.seconds(own) == pytest.approx(24e-9)
    assert int(tr.kernels().sum()) == 8
    assert tr.busy_s() == pytest.approx(48e-9)
    assert tr.window_s == pytest.approx(100e-9)
    bd = trace.breakdown(tr)
    names = dict(bd["idle_gaps"])
    assert names["aten::copy_"] == pytest.approx(17e-9)         # gaps 41..50 and 52..60
    assert names["aten::add"] == pytest.approx(8e-9)            # 12..20: the launch ended at 14
    assert names["host:outside_any_op"] == pytest.approx(27e-9)
    assert len(bd["device_ops"]) <= 10


def test_host_at_innermost():
    host = trace.Intervals.of([("outer", 0, 100), ("inner", 10, 20), ("later", 30, 40)])
    assert trace.host_at(host, [5, 15, 25, 35, 150]) == [
        "outer", "inner", "outer", "later", "host:outside_any_op"]


def test_readers_on_a_synthetic_trace():
    tr = make_trace()
    run = types.SimpleNamespace(trace=tr)
    assert harness.load_reader("launches_per_trip").read(run) == 4.0
    idle = harness.load_reader("device_idle_pct").read(run)
    assert idle == pytest.approx(52.0)
    assert harness.load_reader("launches_per_trip").read(types.SimpleNamespace(trace=None)) is None


def test_work_models():
    assert work.warp_flops_per_pixel(3) == 150
    assert work.moments_flops_per_pixel(5) == 55
    assert work.fused_iter_flops_per_pixel(3, True) == 14 + 150 + 24 + 7 + 55
    assert work.fused_iter_flops_per_pixel(3, False) == 14 + 150 + 24 + 25
    assert work.fused_iter_bytes(3, 388, 584, True) == 24 * 388 * 584 + 40 + 1280
    assert work.warp_bytes(3, 388, 584) == 25 * 388 * 584


def test_peaks():
    bw, fl = peaks.card_peaks("NVIDIA H100 80GB HBM3")
    assert (bw, fl) == (3350e9, 67e12)
    assert peaks.card_peaks("some other card") is None
    assert peaks.least_seconds(3350e9, 1.0, (bw, fl)) == pytest.approx(1.0)
    assert peaks.least_seconds(1.0, 67e12, (bw, fl)) == pytest.approx(1.0)
