"""k1_roofline: the least time the card could take for K1's useful work in
the traced window over K1's device time there (its kernel and the moment
pass that follows it), in %.

Useful work: one pair-trip for each iteration a pair applied at a level,
from the program's pyramidal_solve on each traced batch (per-level
iteration counts; run once per batch after the traced window), at the
level shapes of the reference's pyramid. Bytes and flops per pair-trip:
benchmark/yardstick/work.py; peaks: peaks.py."""

import importlib

import torch

from benchmark.reference.align_ref import level_shapes
from benchmark.yardstick import peaks, work

K1 = r"fused_iter_kernel"


def level_trips(run, k):
    """[(h, w, pair-trips)] of pool batch k, finest level first."""
    def solve():
        pyr = importlib.import_module(f"{run.port.__name__}.models.pyramidal")
        cfg, b = run.cfg, run.pool[k]
        i1, i2 = b.i1.to(torch.float32), b.i2.to(torch.float32)
        p0 = torch.zeros((i1.shape[0], 8), dtype=torch.float32, device=i1.device)
        _, per_scale = pyr.pyramidal_solve(
            i1, i2, p0, cfg.transform, nscales=cfg.nscales, nu=cfg.nu, tol=cfg.tol,
            max_iter=cfg.max_iter, robust=cfg.robust, lam=cfg.lam,
            nanifoutside=cfg.nanifoutside, delta=cfg.delta, pyramid_method=cfg.pyramid_method,
            precondition=cfg.precondition, divergence_guard=cfg.divergence_guard,
            delta_cap=cfg.delta_cap)
        shapes = level_shapes(i1.shape[1], i1.shape[2], cfg.nscales, cfg.nu)
        trips = [int(s.niters.sum()) for s in reversed(per_scale)]
        return [(h, w, n) for (h, w), n in zip(shapes, trips)]
    return run.cached(f"level_trips.{k}", solve)


def read(run):
    tr = run.trace
    if tr is None or run.device.type != "cuda":
        return None
    pk = peaks.card_peaks(torch.cuda.get_device_name(run.device))
    own = tr.owner(K1)
    if pk is None or not own.any():
        return None
    c = run.cell.mix["channels"]
    robust = run.cell.config["robust"] != "QUADRATIC"
    least = 0.0
    for k in range(len(run.pool)):   # the traced window calls each batch once
        for h, w, n in level_trips(run, k):
            least += peaks.least_seconds(n * work.fused_iter_bytes(c, h, w, robust),
                                         n * h * w * work.fused_iter_flops_per_pixel(c, robust),
                                         pk)
    return 100.0 * least / tr.device.seconds(own)
