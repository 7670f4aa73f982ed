"""Weak scaling over ranks, and the multi-rank dry run.

`measure_weak_scaling` fixes the pairs per rank and grows the number of
ranks: one rank per card on CUDA (up to the cards there are), or gloo
ranks on the CPU, where the ranks share the host's cores and the record
measures the partitioning's overhead, not a device's speed. Per-rank
throughput that holds steady is the weak-scaling efficiency; one that
collapses points at hidden serialization.

    python -m inverse_compositional_algorithm_tpu_torch.parallel.scaling [out.json] [--device cpu]
    # at the flagship size:
    python -m inverse_compositional_algorithm_tpu_torch.parallel.scaling out.json \
        --height 388 --width 584 --nscales 5 --pairs-per-device 8

`dryrun_multichip(n)` runs one sharded alignment step, the row-tiled
pyramid and the row-tiled solver on n CPU ranks, on a pairs x tile mesh
(tile 2 when n is even): the twin of the JAX package's
`__graft_entry__.py::dryrun_multichip`.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.distributed as dist

from ..config import AlignConfig
from ..eval.benchmarks import card_info, make_bench_batch
from ..ops.normal_equations import RobustLoss
from ..ops.transforms import TransformType
from .mesh import make_mesh
from .ranks import drive, time_calls
from .sharded import align_sharded
from .spawn import run_ranks

__all__ = ["measure_weak_scaling", "dryrun_multichip"]


def _weak_rank(device, inputs, *, cfg: AlignConfig, pairs_per_device: int, height: int,
               width: int, repeats: int) -> dict:
    """One rank of a weak-scaling row: its own pairs, all ranks on pairs."""
    mesh = make_mesh(device_type=device.type)
    i1, i2, _ = make_bench_batch(pairs_per_device, height, width, cfg.transform,
                                 seed=dist.get_rank(), device=device)

    def call():
        return align_sharded(i1, i2, cfg, mesh=mesh)

    res = call()                                  # warm-up
    ms = torch.tensor([time_calls(call, repeats, device)], dtype=torch.float64, device=device)
    finite = torch.tensor([int(torch.isfinite(res.error).all())], device=device)
    dist.all_reduce(ms, op=dist.ReduceOp.MAX)
    dist.all_reduce(finite, op=dist.ReduceOp.MIN)
    return {"ms": float(ms), "errors_finite": bool(finite)}


def measure_weak_scaling(device_counts=(1, 2, 4, 8), pairs_per_device: int = 4,
                         height: int = 96, width: int = 128, nscales: int = 2,
                         repeats: int = 10, device: str = "cuda",
                         timeout_s: float = 600.0) -> dict:
    """Rows of {devices, batch, pairs_per_sec, pairs_per_sec_per_device,
    errors_finite} and the efficiency of the last row against the first.
    On CUDA a world larger than the card count is left out; the CPU runs
    every world size as gloo ranks. The model is the flagship's
    (HOMOGRAPHY + CHARBONNIER, delta 10); the default size is the JAX
    package's 96x128 toy, a check of the path, and the flagship's is
    388x584, 5 scales, 8 pairs a rank."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("measure_weak_scaling(device='cuda') needs a CUDA device")
    cfg = AlignConfig(transform=TransformType.HOMOGRAPHY, robust=RobustLoss.CHARBONNIER,
                      nscales=nscales)
    rows = []
    for nd in device_counts:
        if device == "cuda" and nd > torch.cuda.device_count():
            continue
        outs = run_ranks(_weak_rank, nd, device=device, timeout_s=timeout_s,
                         kwargs=dict(cfg=cfg, pairs_per_device=pairs_per_device, height=height,
                                     width=width, repeats=repeats))
        out = outs[0]["out"]
        b = pairs_per_device * nd
        pps = b / (out["ms"] / 1e3)
        rows.append({"devices": nd, "batch": b, "pairs_per_sec": pps,
                     "pairs_per_sec_per_device": pps / nd,
                     "errors_finite": out["errors_finite"]})
        print(rows[-1], flush=True)
    eff = (rows[-1]["pairs_per_sec_per_device"] / rows[0]["pairs_per_sec_per_device"]
           if len(rows) > 1 else 1.0)
    return {
        "mode": ("one rank per CUDA device (NCCL)" if device == "cuda"
                 else "gloo ranks on the CPU (weak-scaling proxy: shared host cores)"),
        "card": card_info()["nvidia_smi"] if device == "cuda" else None,
        "config": "homography+charbonnier, %dx%d, %d scales, delta %d, %d pairs/rank"
                  % (height, width, nscales, cfg.delta, pairs_per_device),
        "rows": rows,
        "weak_scaling_efficiency": eff,
    }


def dryrun_multichip(n_devices: int = 4, timeout_s: float = 300.0) -> dict:
    """One sharded alignment step (align_sharded with tile_rows), the
    row-tiled pyramid and the row-tiled solver on n_devices CPU ranks;
    raises unless every result has its shape and is finite. Returns the
    mesh and each entry point's p [B, 8], all ranks agreeing."""
    tile = 2 if n_devices % 2 == 0 else 1
    pairs = n_devices // tile
    cfg = AlignConfig(transform=TransformType.HOMOGRAPHY, robust=RobustLoss.CHARBONNIER,
                      nscales=2, max_iter=2, delta=2)
    rng = np.random.default_rng(0)
    b, h, w = 2 * pairs, 32, 40
    i1 = rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    i2 = rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    solve = dict(ttype=TransformType.HOMOGRAPHY, max_iter=2, delta=2,
                 robust=RobustLoss.CHARBONNIER)
    cases = {
        "align": {"entry": "align_sharded", "mesh": (pairs, tile),
                  "kwargs": {"config": cfg, "tile_rows": tile > 1}},
        "pyramid": {"entry": "tiled_pyramidal_solve", "mesh": (pairs, tile),
                    "kwargs": {**solve, "nscales": 2}},
        "solve": {"entry": "tiled_ic_solve", "mesh": (pairs, tile), "kwargs": solve},
    }
    args = {f"{c}.{k}": v for c in cases for k, v in (("i1", i1), ("i2", i2))}
    outs = run_ranks(drive, n_devices, device="cpu", timeout_s=timeout_s, args=args,
                     kwargs={"cases": cases, "keep_images": False})
    got = outs[0]["out"]
    if got["align.p"].shape != (b, 8) or not np.isfinite(got["align.error"]).all():
        raise RuntimeError(f"align_sharded: p {got['align.p'].shape}, error {got['align.error']}")
    if any(not np.array_equal(o["out"]["align.p"], got["align.p"]) for o in outs):
        raise RuntimeError("align_sharded: the ranks disagree on p")
    print(f"dryrun_multichip OK: mesh=({pairs}x{tile}) pairs x tile, batch={b}, "
          f"p shape={got['align.p'].shape}", flush=True)
    for c in ("pyramid", "solve"):
        for o in outs:
            p = o["out"][f"{c}.p"]
            if p.shape != (b // pairs, 8) or not np.isfinite(o["out"][f"{c}.error"]).all():
                raise RuntimeError(f"{cases[c]['entry']}: p {p.shape} on a rank, or not finite")
    if got["pyramid.levels"] != 2:
        raise RuntimeError(f"tiled_pyramidal_solve ran {got['pyramid.levels']} levels, not 2")
    print(f"dryrun_multichip OK (tiled pyramid and solver, {n_devices} CPU ranks)", flush=True)
    return {"mesh": (pairs, tile), "align_p": got["align.p"],
            "pyramid_p": np.concatenate([o["out"]["pyramid.p"] for o in outs[::tile]]),
            "solve_p": np.concatenate([o["out"]["solve.p"] for o in outs[::tile]])}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("out", nargs="?", help="write the record here (else print it)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--counts", type=int, nargs="+", default=[1, 2, 4, 8],
                    help="world sizes, one row each")
    ap.add_argument("--pairs-per-device", type=int, default=4)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--nscales", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=10)
    cli = ap.parse_args()
    rec = measure_weak_scaling(tuple(cli.counts), cli.pairs_per_device, cli.height, cli.width,
                               cli.nscales, cli.repeats, device=cli.device)
    if cli.out:
        with open(cli.out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"wrote {cli.out}")
    else:
        print(json.dumps(rec))
