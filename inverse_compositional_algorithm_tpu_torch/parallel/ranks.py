"""Rank bodies for `parallel.spawn.run_ranks`.

`drive` runs the scale-out entry points, one case after another, on this
rank's share of global batches that the parent wrote once for every rank:

    cases = {"flag": {"entry": "align_sharded", "mesh": (1, 2),
                      "kwargs": {"config": cfg, "tile_rows": True}}}
    outs = run_ranks(drive, 2, device="cuda", backend="gloo",
                     args={"flag.i1": i1, "flag.i2": i2}, kwargs={"cases": cases})

Inputs of case `name` are `name.i1`, `name.i2` ([B, H, W, C], the global
batch) and, optionally, `name.p0` ([B, 8]). Every output is named
`name.<field>`: the entry point's per-pair results for this rank's pairs
(`tiled_*`) or, after `gather_result`, for every pair (`align_sharded`),
and the rank's place on the mesh. With `repeats`, the entry point is
called that many more times and `name.ms` is the mean ms per call (CUDA
events on a card, the host clock on the CPU).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .mesh import PAIRS_AXIS, TILE_AXIS, image_shard, make_mesh, pair_shard
from .sharded import align_sharded, gather_result
from .tiled import tiled_ic_solve, tiled_pyramidal_solve

__all__ = ["drive", "run_launch", "time_calls"]


def time_calls(fn, repeats: int, device: torch.device) -> float:
    """Mean ms per call of `fn()` over `repeats` calls, after every rank has
    reached this point: CUDA events on a card, the host clock on the CPU."""
    dist.barrier()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    return (time.perf_counter() - t0) * 1e3 / repeats


def _state_fields(state) -> dict:
    return {"p": state.p, "error": state.error, "lam": state.lam, "niters": state.niters,
            "diverged": state.diverged, "it": state.it}


def drive(device: torch.device, inputs: dict, *, cases: dict, repeats: int = 0,
          keep_images: bool = True) -> dict:
    """Run each case's entry point on this rank (module docstring);
    keep_images=False leaves out align_sharded's iw and valid rows."""
    out = {}
    for name, case in cases.items():
        mesh = make_mesh(*case["mesh"], device_type=device.type)
        kw = dict(case.get("kwargs", {}))
        i1, i2 = (torch.as_tensor(inputs[f"{name}.{k}"], device=device) for k in ("i1", "i2"))
        p0 = inputs.get(f"{name}.p0")
        p0 = (torch.zeros((i1.shape[0], 8), dtype=i1.dtype, device=device) if p0 is None
              else torch.as_tensor(p0, device=device))
        entry = case["entry"]
        if entry == "tiled_ic_solve":
            ttype = kw.pop("ttype")

            def call():
                return _state_fields(tiled_ic_solve(image_shard(i1, mesh), pair_shard(i2, mesh),
                                                    pair_shard(p0, mesh), ttype, mesh=mesh, **kw))
        elif entry == "tiled_pyramidal_solve":
            ttype = kw.pop("ttype")

            def call():
                state, per_scale = tiled_pyramidal_solve(
                    pair_shard(i1, mesh), pair_shard(i2, mesh), pair_shard(p0, mesh), ttype,
                    mesh=mesh, **kw)
                return {**_state_fields(state), "levels": len(per_scale)}
        elif entry == "align_sharded":
            def call():
                res = align_sharded(pair_shard(i1, mesh), pair_shard(i2, mesh),
                                    p0=pair_shard(p0, mesh), mesh=mesh, **kw)
                got = gather_result(res, mesh)
                got["iw_finite"] = bool(torch.isfinite(res.iw[res.valid]).all())
                got["rows"] = res.iw.shape[1]
                if keep_images:
                    got.update(iw=res.iw, valid=res.valid)
                return got
        else:
            raise ValueError(f"unknown entry point {entry!r}")
        res = call()
        if repeats:
            res["ms"] = time_calls(call, repeats, device)
        res.update(pairs_rank=mesh.get_local_rank(PAIRS_AXIS),
                   tile_rank=mesh.get_local_rank(TILE_AXIS))
        out.update({f"{name}.{k}": v for k, v in res.items()})
    return out


def run_launch(device: torch.device, inputs: dict, *, argv: list) -> dict:
    """`parallel.launch.main(argv)` on this rank; its record."""
    from .launch import main

    return main(argv)
