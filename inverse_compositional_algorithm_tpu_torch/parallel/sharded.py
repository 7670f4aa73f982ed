"""Mesh-sharded alignment: pairs over ranks, optionally image rows too.

`align_sharded` is the scale-out twin of models.api.align. Each rank runs
on its own device (`init_distributed` binds cuda:LOCAL_RANK) and aligns
the pairs of its pairs group: pairs are independent, so the pairs axis
needs no communication at all, and every per-pair quantity (parameters,
errors, iteration counts, convergence and divergence flags) stays on the
ranks that own the pair. With tile_rows the ranks of a tile group share
their pairs and split the rows: the pyramid runs through
`parallel.tiled.tiled_pyramidal_solve` and the final warp (K3 on CUDA)
produces only this rank's rows.

Bring-up, one process per device: under `torchrun` (RANK, WORLD_SIZE,
MASTER_ADDR/PORT and LOCAL_RANK come from the environment)

    init_distributed()
    mesh = make_mesh(tile=2)
    res = align_sharded(i1, i2, cfg, mesh=mesh, tile_rows=True)

NCCL needs one card per rank; gloo (`backend="gloo"`) also runs several
ranks on one card, and on the CPU.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..config import AlignConfig
from ..models.api import AlignResult, _align_impl, _final_warp, _to_tensor
from ..ops.transforms import pad_params
from .mesh import PAIRS_AXIS, TILE_AXIS, axis_size, make_mesh, row_span
from .tiled import tiled_pyramidal_solve

__all__ = ["init_distributed", "align_sharded", "gather_result"]


def init_distributed(device: str = "cuda", backend: str | None = None,
                     timeout_s: float = 600.0, **kwargs) -> torch.device:
    """Start the default process group and bind this rank's device.

    device "cuda" binds cuda:(LOCAL_RANK, else the rank, mod the card
    count) with `torch.cuda.set_device` before anything is allocated (so
    `"cuda"` means this rank's card from then on) and raises without a
    card; "cpu" runs on the CPU. backend defaults to NCCL on CUDA, gloo on the CPU; gloo on
    CUDA lets several ranks share one card. A collective that waits longer
    than `timeout_s` raises instead of hanging. Other keywords go to
    `torch.distributed.init_process_group` (init_method, world_size, rank).
    Returns the bound device."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available: pass device='cpu' to run the "
                               "ranks on the CPU")
        local = int(os.environ.get("LOCAL_RANK", kwargs.get("rank", 0)))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif device == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        kwargs.setdefault("device_id", dev)     # NCCL binds its communicators to it
    dist.init_process_group(backend=backend, timeout=datetime.timedelta(seconds=timeout_s),
                            **kwargs)
    return dev


def align_sharded(i1, i2, config: AlignConfig = AlignConfig(), p0=None, mesh=None,
                  tile_rows: bool = False, dtype: torch.dtype = torch.float32,
                  device=None) -> AlignResult:
    """Align this rank's pairs over the mesh.

    Args:
      i1, i2: [B, H, W, C] whole frames of THIS rank's pairs (the JAX
        package's multi-process contract): ranks of different pairs groups
        pass different pairs, every rank of a tile group the same ones.
        Tensors stay on their device; numpy input goes to `device`, this
        rank's card by default (as in `align`).
      p0: optional [B, k] or [B, 8] warm start.
      mesh: a ("pairs", "tile") mesh; default all ranks on pairs.
      tile_rows: split the rows over the tile axis (H divisible by it).

    Returns:
      AlignResult: p, error, niters and diverged of this rank's pairs
      (equal on every rank of its tile group); iw, di and valid of its
      rows (all rows without tile_rows). `gather_result` brings the
      per-pair fields of every pair to every rank.
    """
    config.validate()
    i1 = _to_tensor(i1, dtype, device)
    i2 = _to_tensor(i2, dtype, i1.device if device is None else device)
    if i1.shape != i2.shape or i1.ndim != 4:
        raise ValueError("I1 and I2 must both be [B, H, W, C]")
    if mesh is None:
        mesh = make_mesh(device_type=i1.device.type)
    b, hh = i1.shape[:2]
    p0 = (torch.zeros((b, 8), dtype=dtype, device=i1.device) if p0 is None
          else pad_params(_to_tensor(p0, dtype, i1.device)))
    if not tile_rows or axis_size(mesh, TILE_AXIS) == 1:
        return _align_impl(i1, i2, p0, config)

    y0, rows = row_span(mesh, hh)
    state, _ = tiled_pyramidal_solve(
        i1, i2, p0, config.transform, mesh=mesh,
        nscales=config.nscales, nu=config.nu, tol=config.tol, max_iter=config.max_iter,
        robust=config.robust, lam=config.lam, nanifoutside=config.nanifoutside,
        delta=config.delta, pyramid_method=config.pyramid_method,
        precondition=config.precondition, hessian_chunk=config.hessian_chunk,
        divergence_guard=config.divergence_guard, delta_cap=config.delta_cap)
    # The final warp of this rank's rows only, sampling the whole I2.
    return _final_warp(state, i1[:, y0:y0 + rows], i2, config, y_offset=y0)


def gather_result(res: AlignResult, mesh) -> dict:
    """{"p", "error", "niters", "diverged"} of every pair of the mesh, in
    pairs-group order, on every rank: each pairs group fills its slot of a
    zeroed global buffer, and one all-reduce over the pairs axis sums them
    (gloo on CUDA has no all_gather)."""
    n, r = axis_size(mesh, PAIRS_AXIS), mesh.get_local_rank(PAIRS_AXIS)
    b = res.p.shape[0]
    # Float64 holds every field exactly (niters and the flags as small
    # integers), so one buffer carries them all.
    mine = torch.cat([res.p, res.error[:, None], res.niters[:, None],
                      res.diverged[:, None]], dim=1).to(torch.float64)
    buf = torch.zeros((n, b, mine.shape[1]), dtype=torch.float64, device=res.p.device)
    buf[r] = mine
    if n > 1:
        dist.all_reduce(buf, group=mesh.get_group(PAIRS_AXIS))
    buf = buf.reshape(n * b, -1)
    return {"p": buf[:, :8].to(res.p.dtype), "error": buf[:, 8].to(res.error.dtype),
            "niters": buf[:, 9].to(res.niters.dtype), "diverged": buf[:, 10] != 0}
