"""Row-tiled (spatial) solver with explicit collectives on torch.distributed.

The ranks of a tile group hold the same pairs, each one band of the
template's rows, and together solve one system per pair: each forms the
partial normal equations of its rows, and only the small per-pair system
crosses between ranks (the Schur-style layout of the JAX package's
`parallel/tiled.py`, where images are big and the reduced system tiny).

What crosses, per solve at one level:
  * the gradient halo: the y central difference needs the row above and
    the row below the band; exchanged once;
  * the quadratic Hessian (QUADRATIC only): one all-reduce, once;
  * per iteration: ONE all-reduce, of the [B, K, 8, 8] moment partials of
    the fused iteration kernel (K1) on CUDA, or of H and b on the plain
    path; and the tiny [B] vector of which pairs go on, because the loop
    runs on the host and every rank of the group must leave it on the same
    trip (the JAX program's loop runs on the devices and needs no such
    vote).

The moving image I2 is whole on every rank: a parametric warp can sample
anywhere in the frame, so only the output (template) rows are local. Row
indices are global everywhere: the gradients' border and delta band, K1's
coordinates and moments (`y_offset`), the Jacobians, and the assembly,
which takes the full frame's dims. The systems and the loop are
`models.ic`'s, given the band's `y_offset` and the tile group's
all-reduce.

Every collective is an all-reduce (a halo is an all-reduce of a zeroed
buffer in which each rank fills its own slot), so the same code runs on
NCCL, one rank per card, and on gloo: CPU tensors, or several ranks that
share one card (gloo takes CUDA tensors only in all-reduce and broadcast,
and NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import constants as cts
from ..models.ic import (
    ICState,
    _fused_system,
    _plain_system,
    effective_delta,
    ic_solve,
    iterate,
)
from ..ops.gradients import boundary_band_mask
from ..ops.kernels import _build
from ..ops.normal_equations import RobustLoss, grad_moments
from ..ops.pyramid import build_pyramid, pyramid_shapes
from ..ops.transforms import TransformType, pad_params, param_preconditioner, zoom_in_params
from .mesh import PAIRS_AXIS, TILE_AXIS, axis_size, row_span

__all__ = ["halo_gradients", "exchange_halo", "tiled_ic_solve", "tiled_pyramidal_solve"]


def halo_gradients(i1_loc: torch.Tensor, top: torch.Tensor, bottom: torch.Tensor, y0: int,
                   height: int, delta: int, nanifoutside: bool):
    """Central-difference gradients (ix, iy) [B, h, W, C] of a row band.

    i1_loc: [B, h, W, C], rows y0 .. y0 + h - 1 of a frame `height` rows
    tall; top, bottom: [B, W, C], the frame's rows y0 - 1 and y0 + h (any
    value where they fall outside the frame). Rows at the frame's border
    get iy = 0 (ops.gradients.central_gradients), and with nanifoutside the
    delta band is applied in global rows (JAX `parallel/tiled.py:75-115`).
    """
    dt = i1_loc.dtype
    _, h_loc, w, _ = i1_loc.shape
    ix = F.pad(0.5 * (i1_loc[:, :, 2:] - i1_loc[:, :, :-2]), (0, 0, 1, 1))
    above = torch.cat([top[:, None], i1_loc[:, :-1]], dim=1)
    below = torch.cat([i1_loc[:, 1:], bottom[:, None]], dim=1)
    rows = torch.arange(h_loc, device=i1_loc.device) + y0
    interior = ((rows >= 1) & (rows <= height - 2)).to(dt)
    iy = 0.5 * (below - above) * interior[None, :, None, None]
    if nanifoutside and delta > 0:
        band = boundary_band_mask(h_loc, w, delta, y_offset=y0, full_height=height,
                                  device=i1_loc.device).to(dt)[None, :, :, None]
        ix = ix * band
        iy = iy * band
    return ix, iy


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce over `group`; None (a group of one) is a no-op."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def _tile_group(mesh):
    return mesh.get_group(TILE_AXIS) if axis_size(mesh, TILE_AXIS) > 1 else None


def exchange_halo(i1_loc: torch.Tensor, mesh):
    """(top, bottom) [B, W, C]: the last row of the band above and the first
    row of the band below (zeros at the frame's border), by one all-reduce
    of a zeroed [nt, 2, B, W, C] buffer in which each rank fills its slot."""
    nt, r = axis_size(mesh, TILE_AXIS), mesh.get_local_rank(TILE_AXIS)
    zeros = torch.zeros_like(i1_loc[:, 0])
    if nt == 1:
        return zeros, zeros
    buf = torch.zeros((nt, 2) + tuple(zeros.shape), dtype=i1_loc.dtype, device=i1_loc.device)
    buf[r, 0] = i1_loc[:, 0]
    buf[r, 1] = i1_loc[:, -1]
    _all_reduce(buf, _tile_group(mesh))
    return (buf[r - 1, 1] if r > 0 else zeros), (buf[r + 1, 0] if r < nt - 1 else zeros)


def tiled_ic_solve(
    i1_loc: torch.Tensor,
    i2: torch.Tensor,
    p0: torch.Tensor,
    ttype: TransformType,
    *,
    mesh,
    tol: float = 1e-3,
    max_iter: int = cts.MAX_ITER,
    robust: RobustLoss = RobustLoss.QUADRATIC,
    lam: float = 0.0,
    nanifoutside: bool = True,
    delta: int = 10,
    precondition: bool = True,
    hessian_chunk: int = 16384,
    divergence_guard: bool = True,
    delta_cap: bool = True,
) -> ICState:
    """Single-scale IC/IRLS solve of this rank's pairs, row-tiled over the
    mesh's tile axis: `models.ic.ic_solve`'s result up to float summation
    order, per-pair lambda and divergence guard included.

    Args:
      i1_loc: [B, H/nt, W, C], this rank's band of the template, rows
        r*H/nt .. (r+1)*H/nt - 1 for tile index r.
      i2: [B, H, W, C], the whole moving image of the same pairs.
      p0: [B, 8] warm start. All three on one device: CUDA tensors
        (float32, precondition=True) run K1 per iteration, CPU tensors the
        plain op chain. Every rank of a tile group passes the same pairs.
      mesh: a ("pairs", "tile") mesh (`parallel.mesh.make_mesh`).
      Other arguments as in `ic_solve`.

    Returns:
      ICState of this rank's pairs, equal on every rank of its tile group;
      `it` is the maximum trip count over the pairs axis.
    """
    bsz, h_loc, ww, _ = i1_loc.shape
    hh = i2.shape[1]
    nt = axis_size(mesh, TILE_AXIS)
    if hh % nt:
        raise ValueError(f"H={hh} not divisible by tile axis size {nt}")
    if (i2.shape[0], h_loc, i2.shape[2]) != (bsz, hh // nt, ww):
        raise ValueError(f"i1_loc {tuple(i1_loc.shape)} is not a {nt}-way row band of "
                         f"i2 {tuple(i2.shape)}")
    dt = i1_loc.dtype
    fused = _build.use_kernel(i1_loc, i2, p0)
    if fused and not (dt == torch.float32 and precondition):
        raise ValueError("the CUDA path takes float32 images and precondition=True")
    if delta_cap:
        delta = effective_delta(delta, hh, ww)
    y0, _ = row_span(mesh, hh)
    group = _tile_group(mesh)

    def reduce(t):
        return _all_reduce(t.contiguous(), group)

    def agree(still):
        # The ranks of the group leave the loop together: count the ranks
        # that go on per pair, and fail loudly should they ever disagree.
        if group is None:
            return still
        n = _all_reduce(still.to(torch.int32), group)
        if bool(((n > 0) & (n < nt)).any()):
            raise RuntimeError(f"the tile ranks disagree on which pairs go on: {n.tolist()}")
        return n == nt

    ix, iy = halo_gradients(i1_loc, *exchange_halo(i1_loc, mesh), y0, hh, delta, nanifoutside)
    g = grad_moments(ix, iy)
    scale = param_preconditioner(ttype, hh, ww) if precondition else None
    make = _fused_system if fused else _plain_system
    system = make(i1_loc, i2, ix, iy, *g, ttype, robust, nanifoutside, delta, scale,
                  hessian_chunk, y_offset=y0, reduce=reduce)
    state = iterate(system, p0.to(dt), ttype, hh, ww, tol=tol, max_iter=max_iter,
                    robust=robust, lam=lam, scale=scale, divergence_guard=divergence_guard,
                    agree=agree)
    return _max_trips_over_pairs(state, mesh)


def _max_trips_over_pairs(state: ICState, mesh) -> ICState:
    """Each pairs group ran its own trip count: `it` becomes the largest,
    as the JAX program's replicated `it` (one all-reduce, after the loop)."""
    if axis_size(mesh, PAIRS_AXIS) > 1:
        it = torch.tensor([state.it], dtype=torch.int64, device=state.p.device)
        state.it = int(_all_reduce(it, mesh.get_group(PAIRS_AXIS), dist.ReduceOp.MAX))
    return state


def tiled_pyramidal_solve(
    i1: torch.Tensor,
    i2: torch.Tensor,
    p0: torch.Tensor,
    ttype: TransformType,
    *,
    mesh,
    nscales: int = 5,
    nu: float = 0.5,
    tol: float = 1e-3,
    max_iter: int = cts.MAX_ITER,
    robust: RobustLoss = RobustLoss.QUADRATIC,
    lam: float = 0.0,
    nanifoutside: bool = True,
    delta: int = 10,
    pyramid_method: str = "ipol",
    precondition: bool = True,
    hessian_chunk: int = 16384,
    divergence_guard: bool = True,
    delta_cap: bool = True,
):
    """Coarse-to-fine pyramid over the row-tiled solver.

    `models.pyramidal.pyramidal_solve`'s semantics, with each level solved
    by `tiled_ic_solve` on this rank's band when the tile axis divides the
    level's height (the large levels, where sharding rows pays), and by the
    single-device `ic_solve` on the whole level on every rank otherwise.
    i1, i2: [B, H, W, C], this rank's pairs, whole frames (the pyramid is
    built whole on every rank of the tile group). Returns (state,
    per_scale), per_scale coarsest first; every level's `it` is the
    maximum over the pairs axis.
    """
    _, hh, ww, _ = i1.shape
    nt = axis_size(mesh, TILE_AXIS)
    shapes = pyramid_shapes(hh, ww, nscales, nu)
    pyr1 = build_pyramid(i1, nscales, nu, pyramid_method)
    pyr2 = build_pyramid(i2, nscales, nu, pyramid_method)

    p = pad_params(p0.to(i1.dtype))
    for s in range(1, nscales):
        (fh, fw), (ch, cw) = shapes[s - 1], shapes[s]
        p = zoom_in_params(p, ttype, fw, fh, cw, ch)

    kw = dict(tol=tol, max_iter=max_iter, robust=robust, lam=lam, nanifoutside=nanifoutside,
              delta=delta, precondition=precondition, hessian_chunk=hessian_chunk,
              divergence_guard=divergence_guard, delta_cap=delta_cap)
    per_scale = []
    state = None
    for s in range(nscales - 1, -1, -1):
        lh = shapes[s][0]
        if lh % nt == 0:
            y0, rows = row_span(mesh, lh)
            state = tiled_ic_solve(pyr1[s][:, y0:y0 + rows], pyr2[s], p, ttype, mesh=mesh, **kw)
        else:
            state = _max_trips_over_pairs(ic_solve(pyr1[s], pyr2[s], p, ttype, **kw), mesh)
        per_scale.append(state)
        if s > 0:
            (fh, fw), (ch, cw) = shapes[s - 1], shapes[s]
            p = zoom_in_params(state.p, ttype, cw, ch, fw, fh)
    return state, per_scale
