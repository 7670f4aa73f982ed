"""Single-scale inverse-compositional Gauss-Newton solver.

One loop serves both algorithm variants of the reference:

  * quadratic IC: the Hessian is computed once, before the loop
    (reference src/inverse_compositional_algorithm.py:17-133, hoist at :102-103);
  * robust IRLS: per-iteration rho' weights and lambda annealing
    (reference src/inverse_compositional_algorithm.py:135-261).

Each pair converges, anneals and can be frozen by the divergence guard on
its own. `make_level` picks, once a level (`uses_kernels`), how the level
runs, and `iterate` runs either level with one loop body. On CUDA, for
float32 with the preconditioner, the kernel level: one launch of K7 packs
the level, K1 (plus K4 for the quadratic Hessian) forms each trip's system
and one launch of the fused update (K6) does the rest of the trip in
place. On the CPU, and on CUDA for any other dtype or precondition=False,
the plain level: the plain op chain (warp -> residual -> weights ->
hessian/rhs, then solve -> compose -> guard).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import constants as cts
from ..ops.kernels import _build
from ..ops.kernels.fused_iter import FusedIterPlan, bind_fused_iter, plan_fused_iter
from ..ops.kernels.level_pack import level_gradients, pack_level
from ..ops.kernels.normal_eq import _assemble_b, _assemble_h, weighted_moments
from ..ops.kernels.trip_update import (
    plan_kernel_trip,
    plan_trip,
    still_count,
    trip_update,
    trip_update_ref,
)
from ..ops.normal_equations import (
    RobustLoss,
    hessian,
    residual_moments,
    rhs,
    robust_weights,
)
from ..ops.transforms import (
    TransformType,
    jacobian_fields,
    pad_params,
    param_preconditioner,
    params_to_matrix,
    transform_grid,
)
from ..ops.warp import bicubic_sample, domain_mask
from ..utils.profiling import span

__all__ = ["ICState", "ic_solve", "make_level", "iterate", "effective_delta"]


@dataclasses.dataclass
class ICState:
    """Per-pair solver state."""

    p: torch.Tensor         # [B, 8] padded parameters
    error: torch.Tensor     # [B] last applied ||dp||
    lam: torch.Tensor       # [B] per-pair annealed lambda (robust only)
    it: int                 # loop iteration
    niters: torch.Tensor    # [B] int32 iterations actually applied per pair
    active: torch.Tensor    # [B] bool, pair still iterating
    diverged: torch.Tensor  # [B] bool, divergence guard tripped (p reverted to p0)


def effective_delta(delta: int, height: int, width: int) -> int:
    """Cap the boundary-band margin at a quarter of the short side, so small
    coarse pyramid levels keep an interior (the reference passes delta
    unchanged to every level, src/inverse_compositional_algorithm.py:340-372,
    which can mask every gradient pixel there)."""
    return min(int(delta), max(0, (min(height, width) - 1) // 4))


def _masked_residual(iw: torch.Tensor, valid: torch.Tensor, i1: torch.Tensor,
                     nanifoutside: bool) -> torch.Tensor:
    """DI = Iw - I1 with out-of-domain handling: nanifoutside=True zeroes
    invalid pixels; False gives them Iw = 0, so DI = -I1 there
    (reference src/bicubic_interpolation.py:134-147)."""
    if nanifoutside:
        return (iw - i1) * valid[..., None].to(iw.dtype)
    return torch.where(valid[..., None], iw, torch.zeros_like(iw)) - i1


def _identity(t):
    return t


def uses_kernels(i1: torch.Tensor, i2: torch.Tensor, p0: torch.Tensor,
                 precondition: bool) -> bool:
    """True when the level runs the kernels (`make_level`'s one choice of
    path): every operand on CUDA, float32, with the preconditioner (the
    kernels form the preconditioned float32 system). Any other config runs
    the plain op chain on the operands' device, as JAX takes its XLA chain
    for it (JAX models/ic.py:212-213)."""
    return _build.use_kernel(i1, i2, p0) and precondition and i1.dtype == torch.float32


def _plain_system(i1, i2, ix, iy, gxx, gxy, gyy, ttype, robust, nanifoutside,
                  delta, scale, hessian_chunk, y_offset: int = 0, reduce=None):
    """The plain level's system (CPU; CUDA for float64 or precondition=False):
    system(p, lam) -> (H [B,8,8], b [B,8]) by the plain op chain.

    i1 and its gradient maps may be the band of rows y_offset .. of the
    frame i2 (the row-tiled solver, `parallel.tiled`): the grid and the
    Jacobians then take global rows, and `reduce` sums H and b over the
    tile group in one all-reduce (JAX `parallel/tiled.py:227-248`)."""
    _, h_loc, ww, _ = i1.shape
    hh = i2.shape[1]
    reduce = reduce or _identity
    jx, jy = jacobian_fields(ttype, h_loc, ww, dtype=i1.dtype, scale=scale,
                             y_offset=y_offset, device=i1.device)
    is_robust = robust is not RobustLoss.QUADRATIC
    h_quad = (None if is_robust
              else reduce(hessian(gxx, gxy, gyy, jx, jy, chunk=hessian_chunk)))

    def system(p, lam):
        gx, gy = transform_grid(p, ttype, h_loc, ww, y_offset=y_offset)
        iw = bicubic_sample(i2, gx, gy)
        di = _masked_residual(iw, domain_mask(gx, gy, hh, ww, delta), i1, nanifoutside)
        u, v = residual_moments(ix, iy, di)
        if not is_robust:
            return h_quad, reduce(rhs(u, v, jx, jy))
        rho = robust_weights(di, lam[:, None, None], robust)
        h = hessian(gxx, gxy, gyy, jx, jy, weights=rho, chunk=hessian_chunk)
        hb = reduce(torch.cat([h.flatten(1), rhs(u, v, jx, jy, weights=rho)], dim=1))
        return hb[:, :64].reshape(h.shape), hb[:, 64:]

    return system


class _fused_system:
    """The kernel level's system, in the preconditioned metric, from one fused-
    iteration kernel launch, which forms the sampling coordinates from the
    motion matrix itself (the quadratic Hessian comes from the moment
    kernel, once), on a level's packed operands `plan` (`pack_level`, or
    `plan_fused_iter` for a band of rows). On CPU tensors the same code runs
    the kernels' plain versions.

    `moments(mat, lam)` launches K1 at [B, 3, 3] motion matrices into the
    level's one output and sums it over the tile group: the trip's system
    for the fused update (K6), with `h_quad`, the quadratic path's hoisted
    Hessian (None when robust). Called as system(p, lam), it gives the
    assembled (H, b) at parameters p, as `_plain_system`'s system does: the
    reference the tests hold the kernel level's loop against.

    For a band of rows y_offset .. of the frame i2 (`parallel.tiled`), K1
    takes the band's global rows and `reduce` sums its [B, K, 8, 8] moments
    over the tile group (JAX `parallel/tiled.py:208-226`). The moment kernel
    takes no row offset, so a band's quadratic Hessian is the plain
    `hessian` on global-row Jacobians (preconditioned by `scale`), reduced
    once."""

    def __init__(self, plan: FusedIterPlan, ttype, robust, nanifoutside, delta, scale=None,
                 hessian_chunk: int = 16384, y_offset: int = 0, reduce=None):
        hh, ww = plan.i2p.shape[2:]
        h_loc = plan.tplp.shape[2]
        tiled = y_offset != 0 or reduce is not None
        self._reduce = reduce = reduce or _identity
        self._ttype, self._hh, self._ww = ttype, hh, ww
        self._robust = robust if robust is not RobustLoss.QUADRATIC else None
        self.h_quad = None
        if self._robust is None and tiled:
            jx, jy = jacobian_fields(ttype, h_loc, ww, dtype=plan.tplp.dtype, scale=scale,
                                     y_offset=y_offset, device=plan.tplp.device)
            g = plan.gmom
            self.h_quad = reduce(hessian(g[:, 0], g[:, 1], g[:, 2], jx, jy, chunk=hessian_chunk))
        elif self._robust is None:
            self.h_quad = _assemble_h(weighted_moments(plan.gmom), ttype, hh, ww)
        self._k1 = bind_fused_iter(plan, ttype is TransformType.HOMOGRAPHY, hh, ww, self._robust,
                                   nanifoutside, delta, y_offset=y_offset)

    def moments(self, mat, lam):
        return self._reduce(self._k1(mat, lam))

    def __call__(self, p, lam):
        m = self.moments(params_to_matrix(p, self._ttype).contiguous(), lam)
        if self._robust is not None:
            return (_assemble_h(m[:, :3], self._ttype, self._hh, self._ww),
                    _assemble_b(m[:, 3:], self._ttype, self._hh, self._ww))
        return self.h_quad, _assemble_b(m, self._ttype, self._hh, self._ww)


class _Level:
    """The plain level: any system(p, lam) -> (H [B, 8, 8], b [B, 8]) and
    the plain update (`trip_update_ref`) on its `TripPlan`. `iterate` runs
    a level: `start()`, the first ICState; a trip, `system(s)` then
    `update(s, system, agree)`; `going(s)`, whether any pair goes on."""

    def __init__(self, system, plan, lam: float):
        self._system, self.plan, self._lam = system, plan, lam

    def start(self) -> ICState:
        p0 = self.plan.p0
        bsz, dt, dev = p0.shape[0], p0.dtype, p0.device
        return ICState(
            p=p0,
            error=torch.full((bsz,), 1e10, dtype=dt, device=dev),
            lam=torch.full((bsz,), self._lam if self._lam > 0 else cts.LAMBDA_0, dtype=dt,
                           device=dev),
            it=0,
            niters=torch.zeros((bsz,), dtype=torch.int32, device=dev),
            active=torch.ones((bsz,), dtype=torch.bool, device=dev),
            diverged=torch.zeros((bsz,), dtype=torch.bool, device=dev),
        )

    def system(self, s: ICState):
        return self._system(s.p, s.lam)

    def update(self, s: ICState, system, agree) -> ICState:
        p, error, lam, niters, still, diverged = trip_update_ref(*system, s, self.plan)
        if agree is not None:
            still = agree(still)
        return ICState(p=p, error=error, lam=lam, it=s.it + 1, niters=niters, active=still,
                       diverged=diverged)

    def going(self, s: ICState) -> bool:
        return bool(s.active.any())


class _KernelLevel(_Level):
    """The kernel level: K1's moments (a `_fused_system`) at the plan's
    motion matrices go to the fused update (K6, `trip_update`), which
    writes the state in place and counts the pairs that go on. A trip is
    K1, K6 and one read of that count."""

    def __init__(self, system: _fused_system, plan, lam: float):
        super().__init__(system, plan_kernel_trip(plan, system.h_quad), lam)

    def start(self) -> ICState:
        # The fused update writes p in place: never into the caller's p0.
        return dataclasses.replace(super().start(), p=self.plan.p0.clone())

    def system(self, s: ICState):
        return self._system.moments(self.plan.mat, s.lam)

    def update(self, s: ICState, system, agree) -> ICState:
        trip_update(system, s, self.plan)
        s = dataclasses.replace(s, it=s.it + 1)
        if agree is not None:
            # The vote keeps K6's still or raises, so K6's count stays the
            # count of the pairs that go on.
            s.active = agree(s.active)
        return s

    def going(self, s: ICState) -> bool:
        return super().going(s) if s.it == 0 else still_count(self.plan, s.it - 1) > 0


def make_level(i1: torch.Tensor, i2: torch.Tensor, p0: torch.Tensor, ttype: TransformType, *,
               tol: float, max_iter: int, robust: RobustLoss, lam: float, nanifoutside: bool,
               delta: int, precondition: bool, hessian_chunk: int, divergence_guard: bool,
               gradients=None, y_offset: int = 0, reduce=None) -> _Level:
    """The level of template i1 against the frame i2 from the warm start
    p0 (delta already capped): the kernel level, set up by K7
    (`pack_level`), when `uses_kernels`; else the plain level, set up by
    `level_gradients`. The row-tiled solver passes its halo `gradients` (as
    `level_gradients` gives them; K1's planes are then packed by
    `plan_fused_iter`), its band's `y_offset` and `reduce`."""
    hh, ww = i2.shape[1:3]
    is_robust = robust is not RobustLoss.QUADRATIC
    scale = param_preconditioner(ttype, hh, ww) if precondition else None
    fused = uses_kernels(i1, i2, p0, precondition)
    plan = plan_trip(pad_params(p0.to(i1.dtype)).contiguous(), ttype, hh, ww, tol=tol,
                     max_iter=max_iter, anneal=is_robust and lam <= 0, scale=scale,
                     divergence_guard=divergence_guard)
    if fused and gradients is None:
        packed = pack_level(i1.contiguous(), i2.contiguous(), delta, nanifoutside, is_robust)
    elif fused:
        ix, iy, g = gradients
        packed = plan_fused_iter(i1, i2, ix, iy, *g, robust=is_robust)
    else:
        ix, iy, g = gradients or level_gradients(i1, delta, nanifoutside)
        return _Level(_plain_system(i1, i2, ix, iy, *g, ttype, robust, nanifoutside, delta, scale,
                                    hessian_chunk, y_offset=y_offset, reduce=reduce), plan, lam)
    return _KernelLevel(_fused_system(packed, ttype, robust, nanifoutside, delta, scale,
                                      hessian_chunk, y_offset=y_offset, reduce=reduce), plan, lam)


def ic_solve(
    i1: torch.Tensor,
    i2: torch.Tensor,
    p0: torch.Tensor,
    ttype: TransformType,
    *,
    tol: float = 1e-3,
    max_iter: int = cts.MAX_ITER,
    robust: RobustLoss = RobustLoss.QUADRATIC,
    lam: float = 0.0,
    nanifoutside: bool = True,
    delta: int = 10,
    precondition: bool = True,
    hessian_chunk: int = 16384,
    verbose: bool = False,
    collect_trace: bool = False,
    divergence_guard: bool = True,
    delta_cap: bool = True,
):
    """Estimate p aligning I2 to I1 at a single scale.

    Args:
      i1, i2: [B, H, W, C] images, both on the CPU or both on CUDA. On
        CUDA, float32 with precondition=True runs the kernels (they form
        the preconditioned system); float64 or precondition=False runs the
        plain op chain there, as the CPU does.
      p0: [B, 8] padded warm start, on the images' device.
      robust: QUADRATIC selects the pure IC algorithm; anything else IRLS.
      lam: robust threshold; <= 0 enables the LAMBDA_0 -> LAMBDA_N annealing
        schedule (reference src/inverse_compositional_algorithm.py:223,235-238).
      collect_trace: run exactly max_iter steps and also return the history
        (error [T, B], p [T, B, 8], lam [T, B]); lambda is recorded after the
        anneal, the C++ verbose convention.
      divergence_guard: a pair whose warp lost the frame (`lost_overlap`)
        reverts to p0, stops iterating and is flagged `diverged`.
      delta_cap: cap the boundary band per level (`effective_delta`).

    Returns:
      ICState, or (ICState, (error_hist, p_hist, lam_hist)) with collect_trace.

    The loop's condition reads on the host whether any pair is active (on
    the kernel path, K6's count): one device sync per iteration (the JAX
    package's lax.while_loop has none).
    """
    if delta_cap:
        delta = effective_delta(delta, *i1.shape[1:3])
    with span("ica.level.setup"):
        level = make_level(i1, i2, p0, ttype, tol=tol, max_iter=max_iter, robust=robust, lam=lam,
                           nanifoutside=nanifoutside, delta=delta, precondition=precondition,
                           hessian_chunk=hessian_chunk, divergence_guard=divergence_guard)
        state = level.start()
    return iterate(level, state, verbose=verbose, collect_trace=collect_trace)


def iterate(level: _Level, state: ICState, *, verbose: bool = False,
            collect_trace: bool = False, agree=None):
    """The Gauss-Newton loop of `level` (`make_level`) from its first state:
    the per-pair lambda anneal, the solve, the compose and the divergence
    guard, until no pair is active. `agree(still) -> still`, when given,
    makes the ranks of a row-tiled solve take one decision on which pairs
    go on (`parallel.tiled`)."""

    def body(s: ICState) -> ICState:
        with span("ica.trip.system"):
            system = level.system(s)
        with span("ica.trip.update"):
            s = level.update(s, system, agree)
        if verbose:
            print(f"iter {s.it - 1}: |Dp|={s.error.tolist()} p={s.p.tolist()} "
                  f"lambda={s.lam.tolist()}")
        return s

    if collect_trace:
        hist = []
        for _ in range(level.plan.max_iter):
            state = body(state)
            # The fused update writes the same tensors every trip.
            hist.append((state.error.clone(), state.p.clone(), state.lam.clone()))
        errs, ps, lams = zip(*hist)
        return state, (torch.stack(errs), torch.stack(ps), torch.stack(lams))
    # The per-iteration host sync.
    with span("ica.trip.sync"):
        going_on = level.going(state)
    while going_on:
        with span("ica.trip"):
            state = body(state)
            with span("ica.trip.sync"):
                going_on = level.going(state)
    return state
