"""Single-scale inverse-compositional Gauss-Newton solver.

One loop serves both algorithm variants of the reference:

  * quadratic IC: the Hessian is computed once, before the loop
    (reference src/inverse_compositional_algorithm.py:17-133, hoist at :102-103);
  * robust IRLS: per-iteration rho' weights and lambda annealing
    (reference src/inverse_compositional_algorithm.py:135-261).

Each pair converges, anneals and can be frozen by the divergence guard on
its own. The device of the images selects how the normal system of an
iteration is formed: on CUDA, for float32 with the preconditioner, by the
fused iteration kernel (K1, plus K4 for the quadratic Hessian); on the CPU,
and on CUDA for any other dtype or precondition=False, by the plain op
chain (warp -> residual -> weights -> hessian/rhs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import constants as cts
from ..ops.gradients import boundary_band_mask, central_gradients
from ..ops.kernels import _build
from ..ops.kernels.fused_iter import fused_iter_moments, plan_fused_iter
from ..ops.kernels.normal_eq import _assemble_b, _assemble_h, fused_hessian
from ..ops.normal_equations import (
    RobustLoss,
    grad_moments,
    hessian,
    residual_moments,
    rhs,
    robust_weights,
    solve_normal,
)
from ..ops.transforms import (
    TransformType,
    compose_inverse,
    jacobian_fields,
    nparams,
    pad_params,
    param_preconditioner,
    params_to_matrix,
    transform_grid,
    transform_points,
)
from ..ops.warp import bicubic_sample, domain_mask
from ..utils.profiling import span

__all__ = ["ICState", "ic_solve", "iterate", "effective_delta"]


@dataclass
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


def _lost_overlap(p: torch.Tensor, ttype: TransformType, height: int, width: int,
                  margin: float = 0.5) -> torch.Tensor:
    """[B] bool: every corner/center probe of x'(x; p) lands outside the frame
    inflated by `margin` of its size (or is non-finite), or p is non-finite."""
    xs = [0.0, width - 1.0, 0.0, width - 1.0, (width - 1) / 2.0]
    ys = [0.0, 0.0, height - 1.0, height - 1.0, (height - 1) / 2.0]
    gx, gy = transform_points(p, ttype, xs, ys)
    mx, my = margin * width, margin * height
    ok = (
        (gx >= -mx) & (gx <= (width - 1) + mx)
        & (gy >= -my) & (gy <= (height - 1) + my)
        & torch.isfinite(gx) & torch.isfinite(gy)
    )
    return ~ok.any(dim=-1) | ~torch.isfinite(p).all(dim=-1)


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
    """True when the solve forms its system by the kernels: every operand on
    CUDA, float32, with the preconditioner (the kernels form the
    preconditioned float32 system). Any other config runs the plain op
    chain on the operands' device, as JAX takes its XLA chain for it (JAX
    models/ic.py:212-213)."""
    return _build.use_kernel(i1, i2, p0) and precondition and i1.dtype == torch.float32


def _plain_system(i1, i2, ix, iy, gxx, gxy, gyy, ttype, robust, nanifoutside,
                  delta, scale, hessian_chunk, y_offset: int = 0, reduce=None):
    """Plain path (CPU; CUDA for float64 or precondition=False):
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


def _fused_system(i1, i2, ix, iy, gxx, gxy, gyy, ttype, robust, nanifoutside, delta,
                  scale=None, hessian_chunk: int = 16384, y_offset: int = 0, reduce=None):
    """CUDA path: system(p, lam) -> (H, b) in the preconditioned metric, from
    one fused-iteration kernel launch, which forms the sampling coordinates
    from the motion matrix itself (the quadratic Hessian comes from the
    moment kernel, once). On CPU tensors the same code runs the kernels'
    plain versions.

    For a band of rows y_offset .. of the frame i2 (`parallel.tiled`), K1
    takes the band's global rows and `reduce` sums its [B, K, 8, 8] moments
    over the tile group (JAX `parallel/tiled.py:208-226`). The moment kernel
    takes no row offset, so a band's quadratic Hessian is the plain
    `hessian` on global-row Jacobians (preconditioned by `scale`), reduced
    once."""
    _, h_loc, ww, _ = i1.shape
    hh = i2.shape[1]
    tiled = y_offset != 0 or reduce is not None
    reduce = reduce or _identity
    is_robust = robust is not RobustLoss.QUADRATIC
    plan = plan_fused_iter(i1, i2, ix, iy, gxx, gxy, gyy, robust=is_robust)
    h_quad = None
    if not is_robust and tiled:
        jx, jy = jacobian_fields(ttype, h_loc, ww, dtype=i1.dtype, scale=scale,
                                 y_offset=y_offset, device=i1.device)
        h_quad = reduce(hessian(gxx, gxy, gyy, jx, jy, chunk=hessian_chunk))
    elif not is_robust:
        h_quad = fused_hessian(gxx, gxy, gyy, ttype=ttype)
    projective = ttype is TransformType.HOMOGRAPHY

    def system(p, lam):
        m = reduce(fused_iter_moments(plan.i2p, plan.tplp, params_to_matrix(p, ttype), projective,
                                      lam, hh, ww, robust if is_robust else None, nanifoutside,
                                      delta, y_offset=y_offset))
        if is_robust:
            return (_assemble_h(m[:, :3], ttype, hh, ww),
                    _assemble_b(m[:, 3:], ttype, hh, ww))
        return h_quad, _assemble_b(m, ttype, hh, ww)

    return system


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
      divergence_guard: a pair whose warp lost the frame (_lost_overlap)
        reverts to p0, stops iterating and is flagged `diverged`.
      delta_cap: cap the boundary band per level (`effective_delta`).

    Returns:
      ICState, or (ICState, (error_hist, p_hist, lam_hist)) with collect_trace.

    The loop's condition reads `active` on the host: one device sync per
    iteration (the JAX package's lax.while_loop has none).
    """
    _, hh, ww, _ = i1.shape
    dt = i1.dtype
    fused = uses_kernels(i1, i2, p0, precondition)
    if delta_cap:
        delta = effective_delta(delta, hh, ww)

    with span("ica.level.setup"):
        ix, iy = central_gradients(i1)
        if nanifoutside and delta > 0:
            band = boundary_band_mask(hh, ww, delta, device=i1.device).to(dt)[None, :, :, None]
            ix = ix * band
            iy = iy * band
        gxx, gxy, gyy = grad_moments(ix, iy)

        scale = param_preconditioner(ttype, hh, ww) if precondition else None
        if fused:
            system = _fused_system(i1, i2, ix, iy, gxx, gxy, gyy, ttype, robust,
                                   nanifoutside, delta)
        else:
            system = _plain_system(i1, i2, ix, iy, gxx, gxy, gyy, ttype, robust,
                                   nanifoutside, delta, scale, hessian_chunk)
    return iterate(system, p0.to(dt), ttype, hh, ww, tol=tol, max_iter=max_iter, robust=robust,
                   lam=lam, scale=scale, divergence_guard=divergence_guard, verbose=verbose,
                   collect_trace=collect_trace)


def iterate(system, p0: torch.Tensor, ttype: TransformType, hh: int, ww: int, *, tol: float,
            max_iter: int, robust: RobustLoss, lam: float, scale, divergence_guard: bool,
            verbose: bool = False, collect_trace: bool = False, agree=None):
    """The Gauss-Newton loop of `ic_solve` over `system(p, lam) -> (H, b)`:
    the per-pair lambda anneal, the solve, the compose and the divergence
    guard, until no pair is active. `hh`, `ww` are the frame's dims (the
    guard's probes); `agree(still) -> still`, when given, makes the ranks of
    a row-tiled solve take one decision on which pairs go on
    (`parallel.tiled`)."""
    bsz = p0.shape[0]
    dt = p0.dtype
    is_robust = robust is not RobustLoss.QUADRATIC
    live = np.zeros(cts.NPARAMS_MAX, np.float64)
    live[: nparams(ttype)] = 1.0
    lam0 = lam if lam > 0 else cts.LAMBDA_0
    p0p = pad_params(p0)

    def anneal(lam_cur, act):
        if not is_robust or lam > 0:
            return lam_cur
        # Continuation: shrink lambda toward LAMBDA_N after rho, per pair and
        # only while that pair is still stepping.
        nxt = torch.where(lam_cur > cts.LAMBDA_N,
                          torch.clamp(lam_cur * cts.LAMBDA_RATIO, min=cts.LAMBDA_N),
                          lam_cur)
        return torch.where(act, nxt, lam_cur)

    def body(s: ICState) -> ICState:
        with span("ica.trip.system"):
            h, b = system(s.p, s.lam)
        with span("ica.trip.update"):
            act = s.active
            lam_next = anneal(s.lam, act)
            dp, err = solve_normal(h, b, live, precond=scale)
            p_new = compose_inverse(s.p, dp, ttype)
            if divergence_guard:
                bad = act & _lost_overlap(p_new, ttype, hh, ww)
                p_new = torch.where(bad[:, None], p0p, p_new)
            else:
                bad = torch.zeros_like(act)
            p = torch.where(act[:, None], p_new, s.p)
            error = torch.where(act, err, s.error)
            niters = s.niters + act.to(s.niters.dtype)
            still = act & (err > tol) & ~bad
            if s.it + 1 >= max_iter:
                still = torch.zeros_like(still)
            if agree is not None:
                still = agree(still)
            diverged = s.diverged | bad
        if verbose:
            print(f"iter {s.it}: |Dp|={error.tolist()} p={p.tolist()} "
                  f"lambda={lam_next.tolist()}")
        return ICState(p=p, error=error, lam=lam_next, it=s.it + 1, niters=niters,
                       active=still, diverged=diverged)

    dev = p0.device
    state = ICState(
        p=p0p,
        error=torch.full((bsz,), 1e10, dtype=dt, device=dev),
        lam=torch.full((bsz,), lam0, dtype=dt, device=dev),
        it=0,
        niters=torch.zeros((bsz,), dtype=torch.int32, device=dev),
        active=torch.ones((bsz,), dtype=torch.bool, device=dev),
        diverged=torch.zeros((bsz,), dtype=torch.bool, device=dev),
    )
    if collect_trace:
        hist = []
        for _ in range(max_iter):
            state = body(state)
            hist.append((state.error, state.p, state.lam))
        errs, ps, lams = zip(*hist)
        return state, (torch.stack(errs), torch.stack(ps), torch.stack(lams))
    with span("ica.trip.sync"):
        going = bool(state.active.any())   # the per-iteration host sync
    while going:
        with span("ica.trip"):
            state = body(state)
            with span("ica.trip.sync"):
                going = bool(state.active.any())
    return state
