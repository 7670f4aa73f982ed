"""The solver trip's update (kernel K6): assemble -> anneal -> solve ->
compose -> divergence guard -> commit, for every pair in one launch.

After K1 has formed a trip's moments, the rest of the trip is per-pair
algebra on at most 8x8 numbers. `trip_update_ref` is that algebra as the
plain op chain (`solve_normal`, `compose_inverse`, `lost_overlap` and the
`where`s of the loop), on the normal system (H, b): the update of the CPU
path and of CUDA's float64 and precondition=False paths. `trip_update`
takes K1's moments instead and, on CUDA tensors, runs csrc/trip_update.cu,
which assembles H and b itself and writes the next state in place, the
next trip's motion matrix for K1 and the count of pairs that go on; on CPU
tensors it assembles with `normal_eq`'s einsums and takes
`trip_update_ref`.

A level's constants of the update (`TripPlan`, `plan_trip`) are made once,
before its first trip: the masks and scales as device tensors; the kernel
level adds K6's operands (`plan_kernel_trip`): the contraction tensors, the
motion matrices and the two counters.
"""

from __future__ import annotations

import dataclasses

import torch

from ... import constants as cts
from ..normal_equations import solve_normal
from ..transforms import TransformType, compose_inverse, nparams, params_to_matrix, transform_points
from . import _build
from .normal_eq import _assemble_b, _assemble_h, _assembly_tensors

__all__ = ["TripPlan", "plan_trip", "plan_kernel_trip", "trip_update", "trip_update_ref",
           "lost_overlap", "still_count", "LAUNCHES"]

# Number of times `trip_update` launched its CUDA kernel.
LAUNCHES = 0
# The divergence guard's margin: a probe counts as inside while it lies
# within the frame inflated by this share of its size.
GUARD_MARGIN = 0.5


def lost_overlap(p: torch.Tensor, ttype: TransformType, height: int, width: int,
                 margin: float = GUARD_MARGIN) -> torch.Tensor:
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


@dataclasses.dataclass
class TripPlan:
    """A level's loop-invariant operands of the update.

    live: [8] 0/1 mask of the model's parameters; scale: [8] preconditioner
    or None; p0: [B, 8] the warm start the guard reverts to. With K6's
    operands (`plan_kernel_trip`) also the contraction tensors t_h (robust)
    and t_b, the hoisted quadratic Hessian h_quad, the motion matrices `mat`
    [B, 3, 3] that each update writes for the next K1, and `count` [2]
    int32, the pairs still active after trip `it` in count[it % 2]."""

    ttype: TransformType
    height: int
    width: int
    tol: float
    max_iter: int
    anneal: bool
    guard: bool
    live: torch.Tensor
    scale: torch.Tensor | None
    p0: torch.Tensor
    t_h: torch.Tensor | None = None
    t_b: torch.Tensor | None = None
    h_quad: torch.Tensor | None = None
    mat: torch.Tensor | None = None
    count: torch.Tensor | None = None


def plan_trip(p0: torch.Tensor, ttype: TransformType, height: int, width: int, *, tol: float,
              max_iter: int, anneal: bool, scale, divergence_guard: bool) -> TripPlan:
    """The TripPlan of a level: p0 [B, 8] padded; scale the [8] numpy
    preconditioner or None; anneal for a robust loss with lam <= 0."""
    dt, dev = p0.dtype, p0.device
    live = torch.zeros(cts.NPARAMS_MAX, dtype=dt)
    live[: nparams(ttype)] = 1.0
    return TripPlan(ttype=ttype, height=height, width=width, tol=tol, max_iter=max_iter,
                    anneal=anneal, guard=divergence_guard, live=live.to(dev),
                    scale=None if scale is None else torch.as_tensor(scale, dtype=dt, device=dev),
                    p0=p0)


def plan_kernel_trip(plan: TripPlan, h_quad: torch.Tensor | None = None) -> TripPlan:
    """`plan` with the operands of `trip_update` (h_quad: the quadratic
    path's [B, 8, 8] Hessian, None on the robust path), each checked to the
    layout K6 reads by pointer."""
    p0 = plan.p0
    dt, dev = p0.dtype, p0.device
    if plan.scale is None or dt != torch.float32:
        raise ValueError("the fused update takes the preconditioned float32 system")
    bsz = p0.shape[0]
    _build.check_operand(p0, "p0", (bsz, cts.NPARAMS_MAX))
    if h_quad is not None:
        _build.check_operand(h_quad, "h_quad", (bsz, cts.NPARAMS_MAX, cts.NPARAMS_MAX))
    t_h, t_b = _assembly_tensors(plan.ttype, plan.height, plan.width, dev, dt)
    mat = params_to_matrix(p0, plan.ttype).contiguous()
    _build.check_operand(mat, "mat", (bsz, 3, 3))
    return dataclasses.replace(plan, t_h=t_h if h_quad is None else None, t_b=t_b,
                               h_quad=h_quad, mat=mat,
                               count=torch.zeros(2, dtype=torch.int32, device=dev))


def _anneal(lam: torch.Tensor, act: torch.Tensor, plan: TripPlan) -> torch.Tensor:
    if not plan.anneal:
        return lam
    # Continuation: shrink lambda toward LAMBDA_N after rho, per pair and
    # only while that pair is still stepping.
    nxt = torch.where(lam > cts.LAMBDA_N, torch.clamp(lam * cts.LAMBDA_RATIO, min=cts.LAMBDA_N),
                      lam)
    return torch.where(act, nxt, lam)


def trip_update_ref(h: torch.Tensor, b: torch.Tensor, s, plan: TripPlan):
    """One trip's update of state `s` (an ICState) from its system H [B, 8, 8],
    b [B, 8], by the plain op chain. Returns the next (p, error, lam,
    niters, still, diverged) as new tensors; `s` is left as it was."""
    act = s.active
    lam = _anneal(s.lam, act, plan)
    dp, err = solve_normal(h, b, plan.live, precond=plan.scale)
    p_new = compose_inverse(s.p, dp, plan.ttype)
    if plan.guard:
        bad = act & lost_overlap(p_new, plan.ttype, plan.height, plan.width)
        p_new = torch.where(bad[:, None], plan.p0, p_new)
    else:
        bad = torch.zeros_like(act)
    p = torch.where(act[:, None], p_new, s.p)
    error = torch.where(act, err, s.error)
    niters = s.niters + act.to(s.niters.dtype)
    still = act & (err > plan.tol) & ~bad
    if s.it + 1 >= plan.max_iter:
        still = torch.zeros_like(still)
    return p, error, lam, niters, still, s.diverged | bad


def trip_update(m: torch.Tensor, s, plan: TripPlan) -> None:
    """One trip's update of state `s` (an ICState at trip s.it) in place, from
    K1's moments m [B, K, 8, 8] (K = 5 robust, 2 quadratic with
    plan.h_quad): s.p, s.error, s.lam, s.niters, s.active (now: the pairs
    that go on), s.diverged, plan.mat (the motion matrices of the new p)
    and plan.count[s.it % 2] (the pairs that go on); plan.count[(s.it + 1)
    % 2] is set to 0. `s.it` is left for the caller.

    CUDA tensors launch csrc/trip_update.cu (float32); CPU tensors assemble
    H and b by `normal_eq`'s einsums and take `trip_update_ref`."""
    global LAUNCHES
    cur = s.it % 2
    robust = plan.h_quad is None
    if not _build.use_kernel(m, s.p):
        ttype, hh, ww = plan.ttype, plan.height, plan.width
        if robust:
            h, b = _assemble_h(m[:, :3], ttype, hh, ww), _assemble_b(m[:, 3:], ttype, hh, ww)
        else:
            h, b = plan.h_quad, _assemble_b(m, ttype, hh, ww)
        new = trip_update_ref(h, b, s, plan)
        for dst, src in zip((s.p, s.error, s.lam, s.niters, s.active, s.diverged), new):
            dst.copy_(src)
        plan.mat.copy_(params_to_matrix(s.p, ttype))
        plan.count[cur] = new[4].sum()
        plan.count[1 - cur] = 0
        return
    bsz = s.p.shape[0]
    _build.check_operand(m, "m", (bsz, 5 if robust else 2, 8, 8))
    _build.check_operand(s.p, "p", (bsz, 8))
    _build.check_operand(s.error, "error", (bsz,))
    _build.check_operand(s.lam, "lam", (bsz,))
    _build.check_operand(s.niters, "niters", (bsz,), torch.int32)
    _build.check_operand(s.active, "active", (bsz,), torch.bool)
    _build.check_operand(s.diverged, "diverged", (bsz,), torch.bool)
    mx, my = GUARD_MARGIN * plan.width, GUARD_MARGIN * plan.height
    _build.launch("ica_trip_update", m, plan.t_h, plan.t_b, plan.h_quad, plan.live, plan.scale,
                  plan.p0, s.p, s.error, s.lam, s.niters, s.active, s.diverged, plan.mat,
                  plan.count, bsz, m.shape[1], plan.ttype.value, int(plan.anneal),
                  int(plan.guard), int(s.it + 1 >= plan.max_iter), cur, plan.height, plan.width,
                  plan.tol, cts.LAMBDA_N, cts.LAMBDA_RATIO, -mx, (plan.width - 1) + mx, -my,
                  (plan.height - 1) + my)
    LAUNCHES += 1


def still_count(plan: TripPlan, it: int) -> int:
    """The pairs that went on after trip `it`'s `trip_update` (one read of
    the device's counter: the host waits for the trip)."""
    return int(plan.count[it % 2])
