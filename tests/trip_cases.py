"""Inputs of one solver trip's update for the tests of K6 (`trip_update`)
and of its plain version (`trip_update_ref`): K1-like moments, the state of
the loop and the level's plan, made with numpy from a seed. Imports nothing
of JAX (the card's tests use it).

The frame is 4 x 4 (L = 4) and every per-pixel weight a small integer, so
each moment and each entry of the assembled H and b is exact in float32:
the assembly gives the same H and b in any summation order, and the
updates can be held to each other after it. Pairs 0-2 of a batch of 3 or
more are forced cases: 0 has a singular H (dp must be 0), 1 sits 1000 px
off the frame (the guard reverts it to p0), 2 (quadratic path, the models
with a compose guard) takes a step whose homogeneous scale is 0.
"""

from __future__ import annotations

import numpy as np
import torch

from inverse_compositional_algorithm_tpu_torch.models.ic import ICState
from inverse_compositional_algorithm_tpu_torch.ops.kernels.normal_eq import (
    _assemble_b, _assemble_h, moments_ref,
)
from inverse_compositional_algorithm_tpu_torch.ops.kernels.trip_update import (
    plan_kernel_trip, plan_trip,
)
from inverse_compositional_algorithm_tpu_torch.ops.transforms import (
    TransformType, param_preconditioner,
)

T = TransformType
HH = WW = 4
L = max(HH, WW)
MAX_ITER = 30
KINDS = ("anneal", "fixed_lam", "quadratic")
# The parameter of the step that makes M(dp)'s linear part singular (its
# Jacobian column is x, read from the u moment at x^1 y^0).
SINGULAR_STEP = {T.SIMILARITY: 2, T.AFFINITY: 2, T.HOMOGRAPHY: 0}


def trip_case(ttype: TransformType, kind: str, bsz: int, seed: int, it: int,
              device="cpu"):
    """(m, state, plan, (h, b)) of one trip at loop iteration `it`: m
    [B, K, 8, 8] float32 moments (K = 5, or 2 for kind "quadratic", whose
    Hessian is plan.h_quad), the ICState before the update, the level's
    TripPlan for the kernel path, and the assembled system that
    `trip_update_ref` takes."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 3, (bsz, HH, WW)).astype(np.float64)
    c = rng.integers(0, 3, (bsz, HH, WW)).astype(np.float64)
    r = rng.choice([-0.5, 0.0, 0.5], (bsz, HH, WW))
    u, v = rng.integers(-3, 4, (2, bsz, HH, WW)).astype(np.float64)
    w1, w2, w3 = a * a, a * c * r, c * c
    if bsz >= 3:
        w1[0] = w2[0] = w3[0] = 0.0     # singular H on the robust path
    maps = torch.tensor(np.stack([w1, w2, w3, u, v], axis=1), dtype=torch.float32)
    full = moments_ref(maps, 1.0 / L)
    h_full = _assemble_h(full[:, :3], ttype, HH, WW)

    p = np.zeros((bsz, 8))
    n = ttype.n
    p[:, :n] = rng.uniform(-0.05, 0.05, (bsz, n))
    if ttype is T.HOMOGRAPHY:
        p[:, 6:8] *= 0.1
    p0 = p + rng.uniform(-0.02, 0.02, p.shape) * (np.arange(8) < n)
    quadratic = kind == "quadratic"
    h_quad = None
    if quadratic:
        m = full[:, 3:].clone()
        h_quad = h_full.clone()
        if bsz >= 3:
            h_quad[0] = 0.0                  # singular H
            if ttype in SINGULAR_STEP:       # b = -L e_k, H = I: dp_k = -1
                h_quad[2] = torch.eye(8)
                m[2] = 0.0
                m[2, 0, 0, 1] = -L
                p[2, 6:8] = 0.0
    else:
        m = full
    if bsz >= 3:
        tx = 2 if ttype is T.HOMOGRAPHY else 0
        p[1, tx] += 1000.0                   # lost the frame
    lam = rng.choice([80.0, 42.5, 5.5, 5.0], bsz)
    active = rng.uniform(size=bsz) > 0.2
    if bsz >= 3:
        active[:3] = True
    f32 = dict(dtype=torch.float32, device=device)
    state = ICState(
        p=torch.tensor(p, **f32), error=torch.tensor(rng.uniform(0, 1, bsz), **f32),
        lam=torch.tensor(lam, **f32), it=it,
        niters=torch.tensor(rng.integers(0, it + 1, bsz), dtype=torch.int32, device=device),
        active=torch.tensor(active, device=device),
        diverged=torch.tensor(rng.uniform(size=bsz) < 0.1, device=device))
    m = m.to(device)
    h_quad = None if h_quad is None else h_quad.to(device)
    plan = plan_kernel_trip(
        plan_trip(torch.tensor(p0, **f32), ttype, HH, WW, tol=1e-3, max_iter=MAX_ITER,
                  anneal=kind == "anneal", scale=param_preconditioner(ttype, HH, WW),
                  divergence_guard=True), h_quad)
    if quadratic:
        system = (h_quad, _assemble_b(m, ttype, HH, WW))
    else:
        system = (_assemble_h(m[:, :3], ttype, HH, WW), _assemble_b(m[:, 3:], ttype, HH, WW))
    return m, state, plan, system


def clone_state(s: ICState) -> ICState:
    return ICState(p=s.p.clone(), error=s.error.clone(), lam=s.lam.clone(), it=s.it,
                   niters=s.niters.clone(), active=s.active.clone(),
                   diverged=s.diverged.clone())
