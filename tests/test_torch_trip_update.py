"""The solver trip's update on the CPU: `trip_update_ref` against the
update the loop ran before the fused kernel (K6) existed, bit for bit;
`trip_update` on CPU tensors (assembly, then the plain version, in place);
and the kernel level's loop against the plain level's on the same
system, bit for bit, with no kernel launched. K6 itself runs only on a
card (tests/test_torch_gpu.py).
"""

import numpy as np
import pytest
import torch

from inverse_compositional_algorithm_tpu_torch import constants as cts
from inverse_compositional_algorithm_tpu_torch.models import ic as tic
from inverse_compositional_algorithm_tpu_torch.ops import gradients as tgr
from inverse_compositional_algorithm_tpu_torch.ops import normal_equations as tne
from inverse_compositional_algorithm_tpu_torch.ops import transforms as ttr
from inverse_compositional_algorithm_tpu_torch.ops.kernels import fused_iter as k1
from inverse_compositional_algorithm_tpu_torch.ops.kernels import trip_update as k6
from trip_cases import KINDS, MAX_ITER, SINGULAR_STEP, trip_case

torch.set_num_threads(1)

T = ttr.TransformType
R = tne.RobustLoss
STATE = ("p", "error", "lam", "niters", "active", "diverged")


def update_before_k6(h, b, s, ttype, hh, ww, *, tol, max_iter, anneal, scale, p0):
    """The body of models/ic.py::iterate's update as it stood before K6."""
    live = np.zeros(cts.NPARAMS_MAX, np.float64)
    live[: ttr.nparams(ttype)] = 1.0
    act = s.active
    lam_next = s.lam
    if anneal:
        nxt = torch.where(s.lam > cts.LAMBDA_N,
                          torch.clamp(s.lam * cts.LAMBDA_RATIO, min=cts.LAMBDA_N), s.lam)
        lam_next = torch.where(act, nxt, s.lam)
    dp, err = tne.solve_normal(h, b, live, precond=scale)
    p_new = ttr.compose_inverse(s.p, dp, ttype)
    bad = act & k6.lost_overlap(p_new, ttype, hh, ww)
    p_new = torch.where(bad[:, None], p0, p_new)
    p = torch.where(act[:, None], p_new, s.p)
    error = torch.where(act, err, s.error)
    niters = s.niters + act.to(s.niters.dtype)
    still = act & (err > tol) & ~bad
    if s.it + 1 >= max_iter:
        still = torch.zeros_like(still)
    return p, error, lam_next, niters, still, s.diverged | bad


def bitwise(a, b):
    """Equal dtypes, shapes and values (NaN where the other is NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    same = a == b
    if a.is_floating_point():
        same |= torch.isnan(a) & torch.isnan(b)
    return bool(same.all())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ttype", list(T), ids=[t.name for t in T])
def test_trip_update_ref_is_the_loops_update(ttype, kind):
    """trip_update_ref gives what the loop's update gave before K6, bit for
    bit, on the forced cases (singular H, a pair off the frame, a zero
    homogeneous scale) and on the last iteration."""
    for it in (3, MAX_ITER - 1):
        m, s, plan, (h, b) = trip_case(ttype, kind, 37, seed=7, it=it)
        got = k6.trip_update_ref(h, b, s, plan)
        want = update_before_k6(h, b, s, ttype, 4, 4, tol=1e-3, max_iter=MAX_ITER,
                                anneal=kind == "anneal",
                                scale=ttr.param_preconditioner(ttype, 4, 4), p0=plan.p0)
        for name, g, w in zip(STATE, got, want):
            assert bitwise(g, w), f"{name} differs"
        still, diverged = got[4], got[5]
        if it == MAX_ITER - 1:
            assert not bool(still.any())
        else:
            assert bool(still.any())
        assert bool(diverged[1]) and torch.equal(got[0][1], plan.p0[1])   # lost: reverted
        assert float(got[1][0]) == 0.0                                    # singular: dp = 0
        if kind == "quadratic" and ttype in SINGULAR_STEP:                # w = 0: p kept
            assert torch.equal(got[0][2], s.p[2]) and float(got[1][2]) == 1.0


@pytest.mark.parametrize("ttype", list(T), ids=[t.name for t in T])
def test_trip_update_on_cpu_takes_the_plain_version(ttype):
    """trip_update on CPU tensors: the einsum assembly and trip_update_ref,
    written in place with the next motion matrices and the count; no
    launch."""
    before = k6.LAUNCHES
    for kind in KINDS:
        m, s, plan, (h, b) = trip_case(ttype, kind, 37, seed=3, it=4)
        want = k6.trip_update_ref(h, b, s, plan)
        plan.count[1] = 99
        k6.trip_update(m, s, plan)
        for name, w in zip(STATE, want):
            assert bitwise(getattr(s, name), w), f"{kind}: {name} differs"
        assert torch.equal(plan.mat, ttr.params_to_matrix(want[0], ttype))
        assert plan.count.tolist() == [int(want[4].sum()), 0]
    assert k6.LAUNCHES == before


def _level(h=24, w=32, seed=5):
    rng = np.random.default_rng(seed)
    i2 = torch.tensor(rng.uniform(0, 255, (3, h, w, 3)), dtype=torch.float32)
    i2 = tgr.central_gradients(i2)[0] * 4.0 + 128.0
    i1 = torch.roll(i2, shifts=(1, -1), dims=(1, 2))
    ix, iy = tgr.central_gradients(i1)
    band = tgr.boundary_band_mask(h, w, 3)[None, ..., None]
    ix, iy = ix * band, iy * band
    return i1, i2, ix, iy, tne.grad_moments(ix, iy)


@pytest.mark.parametrize("robust,lam", [(R.CHARBONNIER, 0.0), (R.LORENTZIAN, 7.0),
                                        (R.QUADRATIC, 0.0)], ids=["anneal", "fixed", "quad"])
@pytest.mark.parametrize("ttype", list(T), ids=[t.name for t in T])
def test_fused_branch_of_the_loop_matches_its_plain_branch(ttype, robust, lam):
    """iterate over the kernel level (CPU tensors: K1's and K6's plain
    versions, the state written in place, the loop's check read from the
    count) gives the plain level's states over the same system assembled
    to (H, b), bit for bit, and neither launches a kernel."""
    i1, i2, ix, iy, g = _level()
    h, w = i1.shape[1:3]
    scale = ttr.param_preconditioner(ttype, h, w)
    fused = tic._fused_system(
        k1.plan_fused_iter(i1, i2, ix, iy, *g, robust=robust is not R.QUADRATIC), ttype, robust,
        True, 3)
    p0 = torch.zeros((3, 8))
    p0[0, 0] = 0.3
    p0_in = p0.clone()

    def run(level, system, **opts):
        plan = k6.plan_trip(p0, ttype, h, w, tol=1e-3, max_iter=12,
                            anneal=robust is not R.QUADRATIC and lam <= 0, scale=scale,
                            divergence_guard=True)
        level = level(system, plan, lam)
        return tic.iterate(level, level.start(), **opts)

    before = (k1.LAUNCHES, k6.LAUNCHES)
    got = run(tic._KernelLevel, fused)
    want = run(tic._Level, fused)
    assert (k1.LAUNCHES, k6.LAUNCHES) == before
    assert got.it == want.it > 1
    for name in STATE:
        assert bitwise(getattr(got, name), getattr(want, name)), name
    assert torch.equal(p0, p0_in)     # the in-place update leaves the caller's p0
    _, traced = run(tic._KernelLevel, fused, collect_trace=True)
    _, plain = run(tic._Level, fused, collect_trace=True)
    for a, b in zip(traced, plain):
        assert bitwise(a, b)


def test_ic_solve_on_cpu_launches_no_trip_update():
    """On CPU tensors ic_solve takes the plain update: K6's counter stays 0."""
    i1, i2, *_ = _level()
    before = k6.LAUNCHES
    st = tic.ic_solve(i1, i2, torch.zeros((3, 8)), T.AFFINITY, robust=R.CHARBONNIER)
    assert k6.LAUNCHES == before and st.it > 0


@pytest.mark.parametrize("fault", ["h_quad_shape", "h_quad_strided", "p0_strided", "p0_float64"])
def test_plan_trip_refuses_what_the_kernel_cannot_read(fault):
    """The kernel level's plan (`plan_kernel_trip`) holds the operands K6
    reads by pointer (p0, h_quad, the motion matrices) to K6's layout once a
    level: a wrong shape, stride or dtype raises there, before any trip."""
    bsz = 4
    p0 = torch.zeros((bsz, 8))
    h_quad = torch.eye(8).repeat(bsz, 1, 1)
    if fault == "h_quad_shape":
        h_quad = h_quad[:, :7, :7].contiguous()
    elif fault == "h_quad_strided":
        h_quad = h_quad.transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "p0_strided":
        p0 = torch.zeros((8, bsz)).T
    else:
        p0 = p0.double()
    def plan(p0, h_quad):
        return k6.plan_kernel_trip(
            k6.plan_trip(p0, T.HOMOGRAPHY, 4, 4, tol=1e-3, max_iter=MAX_ITER, anneal=False,
                         scale=ttr.param_preconditioner(T.HOMOGRAPHY, 4, 4),
                         divergence_guard=True), h_quad)

    with pytest.raises((TypeError, ValueError)):
        plan(p0, h_quad)
    ok = plan(torch.zeros((bsz, 8)), torch.eye(8).repeat(bsz, 1, 1))
    assert ok.count.tolist() == [0, 0] and ok.mat.shape == (bsz, 3, 3)
