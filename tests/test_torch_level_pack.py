"""The level set-up's packing (K7, `ops/kernels/level_pack.py`) on the CPU:
its plain version is the set-up's op chain, `pack_level` takes it for CPU
tensors without a launch, and `ic_solve` packs each level through it.

The kernel itself runs only on a card (tests/test_torch_gpu.py::
test_level_pack).
"""

import numpy as np
import pytest
import torch

from inverse_compositional_algorithm_tpu_torch.models import ic as tic
from inverse_compositional_algorithm_tpu_torch.ops import gradients as tgr
from inverse_compositional_algorithm_tpu_torch.ops import normal_equations as tne
from inverse_compositional_algorithm_tpu_torch.ops import transforms as ttr
from inverse_compositional_algorithm_tpu_torch.ops.kernels import fused_iter as k1
from inverse_compositional_algorithm_tpu_torch.ops.kernels import level_pack as k7
from inverse_compositional_algorithm_tpu_torch.ops.kernels import trip_update as k6

T = ttr.TransformType
R = tne.RobustLoss
H, W = 49, 73          # ragged: no dimension a multiple of 4


def images(c, b=2, h=H, w=W, seed=3):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.uniform(0, 255, (b, h, w, c)), dtype=torch.float32)
                 for _ in range(2))


def chain(i1, i2, delta, nanifoutside, robust):
    """The level set-up of models/ic.py::ic_solve before K7, as it stood."""
    _, hh, ww, _ = i1.shape
    ix, iy = tgr.central_gradients(i1)
    if nanifoutside and delta > 0:
        band = tgr.boundary_band_mask(hh, ww, delta).to(i1.dtype)[None, :, :, None]
        ix = ix * band
        iy = iy * band
    gxx, gxy, gyy = tne.grad_moments(ix, iy)
    return k1.plan_fused_iter(i1, i2, ix, iy, gxx, gxy, gyy, robust=robust)


def bitwise(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


def same_plan(got, want):
    assert bitwise(got.tplp, want.tplp) and bitwise(got.i2p, want.i2p)
    assert (got.gmom is None) == (want.gmom is None)
    assert got.gmom is None or bitwise(got.gmom, want.gmom)


DELTAS = {"delta0": 0, "delta1": 1, "capped": tic.effective_delta(30, H, W)}


@pytest.mark.parametrize("delta", list(DELTAS.values()), ids=list(DELTAS))
@pytest.mark.parametrize("nanifoutside", [True, False], ids=["nan", "zero"])
@pytest.mark.parametrize("robust", [True, False], ids=["robust", "quadratic"])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_pack_level_ref_is_the_chain(c, robust, nanifoutside, delta):
    """pack_level_ref gives the set-up chain's planes bit for bit, laid out
    as K1 reads them: i1, ix, iy (C planes each), then the moments when
    robust (P = 3C + 3), else P = 3C and the moments apart; i2 in planes."""
    i1, i2 = images(c)
    got = k7.pack_level_ref(i1, i2, delta, nanifoutside, robust)
    same_plan(got, chain(i1, i2, delta, nanifoutside, robust))
    assert got.tplp.shape == (2, 3 * c + 3 if robust else 3 * c, H, W)
    assert got.tplp.is_contiguous() and got.i2p.is_contiguous()
    assert bitwise(got.tplp[:, :c], i1.permute(0, 3, 1, 2).contiguous())
    assert bitwise(got.i2p, i2.permute(0, 3, 1, 2).contiguous())
    moments = got.tplp[:, 3 * c:] if robust else got.gmom
    assert moments.shape == (2, 3, H, W) and (robust or moments.is_contiguous())
    # The gradients' definition, in float32 as the kernel forms it.
    a = i1.numpy()
    ix = np.zeros_like(a)
    iy = np.zeros_like(a)
    ix[:, :, 1:-1] = np.float32(0.5) * (a[:, :, 2:] - a[:, :, :-2])
    iy[:, 1:-1] = np.float32(0.5) * (a[:, 2:] - a[:, :-2])
    if nanifoutside and delta > 0:
        band = np.zeros((H, W), np.float32)
        band[delta:H - delta, delta:W - delta] = 1.0
        ix, iy = ix * band[None, :, :, None], iy * band[None, :, :, None]
    np.testing.assert_array_equal(got.tplp[:, c:2 * c].numpy(), ix.transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(got.tplp[:, 2 * c:3 * c].numpy(), iy.transpose(0, 3, 1, 2))
    for m, (u, v) in zip(moments.numpy().transpose(1, 0, 2, 3), [(ix, ix), (ix, iy), (iy, iy)]):
        np.testing.assert_allclose(m, (u.astype(np.float64) * v).sum(-1), rtol=2e-6, atol=1e-3)


def test_pack_level_takes_the_plain_version_on_cpu():
    """CPU tensors: pack_level is pack_level_ref, bit for bit, with no launch
    (the counter stays 0 whatever the channels, loss or band)."""
    k7.LAUNCHES = 0
    for c, robust, nanifoutside in [(3, True, True), (1, False, True), (4, True, False)]:
        i1, i2 = images(c)
        same_plan(k7.pack_level(i1, i2, 5, nanifoutside, robust),
                  k7.pack_level_ref(i1, i2, 5, nanifoutside, robust))
    assert k7.LAUNCHES == 0


@pytest.mark.parametrize("robust", [True, False], ids=["robust", "quadratic"])
def test_moment_gap_measures_in_units_of_the_magnitude_sum(robust):
    """moment_gap reads 0 on equal plans; the moments summed over the
    channels backwards (another float32 order) lie within its 2(C - 1)
    units, at the largest absolute difference; a moment off where its
    products are all 0 reads far beyond them. Chunks of one pair read as
    one chunk of all."""
    c = 3
    i1, i2 = images(c)
    ref = k7.pack_level_ref(i1, i2, 0, False, robust)
    assert k7.moment_gap(ref, ref) == (0.0, 0.0)
    ix, iy = ref.tplp[:, c:2 * c], ref.tplp[:, 2 * c:3 * c]
    back = torch.stack([(u[:, 2] * v[:, 2] + u[:, 1] * v[:, 1]) + u[:, 0] * v[:, 0]
                        for u, v in [(ix, ix), (ix, iy), (iy, iy)]], dim=1)
    tplp, gmom = ref.tplp.clone(), None if robust else ref.gmom.clone()
    moments = tplp[:, 3 * c:] if robust else gmom
    want = (back.double() - moments.double()).abs().max()
    moments.copy_(back)
    got = k1.FusedIterPlan(i2p=ref.i2p, tplp=tplp, gmom=gmom)
    units, err = k7.moment_gap(got, ref)
    assert units <= 2 * (c - 1) and err == float(want)
    assert k7.moment_gap(got, ref, chunk=1) == (units, err)
    moments.copy_(ref.tplp[:, 3 * c:] if robust else ref.gmom)
    moments[1, 2, 9, 9] = torch.nextafter(moments[1, 2, 9, 9], torch.tensor(np.inf))
    assert 0.0 < k7.moment_gap(got, ref)[0] <= 2.0      # one ulp: at most 2 units
    moments[0, 1, 0, 0] = 1e-30          # the border: ix = iy = 0
    assert k7.moment_gap(got, ref)[0] > 1e200


def level(b=3, h=24, w=32, c=3, seed=5):
    """A level whose I1 is I2 moved by a pixel, so the solve has work."""
    rng = np.random.default_rng(seed)
    i2 = torch.tensor(rng.uniform(0, 255, (b, h, w, c)), dtype=torch.float32)
    i2 = tgr.central_gradients(i2)[0] * 4.0 + 128.0
    return torch.roll(i2, shifts=(1, -1), dims=(1, 2)), i2


def same_state(a, b):
    for f in ("p", "error", "lam", "niters", "active", "diverged"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.it == b.it


ROBUST = [(R.CHARBONNIER, 0.0), (R.LORENTZIAN, 7.0), (R.QUADRATIC, 0.0)]


def plan(p0, ttype, h, w, robust, lam, scale):
    """The level's TripPlan as `ic_solve` makes it at tol 1e-3, 12 iterations."""
    return k6.plan_trip(p0, ttype, h, w, tol=1e-3, max_iter=12,
                        anneal=robust is not R.QUADRATIC and lam <= 0, scale=scale,
                        divergence_guard=True)


@pytest.mark.parametrize("robust,lam", ROBUST, ids=["anneal", "fixed", "quad"])
@pytest.mark.parametrize("ttype", [T.HOMOGRAPHY, T.EUCLIDEAN], ids=["homography", "euclidean"])
def test_ic_solve_on_cpu_is_unchanged(ttype, robust, lam):
    """ic_solve on CPU tensors sets its level up by the chain and runs the
    plain system, as before K7: the same state, bit for bit, and no launch."""
    i1, i2 = level()
    h, w = i1.shape[1:3]
    p0 = torch.zeros((3, 8))
    p0[0, 0] = 0.3
    kw = dict(tol=1e-3, max_iter=12, robust=robust, lam=lam, delta=3)
    k7.LAUNCHES = 0
    got = tic.ic_solve(i1, i2, p0, ttype, **kw)
    ix, iy = tgr.central_gradients(i1)
    band = tgr.boundary_band_mask(h, w, 3)[None, :, :, None]
    ix, iy = ix * band, iy * band
    scale = ttr.param_preconditioner(ttype, h, w)
    system = tic._plain_system(i1, i2, ix, iy, *tne.grad_moments(ix, iy), ttype, robust, True,
                               3, scale, 16384)
    solver = tic._Level(system, plan(p0, ttype, h, w, robust, lam, scale), lam)
    same_state(got, tic.iterate(solver, solver.start()))
    assert k7.LAUNCHES == 0


@pytest.mark.parametrize("robust,lam", ROBUST, ids=["anneal", "fixed", "quad"])
def test_ic_solve_kernel_branch_packs_once_a_level(monkeypatch, robust, lam):
    """ic_solve's kernel branch, run on CPU tensors (the kernels' plain
    versions): one pack_level a level, whose plan gives the state of the
    system built on the chain's plan, bit for bit."""
    i1, i2 = level()
    h, w = i1.shape[1:3]
    p0 = torch.zeros((3, 8))
    p0[1, 2] = -0.4
    calls = []

    def spy(*args):
        calls.append(args[2:])
        return k7.pack_level(*args)

    monkeypatch.setattr(tic, "uses_kernels", lambda *a: True)
    monkeypatch.setattr(tic, "pack_level", spy)
    got = tic.ic_solve(i1, i2, p0, T.HOMOGRAPHY, tol=1e-3, max_iter=12, robust=robust, lam=lam,
                       delta=3, nanifoutside=False)
    assert calls == [(3, False, robust is not R.QUADRATIC)]
    scale = ttr.param_preconditioner(T.HOMOGRAPHY, h, w)
    system = tic._fused_system(chain(i1, i2, 3, False, robust is not R.QUADRATIC), T.HOMOGRAPHY,
                               robust, False, 3)
    solver = tic._KernelLevel(system, plan(p0, T.HOMOGRAPHY, h, w, robust, lam, scale), lam)
    same_state(got, tic.iterate(solver, solver.start()))
