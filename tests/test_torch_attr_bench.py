"""The port's K1 cost-attribution bench (eval/attr_bench.py) and the
ablation wrapper it times, on the CPU: what can be checked without a card.

The variants are CUDA kernels with no plain version; they are run and held
against the production K1 in tests/test_torch_gpu.py and chip_smoke.py.
"""

import pytest
import torch

from inverse_compositional_algorithm_tpu.eval import attr_bench as jab
from inverse_compositional_algorithm_tpu_torch.eval import attr_bench as tab
from inverse_compositional_algorithm_tpu_torch.ops.gradients import central_gradients
from inverse_compositional_algorithm_tpu_torch.ops.kernels import fused_iter as k1
from inverse_compositional_algorithm_tpu_torch.ops.normal_equations import (
    RobustLoss, grad_moments,
)


def test_variants_are_the_jax_list():
    assert tab.VARIANTS == jab.VARIANTS


def test_every_variant_is_mapped_or_not_applicable():
    assert set(tab.HOPPER) == set(tab.VARIANTS)
    for name, hop in tab.HOPPER.items():
        knobs = [k for k in name.split(",") if k]
        if hop is None:
            assert knobs and all(k in k1.ABLATE_NOT_APPLICABLE for k in knobs), name
            with pytest.raises(ValueError, match="not applicable"):
                k1.ablate_variant(name)
        else:
            # The JAX spelling and the Hopper one name the same kernel: the
            # knobs with no Hopper meaning drop out of a combination.
            assert k1.ablate_variant(name) == k1.ablate_variant(hop)
            assert set(hop.split(",")) - {""} <= set(k1.ABLATE_KNOBS)
    built = {k1.ablate_variant(h) for h in tab.HOPPER.values() if h is not None}
    assert len(built) == 9 and 0 in built


@pytest.mark.parametrize("bad", ["bogus", "nomask,norho", "chunk1,rollgather"])
def test_ablate_variant_rejects(bad):
    with pytest.raises(ValueError):
        k1.ablate_variant(bad)


def _plan(c=3, robust=True):
    g = torch.Generator().manual_seed(0)
    i1 = torch.rand((1, 16, 24, c), generator=g) * 255
    i2 = torch.rand((1, 16, 24, c), generator=g) * 255
    ix, iy = central_gradients(i1)
    return k1.plan_fused_iter(i1, i2, ix, iy, *grad_moments(ix, iy), robust=robust)


def test_ablate_raises_on_cpu_tensors():
    plan = _plan()
    mat = torch.eye(3)[None]
    before = k1.ABLATE_LAUNCHES
    for ablate in ("", "nomask", "noepi"):
        with pytest.raises(ValueError, match="CUDA"):
            k1.fused_iter_moments_ablate(plan.i2p, plan.tplp, mat, False, torch.tensor([5.0]),
                                         16, 24, RobustLoss.CHARBONNIER, True, 2,
                                         ablate=ablate)
    assert k1.ABLATE_LAUNCHES == before


def test_attr_bench_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tab.run(batch=1, height=32, width=48)
