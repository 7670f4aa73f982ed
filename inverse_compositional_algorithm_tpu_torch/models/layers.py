"""Reference-API compatibility layer.

The port of the JAX package's `models/layers.py`: callable classes with the
names, call signatures and return tuples of the reference's Keras layers
(reference src/keras-tf/tf_inverse_compositional_algorithm.py:61,255,467)
and the numpy entry points (src/inverse_compositional_algorithm.py:17,135,
264), so that a user of the reference can switch with few edits. Each one
routes to the port's `align`.

Returns follow the reference, (p, error, DI, Iw): p is the un-padded
parameter vector, error, DI and Iw as in AlignResult. `device` means what
it means in `align`: where numpy input goes, CUDA by default (raising
without a card), "cpu" for the plain path; tensors keep their device.
Convergence is per pair, unlike the reference TF layers.
"""

from __future__ import annotations

from ..config import AlignConfig
from ..constants import MAX_ITER
from ..ops.normal_equations import RobustLoss
from ..ops.transforms import TransformType
from .api import align

__all__ = [
    "InverseCompositional",
    "RobustInverseCompositional",
    "PyramidalInverseCompositional",
    "inverse_compositional_algorithm",
    "robust_inverse_compositional_algorithm",
    "pyramidal_inverse_compositional_algorithm",
]


class _Base:
    def __init__(self, cfg: AlignConfig, device=None):
        self.cfg = cfg.validate()
        self.device = device

    def _run(self, i1, i2, p0, transform_type: TransformType | None):
        cfg = self.cfg
        if transform_type is not None and transform_type is not cfg.transform:
            cfg = cfg.replace(transform=transform_type)
        res = align(i1, i2, cfg, p0=p0, device=self.device)
        return res.params(cfg), res.error, res.di, res.iw

    def __call__(self, inputs, transform_type: TransformType | None = None):
        if len(inputs) == 3:
            i1, i2, p0 = inputs
        else:
            i1, i2 = inputs
            p0 = None
        return self._run(i1, i2, p0, transform_type)


class InverseCompositional(_Base):
    """Single-scale quadratic IC (mirror of reference
    tf_inverse_compositional_algorithm.py:61-251)."""

    def __init__(self, TOL: float = 1e-3, nanifoutside: bool = True,
                 delta: int = 10, verbose: bool = False,
                 max_iter: int = MAX_ITER,
                 transform_type: TransformType = TransformType.EUCLIDEAN,
                 device=None, **kw):
        super().__init__(AlignConfig(
            transform=transform_type, robust=RobustLoss.QUADRATIC, tol=TOL,
            nscales=1, nanifoutside=nanifoutside, delta=delta,
            max_iter=max_iter, verbose=verbose, **kw), device)


class RobustInverseCompositional(_Base):
    """Single-scale robust IRLS IC (mirror of reference
    tf_inverse_compositional_algorithm.py:255-465)."""

    def __init__(self, TOL: float = 1e-3,
                 robust_type: RobustLoss = RobustLoss.CHARBONNIER,
                 lambda_: float = 0.0, nanifoutside: bool = True,
                 delta: int = 10, verbose: bool = False,
                 max_iter: int = MAX_ITER,
                 transform_type: TransformType = TransformType.EUCLIDEAN,
                 device=None, **kw):
        super().__init__(AlignConfig(
            transform=transform_type, robust=robust_type, lam=lambda_,
            tol=TOL, nscales=1, nanifoutside=nanifoutside, delta=delta,
            max_iter=max_iter, verbose=verbose, **kw), device)


class PyramidalInverseCompositional(_Base):
    """Coarse-to-fine driver (mirror of reference
    tf_inverse_compositional_algorithm.py:467-583)."""

    def __init__(self, transform_type: TransformType = TransformType.EUCLIDEAN,
                 nscales: int = 3, nu: float = 0.5, TOL: float = 1e-3,
                 robust_type: RobustLoss = RobustLoss.QUADRATIC,
                 lambda_: float = 0.0, nanifoutside: bool = True,
                 delta: int = 10, verbose: bool = False, device=None, **kw):
        super().__init__(AlignConfig(
            transform=transform_type, robust=robust_type, lam=lambda_,
            tol=TOL, nscales=nscales, nu=nu, nanifoutside=nanifoutside,
            delta=delta, verbose=verbose, **kw), device)


def inverse_compositional_algorithm(I1, I2, p, transform_type, TOL=1e-3,
                                    nanifoutside=True, delta=10, verbose=False,
                                    device=None):
    """Functional mirror of reference
    src/inverse_compositional_algorithm.py:17-133."""
    layer = InverseCompositional(TOL=TOL, nanifoutside=nanifoutside,
                                 delta=delta, verbose=verbose,
                                 transform_type=transform_type, device=device)
    return layer((I1, I2, p))


def robust_inverse_compositional_algorithm(I1, I2, p, transform_type,
                                           TOL=1e-3,
                                           robust_type=RobustLoss.LORENTZIAN,
                                           lambda_=0.0, nanifoutside=True,
                                           delta=10, verbose=False, device=None):
    """Functional mirror of reference
    src/inverse_compositional_algorithm.py:135-261."""
    layer = RobustInverseCompositional(TOL=TOL, robust_type=robust_type,
                                       lambda_=lambda_,
                                       nanifoutside=nanifoutside, delta=delta,
                                       verbose=verbose,
                                       transform_type=transform_type, device=device)
    return layer((I1, I2, p))


def pyramidal_inverse_compositional_algorithm(I1, I2, p, transform_type,
                                              nscales=3, nu=0.5, TOL=1e-3,
                                              robust_type=RobustLoss.QUADRATIC,
                                              lambda_=0.0, nanifoutside=True,
                                              delta=10, verbose=False, device=None):
    """Functional mirror of reference
    src/inverse_compositional_algorithm.py:264-374."""
    layer = PyramidalInverseCompositional(
        transform_type=transform_type, nscales=nscales, nu=nu, TOL=TOL,
        robust_type=robust_type, lambda_=lambda_, nanifoutside=nanifoutside,
        delta=delta, verbose=verbose, device=device)
    return layer((I1, I2, p))
