"""Typed configuration, INI-compatible with the reference's config system.

The PyTorch counterpart of `inverse_compositional_algorithm_tpu.config`: the
same fields and INI format, without the JAX package's `use_pallas` and
`interpret` switches. The device of the data selects the path instead: CUDA
tensors run the hand-written kernels, CPU tensors their plain versions.
"""

from __future__ import annotations

import configparser
import dataclasses
from dataclasses import dataclass

from . import constants as cts
from .ops.normal_equations import RobustLoss
from .ops.transforms import TransformType

__all__ = ["AlignConfig", "read_config_file", "write_config_file",
           "config_from_jax"]


@dataclass(frozen=True)
class AlignConfig:
    """Everything that selects an alignment program (frozen, hashable)."""

    transform: TransformType = TransformType.EUCLIDEAN
    robust: RobustLoss = RobustLoss.QUADRATIC
    lam: float = 0.0                 # robust threshold; <=0 -> annealing schedule
    tol: float = 1e-3                # convergence threshold on ||dp||
    max_iter: int = cts.MAX_ITER
    nscales: int = 5                 # pyramid levels ("pyramid_levels" in INI)
    nu: float = 0.5                  # downsampling factor
    nanifoutside: bool = True        # out-of-domain pixels excluded (vs 0-valued)
    delta: int = 10                  # boundary margin of the modified algorithm
    delta_cap: bool = True           # cap delta per pyramid level so small
    #   coarse levels keep an interior (models.ic.effective_delta)
    pyramid_method: str = "ipol"     # "ipol" | "antialias" (see ops.pyramid)
    precondition: bool = True        # Hartley-normalize the Jacobian columns
    hessian_chunk: int = 16384       # pixels per Hessian accumulation step
    verbose: bool = False
    divergence_guard: bool = True    # freeze + flag catastrophically lost pairs

    def validate(self) -> "AlignConfig":
        # The reference enforces TOL < 0.01
        # (src/inverse_compositional_algorithm.py:59-60).
        if not (0.0 < self.tol < 0.01):
            raise ValueError("tol must be positive and < 0.01")
        if self.nscales < 1:
            raise ValueError("nscales must be >= 1")
        if not (0.0 < self.nu < 1.0):
            raise ValueError("nu must be in (0, 1)")
        return self

    def replace(self, **kw) -> "AlignConfig":
        return dataclasses.replace(self, **kw)


def config_from_jax(cfg) -> AlignConfig:
    """The port's AlignConfig for a JAX-package AlignConfig.

    Fields are copied by name and enums mapped by member name; the JAX-only
    `use_pallas`/`interpret` switches have no counterpart and are dropped.
    Takes the object duck-typed, so this module never imports jax.
    """
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(AlignConfig)}
    kw["transform"] = TransformType[cfg.transform.name]
    kw["robust"] = RobustLoss[cfg.robust.name]
    return AlignConfig(**kw)


_SECTIONS = (
    "InverseCompositionalAlgorithm",
    "RobustInverseCompositionalAlgorithm",
    "PyramidalInverseCompositionalAlgorithm",
)


def read_config_file(filename: str) -> dict[str, AlignConfig]:
    """Parse a reference-format INI file into AlignConfigs, keyed like the
    reference reader's result dict (src/configuration_handler.py:35-67)."""
    cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
    cp.read(filename)
    out: dict[str, AlignConfig] = {}

    def common(sec) -> dict:
        return dict(
            tol=float(sec["tol"]),
            transform=TransformType[sec["transform_type"].strip()],
            verbose=sec.getboolean("verbose", fallback=False),
        )

    if _SECTIONS[0] in cp:
        sec = cp[_SECTIONS[0]]
        out["inverse_compositional_algorithm"] = AlignConfig(
            **common(sec), nscales=1,
        )
    if _SECTIONS[1] in cp:
        sec = cp[_SECTIONS[1]]
        out["robust_inverse_compositional_algorithm"] = AlignConfig(
            **common(sec), nscales=1,
            robust=RobustLoss[sec.get("robust_type", "CHARBONNIER").strip()],
            lam=float(sec.get("lambda", "0.0")),
        )
    if _SECTIONS[2] in cp:
        sec = cp[_SECTIONS[2]]
        out["pyramidal_inverse_compositional_algorithm"] = AlignConfig(
            **common(sec),
            nscales=int(sec.get("pyramid_levels", "5")),
            nu=float(sec.get("nu", "0.5")),
            robust=RobustLoss[sec.get("robust_type", "QUADRATIC").strip()],
            lam=float(sec.get("lambda", "0.0")),
        )
    return out


def write_config_file(filename: str, cfg: AlignConfig = AlignConfig()) -> None:
    """Write all three reference-format sections from one AlignConfig
    (mirror of reference `create_config_file`, src/configuration_handler.py:5-33)."""
    cp = configparser.ConfigParser()
    cp[_SECTIONS[0]] = {
        "tol": repr(cfg.tol),
        "transform_type": cfg.transform.name,
        "verbose": str(cfg.verbose),
    }
    cp[_SECTIONS[1]] = {
        "tol": repr(cfg.tol),
        "transform_type": cfg.transform.name,
        "robust_type": (cfg.robust if cfg.robust is not RobustLoss.QUADRATIC
                        else RobustLoss.CHARBONNIER).name,
        "lambda": repr(cfg.lam),
        "verbose": str(cfg.verbose),
    }
    cp[_SECTIONS[2]] = {
        "tol": repr(cfg.tol),
        "transform_type": cfg.transform.name,
        "pyramid_levels": str(cfg.nscales),
        "nu": repr(cfg.nu),
        "robust_type": cfg.robust.name,
        "lambda": repr(cfg.lam),
        "verbose": str(cfg.verbose),
    }
    with open(filename, "w") as f:
        cp.write(f)
