"""Per-pixel normal-equation operators (the reference's legacy surface, batched).

The port of the JAX package's `ops/matrix_operators.py`. The reference keeps
a per-pixel matrix-product form of the Gauss-Newton accumulations, `AtA`,
`sAtA`, `Atb`, `sAtb` (reference src/matrix_operators.py:3-63, unused by its
drivers). They are here batched, for API parity and as independent oracles
for the channel-reduced path of ops/normal_equations.py that the solvers
use: summing `ata` / `atb` over the pixels gives `hessian` / `rhs`.

`steepest_descent_images` materializes the reference's DIJ tensor
(src/image_optimisation.py:158-194); the solvers never build it.
"""

from __future__ import annotations

import torch

__all__ = ["steepest_descent_images", "ata", "sata", "atb", "satb"]


def steepest_descent_images(ix: torch.Tensor, iy: torch.Tensor, jx: torch.Tensor,
                            jy: torch.Tensor) -> torch.Tensor:
    """DIJ[..., c, n] = Ix[..., c] * Jx[..., n] + Iy[..., c] * Jy[..., n].

    Args:
      ix, iy: [B, H, W, C] image gradients (boundary-band-masked).
      jx, jy: [H, W, 8] Jacobian fields (ops.transforms.jacobian_fields).

    Returns:
      [B, H, W, C, 8], the reference's DIJ layout with the batch first.
    """
    return ix[..., :, None] * jx[..., None, :] + iy[..., :, None] * jy[..., None, :]


def ata(dij: torch.Tensor) -> torch.Tensor:
    """Per-pixel A^T A of the steepest-descent vectors: [..., C, N] ->
    [..., N, N] (reference `AtA`, src/matrix_operators.py:3-9). Summed over
    the pixels it is the unweighted Hessian."""
    return torch.einsum("...cn,...cm->...nm", dij, dij)


def sata(rho, dij: torch.Tensor) -> torch.Tensor:
    """rho-weighted per-pixel A^T A (reference `sAtA`,
    src/matrix_operators.py:11-26); rho broadcasts over [..., N, N]."""
    return torch.as_tensor(rho, dtype=dij.dtype, device=dij.device)[..., None, None] * ata(dij)


def atb(dij: torch.Tensor, di: torch.Tensor) -> torch.Tensor:
    """Per-pixel A^T b: [..., C, N], [..., C] -> [..., N] (reference `Atb`,
    src/matrix_operators.py:28-45). Summed over the pixels it is b."""
    return torch.einsum("...cn,...c->...n", dij, di)


def satb(rho, dij: torch.Tensor, di: torch.Tensor) -> torch.Tensor:
    """rho-weighted per-pixel A^T b (reference `sAtb`,
    src/matrix_operators.py:47-63)."""
    return torch.as_tensor(rho, dtype=dij.dtype, device=dij.device)[..., None] * atb(dij, di)
