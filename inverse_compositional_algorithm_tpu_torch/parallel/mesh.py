"""Device-mesh helpers on torch.distributed.

One process (rank) per device. The ranks form a ("pairs", "tile") mesh:

  * "pairs" — data parallelism over frame pairs: each pairs group aligns
    its own pairs, with no communication between groups;
  * "tile"  — spatial parallelism over image rows (for frames too large
    for one device): the ranks of a tile group hold the same pairs, each
    its own band of rows, and reduce the normal equations
    (`parallel.tiled`).

Rank r sits at (r // tile, r % tile). The process group must be up first
(`parallel.sharded.init_distributed`); every rank builds the mesh, and so
its sub-groups, in the same order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["PAIRS_AXIS", "TILE_AXIS", "make_mesh", "axis_size", "pair_shard", "image_shard",
           "row_span"]

PAIRS_AXIS = "pairs"
TILE_AXIS = "tile"


def make_mesh(pairs: int | None = None, tile: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """The ("pairs", "tile") mesh over every rank of the default process
    group; `pairs` defaults to world // tile, and pairs * tile must be the
    world size."""
    world = dist.get_world_size()
    if pairs is None:
        pairs = world // tile
    if pairs < 1 or tile < 1 or pairs * tile != world:
        raise ValueError(f"mesh {pairs}x{tile} needs {pairs * tile} ranks, have {world}")
    return DeviceMesh(device_type, torch.arange(world).reshape(pairs, tile),
                      mesh_dim_names=(PAIRS_AXIS, TILE_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Number of ranks along `axis` (`DeviceMesh.size` takes a name in some
    PyTorch releases and only an index in others)."""
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])


def pair_shard(x, mesh: DeviceMesh):
    """This rank's pairs of a global batch x [B, ...] (B divisible by the
    pairs axis): the counterpart of the JAX package's `pair_sharding`."""
    n = axis_size(mesh, PAIRS_AXIS)
    if x.shape[0] % n:
        raise ValueError(f"B={x.shape[0]} not divisible by pairs axis size {n}")
    b = x.shape[0] // n
    i = mesh.get_local_rank(PAIRS_AXIS)
    return x[i * b:(i + 1) * b]


def row_span(mesh: DeviceMesh, height: int) -> tuple[int, int]:
    """(y0, rows) of this rank's band of a frame `height` rows tall
    (height divisible by the tile axis)."""
    nt = axis_size(mesh, TILE_AXIS)
    if height % nt:
        raise ValueError(f"H={height} not divisible by tile axis size {nt}")
    rows = height // nt
    return mesh.get_local_rank(TILE_AXIS) * rows, rows


def image_shard(x, mesh: DeviceMesh, tile_rows: bool = True):
    """This rank's share of global images x [B, H, W, C]: its pairs and,
    with tile_rows, its band of rows (the JAX package's `image_sharding`)."""
    x = pair_shard(x, mesh)
    if not tile_rows:
        return x
    y0, rows = row_span(mesh, x.shape[1])
    return x[:, y0:y0 + rows]
