"""Device-mesh construction helpers.

The framework's parallelism is data parallelism over *paths* (the device
analog of the reference's NumPy vectorization over `n_sims`, reference
app.py:612-633) with an optional second axis over *assets* for baskets, and
an optional outer ``slices`` axis.

The slices axis is an algorithmic two-level merge, not a map of the
hardware: the cards of one host are joined all to all by NVLink, so every
pair exchanges at the same rate.  With ("slices", "paths"), the block-stat
``all_gather`` runs within each slice, each slice tree-merges its own
blocks, and only O(slices) merged states are exchanged between slices
(`parallel.sharded` two-level merge) — bitwise identical to the flat mesh
by construction.  Across hosts, where links are slower than NVLink, the
same layout keeps the per-block exchange on the fast links.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

#: Canonical mesh-axis names.
PATHS_AXIS = "paths"
ASSETS_AXIS = "assets"
SLICES_AXIS = "slices"


def make_mesh(n_path_shards: int | None = None, n_asset_shards: int = 1,
              devices=None, n_slices: int = 1) -> Mesh:
    """Build a mesh: ([slices,] paths[, assets]).

    Defaults to all addressable devices on the paths axis.  ``n_slices > 1``
    adds the outer two-level-merge axis: pass devices ordered slice-major
    (``jax.devices()`` already is); each row of the mesh is then one slice
    and the paths-axis collectives stay within it.
    """
    if devices is None:
        devices = jax.devices()
    if n_slices < 1 or n_slices > len(devices):
        raise ValueError(
            f"n_slices={n_slices} must be in [1, {len(devices)}]")
    if n_slices > 1 and n_asset_shards > 1:
        raise ValueError(
            "slices x assets meshes are not supported: shard assets within "
            "a slice (ICI) and paths across slices")
    if n_asset_shards < 1 or n_asset_shards > len(devices):
        raise ValueError(
            f"n_asset_shards={n_asset_shards} must be in "
            f"[1, {len(devices)}] (available devices)")
    inner = n_asset_shards * n_slices
    if n_path_shards is None:
        if len(devices) % inner:
            # Silent floor division would idle devices (and 0 path shards
            # would build an empty mesh that fails obscurely downstream).
            raise ValueError(
                f"{len(devices)} devices do not split evenly into "
                f"n_asset_shards={n_asset_shards} x n_slices={n_slices}; "
                "pass n_path_shards explicitly to use a subset")
        n_path_shards = len(devices) // inner
    if n_path_shards < 1:
        raise ValueError(f"n_path_shards={n_path_shards} must be >= 1")
    n = n_path_shards * inner
    if n > len(devices):
        raise ValueError(
            f"mesh needs {n} devices, only {len(devices)} available"
        )
    if n_slices > 1:
        dev_array = np.asarray(devices[:n]).reshape(n_slices, n_path_shards)
        return Mesh(dev_array, (SLICES_AXIS, PATHS_AXIS))
    dev_array = np.asarray(devices[:n]).reshape(n_path_shards, n_asset_shards)
    if n_asset_shards == 1:
        return Mesh(dev_array[:, 0], (PATHS_AXIS,))
    return Mesh(dev_array, (PATHS_AXIS, ASSETS_AXIS))
