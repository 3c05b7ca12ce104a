"""Device-mesh construction and sharding helpers.

The framework's long axis is the marker dimension p (up to 10⁶ columns); the
canonical mesh is ('dp', 'mp') where 'mp' column-shards the n x p SNP matrix
(GRM / XᵀX partials all-reduce across devices; on one host the cards are
joined all to all by NVLink, so the mesh follows the algorithm alone) and
'dp' batches independent work
(CV folds, MCMC chains, traits). This replaces the reference's
Threads.@threads + ReentrantLock scheduling (reference
src/cross_validation.jl:158-185) — there is no NCCL/MPI analog in the
reference to translate; the collectives are XLA's (NCCL on GPUs).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "marker_sharding", "replicated", "P", "Mesh"]


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("dp", "mp"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ('dp', 'mp') mesh over the available devices.

    Default shape: all devices on the marker axis (1, n_devices) — marker
    sharding is the capacity axis for genomic panels.
    """
    devs = list(devices) if devices is not None else jax.devices()
    if shape is None:
        shape = (1, len(devs))
    need = shape[0] * shape[1]
    if need > len(devs):
        raise ValueError(f"mesh shape {shape} needs {need} devices, only {len(devs)} available")
    arr = np.asarray(devs[:need]).reshape(shape)
    return Mesh(arr, axis_names)


def marker_sharding(mesh: Mesh) -> NamedSharding:
    """(n, p) arrays column-sharded over the marker axis."""
    return NamedSharding(mesh, P(None, "mp"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
