"""Multi-host initialization + hybrid intra-/inter-host meshes (SURVEY §5/§7: the
reference has no distributed runtime at all — its only inter-process
communication is temp files + Rscript, reference src/bayes.jl:59-99).

Scale-out recipe (BASELINE north star, 100k x 1M panels over several hosts):
1. `distributed_init()` on every host (jax.distributed handshake).
2. `make_multihost_mesh(('dp', 'mp'))` — 'mp' (markers) maps to the devices
   of one host (NVLink between GPUs), 'dp' (folds/chains/traits) spans hosts
   over the network, so the heavy Gram/effect psums stay inside a host while
   only low-rate job-level reductions cross hosts.
3. Shard the panel with `marker_sharding(mesh)` host-by-host: each process
   feeds only its local shard via `jax.make_array_from_process_local_data`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["distributed_init", "make_multihost_mesh", "process_local_panel_slice"]


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed if a multi-process environment is detected
    or explicitly configured. Returns True when running multi-process.

    No-ops (returns False) in single-process runs, so library code can call
    it unconditionally.
    """
    import jax

    if jax.process_count() > 1:
        return True
    if coordinator_address is None:
        import os

        coordinator_address = os.environ.get("GBM_COORDINATOR")
        if coordinator_address is None:
            return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count() > 1


def make_multihost_mesh(
    axis_names: Tuple[str, str] = ("dp", "mp"),
    dp_per_host: int = 1,
):
    """Hybrid mesh: 'mp' = devices within a host, 'dp' = across hosts x
    optional intra-host split.

    Single-process fallback: a (1, n_devices) mesh, so the same model code
    runs everywhere.
    """
    import jax
    from jax.sharding import Mesh

    n_hosts = jax.process_count()
    local = jax.local_device_count()
    if n_hosts == 1:
        devs = np.asarray(jax.devices())
        if dp_per_host > 1 and local % dp_per_host == 0:
            return Mesh(devs.reshape(dp_per_host, local // dp_per_host), axis_names)
        return Mesh(devs.reshape(1, local), axis_names)
    from jax.experimental import mesh_utils

    # dp = hosts * dp_per_host across hosts; mp = remaining local devices.
    if local % dp_per_host != 0:
        raise ValueError(f"dp_per_host={dp_per_host} does not divide local device count {local}")
    mp = local // dp_per_host
    devices = mesh_utils.create_hybrid_device_mesh(
        (dp_per_host, mp),
        (n_hosts, 1),
        devices=jax.devices(),
    ).reshape(n_hosts * dp_per_host, mp)
    return Mesh(devices, axis_names)


def process_local_panel_slice(n_markers_global: int) -> Tuple[int, int]:
    """[start, stop) marker range this host should load (contiguous split by
    process index) — pair with io.read_genomes_tsv / read_bed column slicing
    so each host touches only its shard of a huge panel."""
    import jax

    k, r = divmod(n_markers_global, jax.process_count())
    i = jax.process_index()
    start = i * k + min(i, r)
    stop = start + k + (1 if i < r else 0)
    return start, stop
