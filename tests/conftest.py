"""Test harness config: force a virtual 8-device CPU mesh before jax import.

Multi-device sharding paths are exercised on CPU via
--xla_force_host_platform_device_count, mirroring how the driver dry-runs the
multi-chip path (see __graft_entry__.dryrun_multichip).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Tests run on the CPU even where a GPU is present (the on-card checks are
# chip_smoke.py's); pin the platform before any backend starts.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables after each test module.

    The full suite compiles several hundred distinct XLA CPU programs in one
    process; with all of them held live, the CPU backend's compiler
    segfaulted reproducibly near the ~190th compile (backend_compile_and_load
    — observed in test_sharded_gibbs when run AFTER the rest of the suite,
    never in isolation). Dropping executables between modules keeps the
    in-process compiler state bounded; each module's own tests still share
    compiles within the module.
    """
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def sim_small():
    """Small simulated dataset shared across tests (n=100, l=1000)."""
    import genomicbreedingmodels_tpu as gbm

    genomes = gbm.simulate_genomes(n=100, l=1_000, seed=42)
    trials, effects = gbm.simulate_trials(
        genomes, f_add_dom_epi=np.array([[0.4, 0.05, 0.05]]), seed=42
    )
    phenomes = gbm.extract_phenomes(trials)
    return genomes, phenomes, effects


@pytest.fixture(scope="session")
def sim_multipop():
    """Three-population dataset for population-CV tests."""
    import genomicbreedingmodels_tpu as gbm

    genomes = gbm.simulate_genomes(n=120, l=500, n_populations=3, seed=7)
    trials, effects = gbm.simulate_trials(
        genomes, f_add_dom_epi=np.array([[0.4, 0.05, 0.05], [0.3, 0.0, 0.0]]), seed=7
    )
    phenomes = gbm.extract_phenomes(trials)
    return genomes, phenomes, effects
