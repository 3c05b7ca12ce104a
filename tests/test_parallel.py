"""Multi-device sharding paths on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import genomicbreedingmodels_tpu as gbm
from genomicbreedingmodels_tpu.parallel.mesh import make_mesh
from genomicbreedingmodels_tpu.parallel.sharded import (
    gblup_train_step,
    multitrait_gblup_step,
    sharded_grm,
    sharded_ridge_step,
)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must force 8 virtual CPU devices"
    return make_mesh(shape=(1, 8), axis_names=("dp", "mp"))


def _sharded_X(mesh, n=32, p=64, seed=0):
    rng = np.random.default_rng(seed)
    X = jnp.asarray(rng.random((n, p)), jnp.float32)
    return jax.device_put(X, NamedSharding(mesh, P(None, "mp"))), rng


def test_sharded_grm_matches_single_device(mesh8):
    X, _ = _sharded_X(mesh8)
    K = np.asarray(sharded_grm(X, mesh8))
    Xn = np.asarray(X)
    Z = Xn - Xn.mean(axis=0)
    assert np.allclose(K, Z @ Z.T, atol=1e-4)


def test_sharded_ridge_matches_reference_solution(mesh8):
    X, rng = _sharded_X(mesh8)
    y = jnp.asarray(rng.normal(size=32), jnp.float32)
    b0, beta = sharded_ridge_step(X, y, 0.5, mesh8)
    Xn, yn = np.asarray(X, dtype=np.float64), np.asarray(y, dtype=np.float64)
    n = Xn.shape[0]
    Z = Xn - Xn.mean(axis=0)
    yc = yn - yn.mean()
    beta_ref = np.linalg.solve(Z.T @ Z + n * 0.5 * np.eye(Xn.shape[1]), Z.T @ yc)
    assert np.allclose(np.asarray(beta), beta_ref, atol=1e-3)
    b0_ref = yn.mean() - Xn.mean(axis=0) @ beta_ref
    assert np.isclose(float(b0), b0_ref, atol=1e-3)


def test_gblup_train_step(mesh8):
    X, rng = _sharded_X(mesh8)
    y = jnp.asarray(rng.normal(size=32), jnp.float32)
    gebv = np.asarray(gblup_train_step(X, y, 0.1, mesh8))
    assert gebv.shape == (32,)
    assert np.all(np.isfinite(gebv))
    # GEBV shrinks toward the mean but correlates with y
    assert np.corrcoef(gebv, np.asarray(y))[0, 1] > 0.3


def test_multitrait_gblup_over_dp_mp_mesh():
    mesh = make_mesh(shape=(2, 4), axis_names=("dp", "mp"))
    rng = np.random.default_rng(1)
    n, p, t = 24, 32, 4
    X = jax.device_put(
        jnp.asarray(rng.random((n, p)), jnp.float32), NamedSharding(mesh, P(None, "mp"))
    )
    Y = jax.device_put(
        jnp.asarray(rng.normal(size=(t, n)), jnp.float32), NamedSharding(mesh, P("dp", None))
    )
    gebv = np.asarray(multitrait_gblup_step(X, Y, 0.1, mesh))
    assert gebv.shape == (t, n)
    assert np.all(np.isfinite(gebv))


def test_graft_entry_single_and_multichip():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert np.asarray(out).shape == (256,)
    ge.dryrun_multichip(8)


def test_distributed_helpers_single_process():
    """distributed_init no-ops and mesh/slice helpers behave in 1-process."""
    from genomicbreedingmodels_tpu.parallel.distributed import (
        distributed_init, make_multihost_mesh, process_local_panel_slice,
    )

    assert distributed_init() is False
    mesh = make_multihost_mesh()
    assert mesh.axis_names == ("dp", "mp")
    assert mesh.devices.size == 8
    mesh2 = make_multihost_mesh(dp_per_host=2)
    assert mesh2.shape["dp"] == 2 and mesh2.shape["mp"] == 4
    start, stop = process_local_panel_slice(1000)
    assert (start, stop) == (0, 1000)


def test_sharded_gblup_cg_matches_dense():
    """Matrix-free CG GBLUP (K never materialized) == dense Cholesky solve."""
    import jax
    from genomicbreedingmodels_tpu.parallel.mesh import make_mesh
    from genomicbreedingmodels_tpu.parallel.sharded import sharded_gblup_cg

    rng = np.random.default_rng(0)
    n, p = 200, 1000
    X = rng.random((n, p)).astype(np.float32)
    y = (X[:, :20] @ rng.normal(size=20) + 0.5 * rng.normal(size=n)).astype(np.float32)
    mesh = make_mesh(shape=(1, 8))
    alpha, gebv = sharded_gblup_cg(X, y, lam=0.1, mesh=mesh)
    Z = X - X.mean(0)
    K = Z @ Z.T / p
    a_ref = np.linalg.solve(K + 0.1 * np.eye(n), y - y.mean())
    g_ref = K @ a_ref + y.mean()
    assert np.abs(np.asarray(alpha) - a_ref).max() < 1e-4
    assert np.corrcoef(np.asarray(gebv), g_ref)[0, 1] > 0.999


def test_sharded_grm_int8_dosage_matches_dense(mesh8):
    """int8 dosage panels through the sharded GRM: exact int32 local Grams,
    same result as the f64 dense centered Gram."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from genomicbreedingmodels_tpu.parallel.sharded import sharded_grm

    rng = np.random.default_rng(11)
    n, p = 32, 64
    D = rng.integers(0, 3, size=(n, p)).astype(np.int8)
    Dj = jax.device_put(jnp.asarray(D), NamedSharding(mesh8, P(None, "mp")))
    K = np.asarray(sharded_grm(Dj, mesh8), dtype=np.float64)
    X = D.astype(np.float64) / 2.0
    Z = X - X.mean(axis=0, keepdims=True)
    assert np.abs(K - Z @ Z.T).max() < 1e-5


def test_sharded_gwas_scans_match_single_device(mesh8):
    """Mesh-sharded GWAS scans (VERDICT r2 item 3): one replicated eigh, then
    each device scans its own marker shard — must exactly reproduce the
    single-device scan (same internal kernels, columns are independent)."""
    import jax.numpy as jnp

    from genomicbreedingmodels_tpu.models.gwas import (
        _eigh_device,
        _gls_scan,
        _grm_pc1_device,
        _gwasols_scan,
        _reml_scan,
    )
    from genomicbreedingmodels_tpu.parallel.sharded import (
        sharded_gwaslmm,
        sharded_gwasols,
        sharded_gwasreml,
    )

    rng = np.random.default_rng(7)
    n, p = 48, 120  # p not divisible by 8 -> exercises the pad/trim path
    G = rng.normal(size=(n, p)).astype(np.float32)
    G = (G - G.mean(0)) / G.std(0, ddof=1)
    y = (G[:, :4] @ np.array([1.5, -1.0, 0.8, 0.6]) + rng.normal(size=n)).astype(np.float32)
    y = (y - y.mean()) / y.std(ddof=1)
    K = (G @ G.T / p).astype(np.float32)

    Gj, yj, Kj = jnp.asarray(G), jnp.asarray(y), jnp.asarray(K)
    s, U = _eigh_device(Kj)
    yt = U.T @ yj
    ones_t = U.T @ jnp.ones(n, jnp.float32)

    # REML
    Gt = U.T @ Gj
    Xt_all = jnp.stack([jnp.broadcast_to(ones_t[:, None], Gt.shape), Gt], -1).transpose(1, 0, 2)
    z_ref, _ = _reml_scan(yt, Xt_all, s, n_grid=8, n_newton=6)
    z_sh = sharded_gwasreml(G, y, K, mesh8, n_grid=8, n_newton=6)
    assert z_sh.shape == (p,)
    np.testing.assert_allclose(z_sh, np.asarray(z_ref), rtol=2e-4, atol=2e-4)

    # OLS
    pc1 = _grm_pc1_device(Kj)
    t_ref = _gwasols_scan(Gj, yj, pc1)
    t_sh = sharded_gwasols(G, y, K, mesh8)
    np.testing.assert_allclose(t_sh, np.asarray(t_ref), rtol=2e-4, atol=2e-4)

    # LMM (EMMAX): null REML replicated, GLS scan sharded
    F = jnp.stack([jnp.ones(n, jnp.float32), pc1], axis=1)
    Ft = U.T @ F
    _, theta = _reml_scan(yt, Ft[None, :, :], s)
    inv_d = 1.0 / (theta[0, 1] * s + theta[0, 0])
    zl_ref = _gls_scan(Gt, Ft, yt, inv_d)
    zl_sh = sharded_gwaslmm(G, y, K, mesh8)
    np.testing.assert_allclose(zl_sh, np.asarray(zl_ref), rtol=2e-4, atol=2e-4)


def test_gwas_public_api_mesh_dispatch(mesh8):
    """gwasols/gwasreml/gwaslmm with mesh= must agree with mesh=None."""
    import genomicbreedingmodels_tpu as gbm

    genomes = gbm.simulate_genomes(n=64, l=160, seed=5)
    trials, _ = gbm.simulate_trials(
        genomes, f_add_dom_epi=np.array([[0.2, 0.0, 0.0]]), n_qtl=4, seed=5
    )
    phenomes = gbm.extract_phenomes(trials)
    for fn in (gbm.gwasols, gbm.gwaslmm):
        f0 = fn(genomes=genomes, phenomes=phenomes)
        f1 = fn(genomes=genomes, phenomes=phenomes, mesh=mesh8)
        np.testing.assert_allclose(f1.b_hat, f0.b_hat, rtol=5e-4, atol=5e-4)
    f0 = gbm.gwasreml(genomes=genomes, phenomes=phenomes)
    f1 = gbm.gwasreml(genomes=genomes, phenomes=phenomes, mesh=mesh8)
    # Same argmax marker; z-stats near-identical. Tolerance is looser than
    # the scan-level identity test above: the sharded rotation GEMM rounds
    # differently in f32, and per-marker Newton can land a hair off on flat
    # objectives (observed: 1/160 markers off by ~0.015 z).
    assert np.argmax(np.abs(f0.b_hat)) == np.argmax(np.abs(f1.b_hat))
    np.testing.assert_allclose(f1.b_hat, f0.b_hat, rtol=2e-2, atol=2e-2)


def test_weak_scaling_harness_smoke():
    """scripts/weak_scaling.py (VERDICT r03 item 4a): per-device work stays
    fixed as D grows; stages execute and report sane efficiencies."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    try:
        from weak_scaling import run_weak_scaling
    finally:
        sys.path.pop(0)

    lines = []
    results = run_weak_scaling(
        device_counts=(1, 2), n=48, p_per_device=128, gibbs_iters=2,
        cg_iters=4, emit=lines.append,
    )
    assert set(results) == {1, 2}
    for D in (1, 2):
        assert all(v > 0 for v in results[D].values())
    import json

    summary = json.loads(lines[-1])
    assert summary["summary"] and "efficiency_grm" in summary
