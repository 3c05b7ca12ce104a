"""chip_smoke.py off the card: it refuses a CPU platform, its contract line
has the driver's format, and its f64 references agree with independent
dense computations at tiny shapes."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def test_chip_smoke_refuses_cpu(capsys):
    rc = cs.main([])
    out, err = capsys.readouterr()
    assert rc != 0
    assert out == ""  # no result line, no contract line
    assert "needs a CUDA GPU" in err


def test_chip_smoke_contract_line_format():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = cs.contract_line([Dev()])
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
    }
    assert "\n" not in line
    assert json.loads(cs.contract_line([Dev()] * 4))["device"]["count"] == 4


def test_report_fails_on_tolerance_and_exception(capsys):
    rep = cs.Report()
    assert rep.line("x", "1x1", 0.0, 1e-9, 1e-6, "f32")
    assert not rep.line("y", "1x1", 0.0, 1e-3, 1e-6, "f32")
    assert not rep.line("z", "1x1", 0.0, float("nan"), 1.0, "f32")

    def boom(_rep):
        raise RuntimeError("no card")

    rep.run("w", boom)
    out = capsys.readouterr().out
    assert out.count("-> FAIL") == 3 and out.count("-> ok") == 1
    assert [f.split(":")[0] for f in rep.failures] == ["y", "z", "w"]


def test_gblup_f64_matches_device_pipeline():
    import jax.numpy as jnp

    from genomicbreedingmodels_tpu.ops.chol import gblup_solve_lower
    from genomicbreedingmodels_tpu.ops.grm import gram_dosage_lower

    rng = np.random.default_rng(0)
    D = rng.integers(0, 3, size=(96, 400)).astype(np.int8)
    y = rng.normal(size=96).astype(np.float32)
    g_dev = np.asarray(gblup_solve_lower(gram_dosage_lower(D, nb=3), jnp.asarray(y),
                                         jnp.float32(5.0), nb=3))
    G = D.astype(np.int64) @ D.astype(np.int64).T
    assert cs.rel_err(g_dev, cs.gblup_f64(G, y, 5.0)) < 1e-4


def test_ols_t_f64_matches_per_marker_pinv():
    rng = np.random.default_rng(1)
    n, p = 50, 30
    G = rng.normal(size=(n, p))
    y = rng.normal(size=n)
    Q = np.stack([np.ones(n), rng.normal(size=n)], axis=1)
    t = cs.ols_t_f64(G, y, Q)
    for j in range(p):
        Xf = np.concatenate([Q, G[:, j:j + 1]], axis=1)
        Vinv = np.linalg.pinv(Xf.T @ Xf)
        b = Vinv @ (Xf.T @ y)
        assert abs(t[j] - b[-1] / np.sqrt(Vinv[-1, -1])) < 1e-9 * max(1.0, abs(t[j]))


def test_reml_and_gls_eig_match_dense_objective():
    from genomicbreedingmodels_tpu.parity import _reml_neg_loglik

    rng = np.random.default_rng(2)
    n = 40
    Z = rng.normal(size=(n, 60))
    K = Z @ Z.T / 60
    y = rng.normal(size=n)
    Xf = np.stack([np.ones(n), rng.normal(size=n)], axis=1)
    s, U = np.linalg.eigh(K)
    yr, Xr = U.T @ y, U.T @ Xf
    for th in ((0.3, 0.7), (1.0, 0.01), (1e-3, 0.5)):
        th = np.asarray(th)
        assert abs(cs.reml_nll_eig(th, yr, Xr, s) - _reml_neg_loglik(th, y, Xf, K)) < 1e-8
        V = th[1] * K + th[0] * np.eye(n)
        Vi = np.linalg.inv(V)
        cov = np.linalg.inv(Xf.T @ Vi @ Xf)
        b = cov @ (Xf.T @ Vi @ y)
        assert abs(cs.gls_z_eig(th, yr, Xr, s) - b[-1] / np.sqrt(cov[-1, -1])) < 1e-8
    th = cs.reml_fit_eig(yr, Xr, s)
    assert np.all((th >= 1e-6) & (th <= 1.0))
    assert cs.reml_nll_eig(th, yr, Xr, s) <= cs.reml_nll_eig(np.array([0.5, 0.5]), yr, Xr, s)


def test_ridge_fold_f64_is_the_masked_dual_solve():
    from genomicbreedingmodels_tpu.cv.batched import _fold_solve

    rng = np.random.default_rng(3)
    n = 30
    X = rng.random((n, 80))
    Z = X - X.mean(axis=0)
    K = Z @ Z.T
    y = rng.normal(size=n)
    w = (rng.random(n) < 0.7).astype(np.float64)
    lam = 0.05
    preds, _, _ = _fold_solve(K.astype(np.float32), y.astype(np.float32),
                              w.astype(np.float32), np.asarray([lam], np.float32))
    ref = cs.ridge_fold_f64(K, y, w, lam * w.sum())
    assert cs.rel_err(np.asarray(preds)[0], ref) < 1e-4


def test_lasso_fold_f64_solves_the_lasso():
    """f64 FISTA reaches the lasso optimum: KKT conditions hold."""
    rng = np.random.default_rng(4)
    n, p = 40, 60
    X = rng.random((n, p))
    y = X[:, :3] @ np.array([2.0, -1.0, 1.5]) + 0.1 * rng.normal(size=n)
    w = np.ones(n)
    lam = 0.01
    pred = cs.lasso_fold_f64(X, y, w, lam, n_iter=5000)
    Z = X - X.mean(axis=0)
    r = (y - y.mean()) - (pred - y.mean())
    g = Z.T @ r / n
    assert np.max(np.abs(g)) <= lam * (1 + 1e-3)


def test_ridge_gcv_f64_is_the_engine_criterion():
    """The f64 GCV curve is the criterion _fold_solve minimizes: the same
    values (to f32) along the grid and the same λ picked."""
    from genomicbreedingmodels_tpu.cv.batched import _fold_solve

    rng = np.random.default_rng(5)
    n, p = 40, 30
    X = rng.random((n, p))
    Z = X - X.mean(axis=0)
    K = Z @ Z.T
    y = Z[:, :3] @ np.array([1.0, -2.0, 0.5]) + 0.5 * rng.normal(size=n)
    w = (rng.random(n) < 0.75).astype(np.float64)
    grid = np.logspace(-4, 1, 12)
    _, _, crit = _fold_solve(K.astype(np.float32), y.astype(np.float32),
                             w.astype(np.float32), grid.astype(np.float32))
    ref = cs.ridge_gcv_f64(K, y, w, grid)
    np.testing.assert_allclose(np.asarray(crit), ref, rtol=2e-3)
    assert int(np.argmin(crit)) == int(np.argmin(ref))
