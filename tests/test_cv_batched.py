"""Batched CV engine (all folds x lambda as one XLA program, GCV selection)."""

import numpy as np
import pytest


def test_batched_matches_serial_structure_and_accuracy(sim_small):
    import genomicbreedingmodels_tpu as gbm

    genomes, phenomes, _ = sim_small
    cvs_b, notes_b = gbm.cvbulk_batched(genomes, phenomes, n_replications=2, n_folds=3, seed=42)
    cvs_s, notes_s = gbm.cvbulk(genomes, phenomes, models=["ridge"], n_replications=2, n_folds=3, seed=42)
    assert len(cvs_b) == len(cvs_s)
    # identical fold composition for the same seed
    for b, s in zip(cvs_b, cvs_s):
        assert b.replication == s.replication and b.fold == s.fold
        assert np.array_equal(np.sort(b.validation_entries), np.sort(s.validation_entries))
    mb = np.mean([c.metrics["cor"] for c in cvs_b])
    ms = np.mean([c.metrics["cor"] for c in cvs_s])
    assert mb > 0.5
    assert abs(mb - ms) < 0.15


def test_batched_fit_predicts_through_generic_path(sim_small):
    import genomicbreedingmodels_tpu as gbm

    genomes, phenomes, _ = sim_small
    cvs, _ = gbm.cvbulk_batched(genomes, phenomes, n_replications=1, n_folds=3, seed=1)
    fit = cvs[0].fit
    assert fit.extras["engine"] == "batched"
    yp = gbm.predict(fit, genomes, idx_entries=list(range(10)))
    assert yp.shape == (10,)
    # fold-level predictions must agree with the generic GEMV path
    rows = [int(np.flatnonzero(genomes.entries == e)[0]) for e in cvs[0].validation_entries]
    yp2 = gbm.predict(fit, genomes, idx_entries=rows)
    np.testing.assert_allclose(yp2, cvs[0].y_pred, rtol=1e-3, atol=1e-3)


def test_batched_argument_validation(sim_small):
    import genomicbreedingmodels_tpu as gbm

    genomes, phenomes, _ = sim_small
    with pytest.raises(ValueError):
        gbm.cvbulk_batched(genomes, phenomes, n_folds=0)
    with pytest.raises(ValueError):
        gbm.cvbulk_batched(genomes, phenomes, n_replications=0)
    # bayesa/b/c and BRR are batched since round 4; mlp remains zoo-only.
    with pytest.raises(ValueError, match="batched CV model"):
        gbm.cvbulk_batched(genomes, phenomes, models=("mlp",))


def test_batched_gblup_and_lasso_engines(sim_small):
    import genomicbreedingmodels_tpu as gbm

    genomes, phenomes, _ = sim_small
    cvs, _ = gbm.cvbulk_batched(
        genomes, phenomes, models=("gblup", "lasso"), n_replications=1, n_folds=3, seed=42
    )
    by_model = {}
    for c in cvs:
        by_model.setdefault(c.fit.model, []).append(c.metrics["cor"])
    assert set(by_model) == {"gblup", "lasso"}
    assert np.mean(by_model["gblup"]) > 0.4
    assert np.mean(by_model["lasso"]) > 0.4
    # effects flow through the generic predict path
    fit = cvs[0].fit
    rows = [int(np.flatnonzero(genomes.entries == e)[0]) for e in cvs[0].validation_entries]
    yp = gbm.predict(fit, genomes, idx_entries=rows)
    np.testing.assert_allclose(yp, cvs[0].y_pred, rtol=1e-2, atol=1e-2)


def test_batched_mesh_matches_single_device(sim_small):
    """Fold-sharded shard_map dispatch must reproduce the unsharded batch."""
    import jax
    from jax.sharding import Mesh

    import genomicbreedingmodels_tpu as gbm

    genomes, phenomes, _ = sim_small
    mesh = Mesh(np.array(jax.devices()), ("dp",))
    cvs_m, _ = gbm.cvbulk_batched(
        genomes, phenomes, models=("ridge", "gblup"), n_replications=2, n_folds=3,
        seed=7, mesh=mesh,
    )
    cvs_1, _ = gbm.cvbulk_batched(
        genomes, phenomes, models=("ridge", "gblup"), n_replications=2, n_folds=3,
        seed=7, mesh=None,
    )
    assert len(cvs_m) == len(cvs_1) > 0
    for a, b in zip(cvs_m, cvs_1):
        assert a.fit.model == b.fit.model and a.fold == b.fold
        np.testing.assert_allclose(a.y_pred, b.y_pred, rtol=1e-4, atol=1e-4)


def test_batched_lasso_mesh_matches_single_device(sim_small):
    """Lasso folds dispatch over the mesh exactly like ridge/gblup (VERDICT
    r2 item 6): the fold-sharded batch must reproduce the unsharded batch."""
    import jax
    from jax.sharding import Mesh

    import genomicbreedingmodels_tpu as gbm

    genomes, phenomes, _ = sim_small
    mesh = Mesh(np.array(jax.devices()), ("dp",))
    cvs_m, _ = gbm.cvbulk_batched(
        genomes, phenomes, models=("lasso",), n_replications=2, n_folds=3,
        seed=7, mesh=mesh,
    )
    cvs_1, _ = gbm.cvbulk_batched(
        genomes, phenomes, models=("lasso",), n_replications=2, n_folds=3,
        seed=7, mesh=None,
    )
    assert len(cvs_m) == len(cvs_1) > 0
    for a, b in zip(cvs_m, cvs_1):
        assert a.fit.model == b.fit.model == "lasso" and a.fold == b.fold
        assert a.fit.extras["lambda"] == b.fit.extras["lambda"]
        # bf16-bulk FISTA iterates aren't bit-stable across program
        # partitionings; λ choice must match exactly, predictions to ~1e-3.
        np.testing.assert_allclose(a.y_pred, b.y_pred, rtol=2e-3, atol=2e-3)


@pytest.mark.slow
def test_mesh_batched_speedup_over_serial_dispatch(sim_small):
    """VERDICT r1 item 3 'done' criterion: the batched/mesh engine beats the
    1-worker serial harness by >3x on a 25-job ridge sweep."""
    import time

    import jax
    from jax.sharding import Mesh

    import genomicbreedingmodels_tpu as gbm

    genomes, phenomes, _ = sim_small
    mesh = Mesh(np.array(jax.devices()), ("dp",))
    # warm both paths' compile caches on a tiny sweep first
    gbm.cvbulk_batched(genomes, phenomes, n_replications=1, n_folds=2, seed=0, mesh=mesh)
    gbm.cvbulk(genomes, phenomes, models=("ridge",), n_replications=1, n_folds=2, seed=0, n_workers=1)

    t0 = time.perf_counter()
    cvs_b, _ = gbm.cvbulk_batched(genomes, phenomes, n_replications=5, n_folds=5, seed=3, mesh=mesh)
    t_batched = time.perf_counter() - t0
    t0 = time.perf_counter()
    cvs_s, _ = gbm.cvbulk(genomes, phenomes, models=("ridge",), n_replications=5, n_folds=5, seed=3, n_workers=1)
    t_serial = time.perf_counter() - t0
    assert len(cvs_b) == len(cvs_s) == 25
    assert t_serial / t_batched > 3.0, (t_serial, t_batched)


def test_gibbs_cv_folds_matches_conjugate_oracle_per_fold():
    """Row-masked fold chains (one vmapped program) are the EXACT sampler on
    each fold's training subset: with pinned variances every fold's
    posterior mean must converge to that fold's closed-form conjugate
    Gaussian mean."""
    from genomicbreedingmodels_tpu.models.bayesian import gibbs_cv_folds

    rng = np.random.default_rng(3)
    n, p, F = 60, 40, 3
    X = rng.uniform(size=(n, p)).astype(np.float32)
    b_true = rng.normal(size=p) * (rng.uniform(size=p) < 0.3)
    y = (X @ b_true + 0.5 * rng.normal(size=n)).astype(np.float32)
    sig_e2, sig_b2 = 0.5, 0.05
    labels = rng.integers(0, F, size=n)
    masks = np.stack([(labels != f).astype(np.float32) for f in range(F)])
    mus, betas = gibbs_cv_folds(
        X, y, masks, model="BRR", n_iter=4200, n_burnin=200, seed=17,
        fix_sigma_e2=sig_e2, fix_sigma_b2=sig_b2,
    )
    for f in range(F):
        tr = masks[f].astype(bool)
        Z = X[tr] - X[tr].mean(axis=0)
        A = Z.T @ Z / sig_e2 + np.eye(p) / sig_b2
        b_star = np.linalg.solve(A, Z.T @ y[tr] / sig_e2)
        mu_star = y[tr].mean() - X[tr].mean(axis=0) @ b_star
        cor = np.corrcoef(mus[f] + X @ betas[f], mu_star + X @ b_star)[0, 1]
        assert cor > 0.999, (f, cor)

    with pytest.raises(ValueError):
        gibbs_cv_folds(X, y, masks[:, :10], model="BRR", n_iter=10)
    with pytest.raises(ValueError):
        gibbs_cv_folds(X, y, np.zeros_like(masks), model="BRR", n_iter=10)


def test_cvbulk_batched_bayesian_models():
    """The batched engine's Bayesian branch: fold semantics match the
    closed-form models' (same mask builder), accuracy is sane on a simulated
    additive trait, and predict() works off the stored effects."""
    import genomicbreedingmodels_tpu as gbm
    from genomicbreedingmodels_tpu.cv.batched import cvbulk_batched

    genomes = gbm.simulate_genomes(n=72, l=300, seed=19)
    trials, _ = gbm.simulate_trials(
        genomes, f_add_dom_epi=np.array([[0.6, 0.0, 0.0]]), seed=19
    )
    phenomes = gbm.extract_phenomes(trials)
    cvs, notes = cvbulk_batched(
        genomes, phenomes, models=("bayesc", "ridge"),
        n_replications=1, n_folds=3, seed=5, mcmc_n_iter=400, mcmc_n_burnin=150,
    )
    by_model = {}
    for cv in cvs:
        by_model.setdefault(cv.fit.model, []).append(cv)
    assert set(by_model) == {"bayesc", "ridge"}
    assert len(by_model["bayesc"]) == len(by_model["ridge"]) == 3
    # fold composition identical across models (same mask builder + seed)
    for a, b in zip(by_model["bayesc"], by_model["ridge"]):
        assert list(a.validation_entries) == list(b.validation_entries)
    mean_cor = np.mean([cv.metrics["cor"] for cv in by_model["bayesc"]])
    assert mean_cor > 0.3, mean_cor
    # stored effects drive predict()
    cv0 = by_model["bayesc"][0]
    idx = [list(genomes.entries).index(e) for e in cv0.validation_entries]
    yhat = gbm.predict(fit=cv0.fit, genomes=genomes, idx_entries=idx)
    np.testing.assert_allclose(yhat, cv0.y_pred, rtol=1e-4, atol=1e-5)


def test_gibbs_cv_folds_mesh_matches_single_device():
    """Fold-sharded masked chains over the mesh: identical fold keys run the
    identical per-fold program, so results must match the single-device vmap
    to f32 reduction noise — including with fold-count padding (F=6 over 8
    devices)."""
    import jax
    from jax.sharding import Mesh
    from genomicbreedingmodels_tpu.models.bayesian import gibbs_cv_folds

    mesh = Mesh(np.asarray(jax.devices()).reshape(8), ("dp",))
    rng = np.random.default_rng(4)
    n, p, F = 48, 64, 6
    X = rng.uniform(size=(n, p)).astype(np.float32)
    y = (X[:, :8] @ rng.normal(size=8) + rng.normal(size=n)).astype(np.float32)
    labels = rng.integers(0, F, size=n)
    masks = np.stack([(labels != f).astype(np.float32) for f in range(F)])
    kw = dict(model="BayesC", n_iter=120, n_burnin=40, seed=9)
    mus0, b0 = gibbs_cv_folds(X, y, masks, **kw)
    mus1, b1 = gibbs_cv_folds(X, y, masks, mesh=mesh, **kw)
    np.testing.assert_allclose(mus1, mus0, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(b1, b0, rtol=2e-3, atol=2e-4)


def test_gibbs_cv_folds_block_kernel_matches_grouped(monkeypatch):
    """Where "auto" picks the block kernel (a GPU), the fold-batched chains
    run it vmapped, one kernel program per fold, and make the XLA grouped
    scan's draws. Here the kernel runs in the Pallas interpreter."""
    import functools
    import importlib

    from genomicbreedingmodels_tpu.ops.pallas_gibbs import grouped_block_update
    from genomicbreedingmodels_tpu.utils.config import GBMConfig, reset_config, set_config

    bayes = importlib.import_module("genomicbreedingmodels_tpu.models.bayesian")
    rng = np.random.default_rng(6)
    n, p, F = 40, 60, 3
    X = (rng.integers(0, 3, size=(n, p)) / 2.0).astype(np.float32)
    y = (X[:, :4] @ rng.normal(size=4) + 0.3 * rng.normal(size=n)).astype(np.float32)
    masks = np.ones((F, n), np.float32)
    for f in range(F):
        masks[f, f::F] = 0.0
    kw = dict(model="BayesC", n_iter=16, n_burnin=4, seed=3)
    try:
        set_config(GBMConfig(mcmc_indicator_update="grouped"))
        mus_g, b_g = bayes.gibbs_cv_folds(X, y, masks, **kw)
        monkeypatch.setattr(bayes, "platform", lambda: "gpu")
        monkeypatch.setattr(bayes, "grouped_block_update",
                            functools.partial(grouped_block_update, interpret=True))
        set_config(GBMConfig(mcmc_indicator_update="auto"))
        mus_k, b_k = bayes.gibbs_cv_folds(X, y, masks, **kw)
    finally:
        reset_config()
    np.testing.assert_allclose(mus_k, mus_g, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b_k, b_g, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["ridge", "gblup"])
def test_fold_solves_run_at_full_f32_precision(name):
    """Every product of the fold solves asks for HIGHEST precision: at the
    default a tensor-core GPU rounds f32 operands to TF32, below the size of
    the small-λ training residual that GCV compares."""
    import jax
    import jax.numpy as jnp

    from genomicbreedingmodels_tpu.cv.batched import _fold_solve, _fold_solve_gblup

    fn = _fold_solve if name == "ridge" else _fold_solve_gblup
    n = 12
    jaxpr = jax.make_jaxpr(fn)(jnp.eye(n), jnp.ones(n), jnp.ones(n), jnp.ones(3))
    dots = _dot_precisions(jaxpr.jaxpr)
    assert len(dots) >= 3
    assert all(p == jax.lax.Precision.HIGHEST for p in dots), dots


def _dot_precisions(jaxpr):
    """The precision of every dot_general in a jaxpr, sub-jaxprs included."""
    import jax

    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            prec = eqn.params["precision"]
            out.append(prec[0] if isinstance(prec, tuple) else prec)
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out.extend(_dot_precisions(sub))
    return out
