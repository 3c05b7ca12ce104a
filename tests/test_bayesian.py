"""Bayesian alphabet: native blocked Gibbs samplers (replaces R/BGLR,
reference src/bayes.jl + src/linear.jl:440-626)."""

import numpy as np
import pytest

import genomicbreedingmodels_tpu as gbm
from genomicbreedingmodels_tpu.models.bayesian import gibbs_regression


@pytest.fixture(scope="module")
def strong_additive():
    genomes = gbm.simulate_genomes(n=100, l=300, seed=42)
    trials, effects = gbm.simulate_trials(
        genomes, f_add_dom_epi=np.array([[0.5, 0.0, 0.0]]), seed=42
    )
    phenomes = gbm.extract_phenomes(trials)
    return genomes, phenomes, effects


@pytest.mark.parametrize("model_fn,name", [
    (gbm.bayesa, "bayesa"),
    (gbm.bayesb, "bayesb"),
    (gbm.bayesc, "bayesc"),
])
def test_bayes_alphabet_fits(strong_additive, model_fn, name):
    genomes, phenomes, _ = strong_additive
    fit = model_fn(genomes=genomes, phenomes=phenomes, n_iter=500, n_burnin=150)
    assert fit.model == name
    assert fit.b_hat_labels[0] == "intercept"
    assert len(fit.b_hat) == genomes.p + 1
    # reference doctest threshold (src/linear.jl:436 etc.)
    assert fit.metrics["cor"] > 0.50


def test_bayesian_ridge_and_lasso(strong_additive):
    genomes, phenomes, _ = strong_additive
    for fn, name in [(gbm.bayesian_ridge, "bayesian_ridge"), (gbm.bayesian_lasso, "bayesian_lasso")]:
        fit = fn(genomes=genomes, phenomes=phenomes, n_iter=400, n_burnin=120)
        assert fit.model == name
        assert fit.metrics["cor"] > 0.50


def test_extended_prior_taxonomy_fits(strong_additive):
    """Laplace/t priors with optional point mass — the reference documents
    these as commented-out Turing models (src/bayes.jl:510-855); here they
    are native samplers sharing the blocked-Gibbs engine."""
    genomes, phenomes, _ = strong_additive
    for fn, name in [
        (gbm.bayesian_lasso_pi, "bayesian_lasso_pi"),
        (gbm.bayest, "bayest"),
        (gbm.bayestpi, "bayestpi"),
    ]:
        fit = fn(genomes=genomes, phenomes=phenomes, n_iter=400, n_burnin=120)
        assert fit.model == name
        assert np.all(np.isfinite(fit.b_hat))
        assert fit.metrics["cor"] > 0.50
        # predict() must accept the new model names
        yhat = gbm.predict(fit, genomes, idx_entries=list(range(10)))
        assert np.all(np.isfinite(yhat))


def test_point_mass_models_shrink_null_markers(strong_additive):
    """With a sparse true signal, the π variants should place markedly more
    posterior mass at ~zero for null markers than their dense counterparts."""
    rng = np.random.default_rng(1)
    X = rng.random((120, 240)).astype(np.float32)
    b_true = np.zeros(240)
    b_true[:3] = [2.0, -1.5, 1.0]
    y = X @ b_true + 0.2 * rng.normal(size=120)
    _, b_pi, _ = gibbs_regression(X, y, model="BLPi", n_iter=500, n_burnin=200, seed=5)
    _, b_bl, _ = gibbs_regression(X, y, model="BL", n_iter=500, n_burnin=200, seed=5)
    null_pi = np.mean(np.abs(b_pi[3:]))
    null_bl = np.mean(np.abs(b_bl[3:]))
    assert null_pi < null_bl  # point mass shrinks the null background harder
    # signal survives
    assert np.corrcoef(X @ b_pi, X @ b_true)[0, 1] > 0.9


def test_gibbs_recovers_genetic_signal(strong_additive):
    genomes, phenomes, effects = strong_additive
    X = genomes.allele_frequencies
    y = phenomes.phenotypes[:, 0]
    mu, b, _ = gibbs_regression(X, y, model="BayesA", n_iter=600, n_burnin=200, seed=3)
    gebv = X @ b
    r = np.corrcoef(effects[0].genetic_values, gebv)[0, 1]
    assert r > 0.5


def test_gibbs_blocked_equals_unblocked_distribution(strong_additive):
    """Block size must not change the stationary distribution: posterior means
    from different block sizes agree to MCMC noise."""
    genomes, phenomes, _ = strong_additive
    X = genomes.allele_frequencies[:, :128]
    y = phenomes.phenotypes[:, 0]
    mu1, b1, _ = gibbs_regression(X, y, model="BRR", n_iter=1500, n_burnin=500, seed=11, block_size=16)
    mu2, b2, _ = gibbs_regression(X, y, model="BRR", n_iter=1500, n_burnin=500, seed=12, block_size=128)
    yp1, yp2 = mu1 + X @ b1, mu2 + X @ b2
    assert np.corrcoef(yp1, yp2)[0, 1] > 0.98


def test_gibbs_multichain(strong_additive):
    genomes, phenomes, _ = strong_additive
    X = genomes.allele_frequencies[:, :64]
    y = phenomes.phenotypes[:, 0]
    mu, b, _ = gibbs_regression(X, y, model="BayesC", n_iter=200, n_burnin=80, seed=5, n_chains=2)
    assert np.isfinite(mu)
    assert b.shape == (64,)


def test_sigma_trace_is_positive(strong_additive):
    genomes, phenomes, _ = strong_additive
    X = genomes.allele_frequencies[:, :64]
    y = phenomes.phenotypes[:, 0]
    _, _, diag = gibbs_regression(X, y, model="BayesA", n_iter=100, n_burnin=50, seed=5)
    tr = diag["sigma_e2_trace"]
    assert np.all(tr > 0)
    assert np.all(np.isfinite(tr))


def test_bayesian_rejects_unknown(strong_additive):
    genomes, phenomes, _ = strong_additive
    with pytest.raises(ValueError):
        gibbs_regression(genomes.allele_frequencies, phenomes.phenotypes[:, 0], model="BayesZ")
    with pytest.raises(ValueError):
        gbm.bayesian("BayesA", genomes=genomes, phenomes=phenomes, response_type="poisson")


def test_bglr_low_level_entry():
    """Name/shape-compatible with the reference's bglr (src/bayes.jl:28-105):
    G + y in, [mu; effects] out — native sampler, no subprocess."""
    import genomicbreedingmodels_tpu as gbm

    rng = np.random.default_rng(0)
    G = rng.random((80, 200))
    b_true = np.zeros(200)
    b_true[:5] = 1.0
    y = G @ b_true + 0.3 * rng.normal(size=80)
    b = gbm.bglr(G, y, model="BayesC", n_iter=600, n_burnin=200)
    assert b.shape == (201,)
    yp = b[0] + G @ b[1:]
    assert np.corrcoef(yp, y)[0, 1] > 0.8
    with pytest.raises(ValueError):
        gbm.bglr(G, y, response_type="poisson")


def test_ordinal_probit_response():
    """Albert-Chib probit augmentation (reference response_type passthrough
    to BGLR, src/bayes.jl): latent liability recovered from category codes."""
    rng = np.random.default_rng(0)
    n, p = 150, 200
    X = rng.random((n, p)).astype(np.float32)
    b_true = np.zeros(p)
    b_true[[3, 60, 150]] = [2.0, -1.5, 1.8]
    liab = X @ b_true
    liab = (liab - liab.mean()) / liab.std()
    y3 = np.digitize(liab + 0.4 * rng.normal(size=n), [-0.5, 0.5])
    mu, b, _ = gibbs_regression(
        X, y3.astype(float), model="BayesC", n_iter=800, n_burnin=300,
        response_type="ordinal",
    )
    eta = mu + X @ b
    assert np.corrcoef(eta, liab)[0, 1] > 0.6

    # binary case
    y2 = (liab + 0.4 * rng.normal(size=n) > 0).astype(float)
    mu2, b2, _ = gibbs_regression(
        X, y2, model="BRR", n_iter=600, n_burnin=200, response_type="ordinal"
    )
    eta2 = mu2 + X @ b2
    assert np.corrcoef(eta2, liab)[0, 1] > 0.5

    with pytest.raises(ValueError):
        gibbs_regression(X, y2, response_type="poisson")
    with pytest.raises(ValueError):
        gibbs_regression(X, np.ones(n), response_type="ordinal")  # 1 category


def test_segmented_chain_is_bit_identical_and_resumable(tmp_path):
    """Chunked execution carries the RNG in state: N short scans == one long
    scan, and a checkpoint resume reproduces the straight run exactly."""
    rng = np.random.default_rng(0)
    X = rng.random((80, 200)).astype(np.float32)
    b_true = np.zeros(200)
    b_true[:4] = [1, -1, 0.5, 2]
    y = X @ b_true + 0.3 * rng.normal(size=80)
    mu1, b1, d1 = gibbs_regression(X, y, model="BayesC", n_iter=400, n_burnin=150, seed=3)
    mu2, b2, d2 = gibbs_regression(
        X, y, model="BayesC", n_iter=400, n_burnin=150, seed=3, chunk_size=75
    )
    assert abs(mu1 - mu2) < 1e-5
    np.testing.assert_allclose(b1, b2, atol=1e-6)
    np.testing.assert_allclose(d1["sigma_e2_trace"], d2["sigma_e2_trace"], atol=1e-6)

    ck = str(tmp_path / "chain.npz")
    # simulate a crash after 200 sweeps, then resume to 400
    gibbs_regression(X, y, model="BayesC", n_iter=200, n_burnin=150, seed=3,
                     chunk_size=100, checkpoint_path=ck)
    mu3, b3, _ = gibbs_regression(X, y, model="BayesC", n_iter=400, n_burnin=150, seed=3,
                                  chunk_size=100, checkpoint_path=ck)
    assert abs(mu1 - mu3) < 1e-5
    np.testing.assert_allclose(b1, b3, atol=1e-6)


@pytest.mark.parametrize(
    "model,b_thr",
    # BL rides the same grouped machinery degenerated to the single
    # all-ones pattern (K-marker joint Gaussian draws) — equivalence AND
    # stability on this p>n strong-LD panel (the full-block joint draw
    # diverges for BL here; the K-marker draw must not).
    # BL has NO per-effect agreement bar: under this panel's 8-marker LD
    # blocks its shrinkage spreads effects arbitrarily among correlated
    # markers — two SCALAR chains with different seeds measure effect
    # correlation ≈ -0.07 while agreeing on GEBV to 0.996 — so only the
    # GEBV/σ²ₑ invariants below are meaningful for it.
    [("BayesC", 0.95), ("BayesB", 0.95), ("BLPi", 0.95), ("BayesTPi", 0.90),
     ("BL", None)],
)
def test_grouped_indicator_matches_scalar_oracle(model, b_thr):
    """The grouped 2^K-pattern collapsed draw (VERDICT r2 item 2) targets the
    IDENTICAL posterior as the one-marker-at-a-time scalar scan — check
    posterior-mean effects, GEBV, and the inclusion rate agree within MCMC
    noise on a strong-LD (block-correlated) panel, where indicator coupling
    is at its worst."""
    rng = np.random.default_rng(0)
    n, p = 160, 384
    base = rng.normal(size=(n, p // 8))
    X = np.repeat(base, 8, axis=1) * 0.8 + 0.2 * rng.normal(size=(n, p))
    X = ((X - X.mean(0)) / (X.std(0) + 1e-8)).astype(np.float32)
    b_true = np.zeros(p)
    idx = rng.choice(p, 16, replace=False)
    b_true[idx] = rng.normal(size=16)
    y = (X @ b_true + 0.5 * rng.normal(size=n)).astype(np.float32)

    out = {}
    for upd in ("scalar", "grouped"):
        mu, b, diag = gibbs_regression(
            X, y, model=model, n_iter=600, n_burnin=200, seed=1,
            indicator_update=upd,
        )
        out[upd] = (mu, b, diag)
    b_s, b_g = out["scalar"][1], out["grouped"][1]
    # Bounds are chain-to-chain noise at 600 sweeps (two scalar chains with
    # different seeds agree no better), not kernel error. BayesTπ's fixed
    # Cauchy prior (df=1) gives the posterior-mean estimator heavy-tailed
    # sweep noise, so its per-effect agreement band is wider.
    if b_thr is not None:
        assert np.corrcoef(b_s, b_g)[0, 1] > b_thr
    gebv_s, gebv_g = X @ b_s, X @ b_g
    assert np.corrcoef(gebv_s, gebv_g)[0, 1] > 0.99
    # residual-variance posterior agreement (same stationary distribution)
    s2_s = float(np.mean(out["scalar"][2]["sigma_e2_trace"][200:]))
    s2_g = float(np.mean(out["grouped"][2]["sigma_e2_trace"][200:]))
    if model == "BL":
        # BL's σ²ₑ mixes at ESS ≈ 2-15 per 600 scalar sweeps here; measured
        # arbitration at 6000 sweeps: scalar 6.70 vs grouped 6.93 (same
        # posterior; the short scalar chains sit low). At 600 sweeps only a
        # loose same-scale band is meaningful, plus stability (the
        # full-block joint draw DIVERGES on this panel — σ²ₑ must stay
        # bounded and effects finite).
        assert 0.25 < s2_g / s2_s < 4.0
        assert np.all(np.isfinite(b_g)) and np.all(np.isfinite(b_s))
        assert np.all(out["grouped"][2]["sigma_e2_trace"] < 1e3)
    else:
        assert abs(s2_s - s2_g) / s2_s < 0.25
    with pytest.raises(ValueError):
        gibbs_regression(X, y, model=model, n_iter=10, indicator_update="nope")


def test_gibbs_regression_device_panel_matches_host_panel():
    """A jax-array panel must produce the BIT-IDENTICAL chain as the numpy
    path (the device branch skips the host round-trip; at-size benches
    synthesize the panel on the device, so it never crosses to the host)."""
    import jax.numpy as jnp
    from genomicbreedingmodels_tpu.models.bayesian import gibbs_regression

    rng = np.random.default_rng(12)
    X = (rng.integers(0, 3, size=(40, 96)) / 2.0).astype(np.float32)
    y = (X[:, :5] @ rng.normal(size=5) + 0.3 * rng.normal(size=40)).astype(np.float32)
    # Pin the variances: the only host/device divergence allowed is the
    # last-ulp of the on-device ms_x reduction feeding the hyper-scales, and
    # pinning removes the chain's dependence on them — so the draws must be
    # BIT-identical.
    kw = dict(model="BayesC", n_iter=80, n_burnin=20, seed=3,
              fix_sigma_e2=0.09, fix_sigma_b2=0.05)
    mu_h, b_h, dg_h = gibbs_regression(X, y, **kw)
    mu_d, b_d, dg_d = gibbs_regression(jnp.asarray(X), y, **kw)
    assert mu_d == mu_h
    np.testing.assert_array_equal(b_d, b_h)
    np.testing.assert_array_equal(dg_d["sigma_e2_trace"], dg_h["sigma_e2_trace"])
    # Unpinned: same posterior up to the ulp-level hyper-scale difference.
    mu_h2, b_h2, _ = gibbs_regression(X, y, model="BayesC", n_iter=80, n_burnin=20, seed=3)
    mu_d2, b_d2, _ = gibbs_regression(jnp.asarray(X), y, model="BayesC", n_iter=80, n_burnin=20, seed=3)
    assert abs(mu_d2 - mu_h2) < 5e-3 * max(1.0, abs(mu_h2))
    assert np.corrcoef(b_d2, b_h2)[0, 1] > 0.99


def test_indicator_update_auto_is_grouped_on_cpu_and_pallas_refused():
    """Off the GPU "auto" resolves to the XLA grouped scan (bit-identical
    chain to an explicit "grouped"), and an explicit "pallas" — a CUDA
    kernel — is a ValueError, not a silent interpret-mode run."""
    rng = np.random.default_rng(4)
    X = rng.random((40, 72)).astype(np.float32)
    y = (X[:, :3] @ np.array([1.0, -1.0, 0.5]) + 0.3 * rng.normal(size=40)).astype(np.float32)
    kw = dict(model="BayesC", n_iter=30, n_burnin=10, seed=5)
    mu_a, b_a, d_a = gibbs_regression(X, y, indicator_update="auto", **kw)
    mu_g, b_g, d_g = gibbs_regression(X, y, indicator_update="grouped", **kw)
    assert mu_a == mu_g
    np.testing.assert_array_equal(b_a, b_g)
    np.testing.assert_array_equal(d_a["sigma_e2_trace"], d_g["sigma_e2_trace"])
    with pytest.raises(ValueError, match="CUDA kernel"):
        gibbs_regression(X, y, indicator_update="pallas", **kw)


def test_block_kernel_resolution(monkeypatch):
    """Where the indicator draw runs as the Pallas block kernel: "auto" takes
    it on a GPU for the indicator models while the hoisted tables of every
    vmapped chain fit; never for BL/continuous priors or K=1; "pallas" off
    the GPU is refused."""
    import importlib

    bayes = importlib.import_module("genomicbreedingmodels_tpu.models.bayesian")
    on = bayes._block_kernel_on
    assert not on("auto", True, 6, 102_000)  # CPU
    assert not on("grouped", True, 6, 102_000)
    with pytest.raises(ValueError, match="CUDA kernel"):
        on("pallas", True, 6, 102_000)
    assert not on("pallas", False, 6, 102_000)  # not an indicator model
    monkeypatch.setattr(bayes, "platform", lambda: "gpu")
    assert on("auto", True, 6, 102_000)
    assert on("auto", True, 6, 102_000, batch=5)  # 5 CV folds' tables fit
    assert not on("auto", True, 6, 102_000, batch=10)  # 10 folds' do not
    assert not on("auto", True, 1, 102_000)
    assert not on("auto", True, bayes.MAX_GROUP_SIZE + 1, 102_000)
    assert not on("auto", False, 6, 102_000)
    assert not on("grouped", True, 6, 102_000)
    assert on("pallas", True, 6, 102_000)


def test_group_table_accounting_is_unpadded():
    """The hoist gate counts the table's real floats, (p/K)·2^K·K² per chain,
    with no tile padding on any backend."""
    from genomicbreedingmodels_tpu.models.bayesian import (
        _GROUP_TABLE_MAX_FLOATS,
        _group_tables_fit,
    )

    # 10k x 102k, K=6: 17000 groups x 64 patterns x 36 = 39.2M floats.
    assert _group_tables_fit(102_000, 6, 64)
    # The budget edge is exact: one more group's table tips it over.
    K, n_pat = 8, 256
    per_group = n_pat * K * K
    groups = _GROUP_TABLE_MAX_FLOATS // per_group
    assert _group_tables_fit(groups * K, K, n_pat)
    assert not _group_tables_fit((groups + 1) * K, K, n_pat)
    # Vmapped chains (CV folds) multiply the resident tables.
    assert not _group_tables_fit(groups * K, K, n_pat, batch=2)
