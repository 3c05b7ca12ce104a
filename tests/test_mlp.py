"""MLP model (JAX realization of the reference's disabled DL extension,
reference src/dl.jl:82-211)."""

import numpy as np
import pytest


def test_mlp_fit_and_insample_accuracy(sim_small):
    import genomicbreedingmodels_tpu as gbm

    genomes, phenomes, _ = sim_small
    fit = gbm.mlp(genomes, phenomes, idx_trait=0, n_epochs=400, hidden_dims=[64, 64])
    assert fit.model == "mlp"
    assert fit.metrics["cor"] > 0.5
    assert np.isfinite(fit.extras["final_loss"])


def test_mlp_predict_heldout():
    import genomicbreedingmodels_tpu as gbm

    genomes = gbm.simulate_genomes(n=100, l=500, seed=11)
    trials, _ = gbm.simulate_trials(
        genomes, f_add_dom_epi=np.array([[0.5, 0.05, 0.05]]), seed=11
    )
    phenomes = gbm.extract_phenomes(trials)
    y = np.asarray(phenomes.phenotypes[:, 0], float)
    fit = gbm.mlp(genomes, phenomes, idx_entries=list(range(70)), n_epochs=800)
    yp = gbm.predict(fit, genomes, idx_entries=list(range(70, 100)))
    assert yp.shape == (30,)
    # founder-cross panel carries kinship: held-out accuracy must be real
    assert np.corrcoef(yp, y[70:])[0, 1] > 0.3


def test_mlp_in_cvbulk(sim_small):
    import genomicbreedingmodels_tpu as gbm

    genomes, phenomes, _ = sim_small
    cvs, _ = gbm.cvbulk(
        genomes, phenomes, models=["mlp"], n_replications=1, n_folds=2, seed=42
    )
    assert len(cvs) == 2
    assert all(np.isfinite(cv.metrics["cor"]) for cv in cvs)


def test_mlp_dropout_and_seed_determinism(sim_small):
    import genomicbreedingmodels_tpu as gbm

    genomes, phenomes, _ = sim_small
    kw = dict(idx_trait=0, n_epochs=50, hidden_dims=[32], dropout_rate=0.2, seed=7)
    f1 = gbm.mlp(genomes, phenomes, **kw)
    f2 = gbm.mlp(genomes, phenomes, **kw)
    assert np.allclose(f1.y_pred, f2.y_pred)
