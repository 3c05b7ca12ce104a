"""Quickstart: simulate a breeding panel, fit the model zoo, cross-validate.

Run: python examples/quickstart.py          (GPU if available, else CPU)
"""

import numpy as np

import genomicbreedingmodels_tpu as gbm


def main():
    # 1. Simulate a founder-cross panel (kinship + LD) and multi-env trials.
    genomes = gbm.simulate_genomes(n=200, l=2_000, n_populations=2, seed=42)
    trials, effects = gbm.simulate_trials(
        genomes,
        f_add_dom_epi=np.array([[0.5, 0.05, 0.05]]),  # additive/dom/epi variance
        n_years=2,
        n_replications=2,
        seed=42,
    )
    phenomes = gbm.extract_phenomes(trials)

    # 2. Fit each model on the first 160 entries, predict the held-out 40.
    train, test = list(range(160)), list(range(160, 200))
    y = np.asarray(phenomes.phenotypes[:, 0], float)
    for name, model in [
        ("ols", gbm.ols), ("ridge", gbm.ridge), ("lasso", gbm.lasso),
        ("gblup", gbm.gblup), ("bayesa", gbm.bayesa), ("mlp", gbm.mlp),
    ]:
        fit = model(genomes=genomes, phenomes=phenomes, idx_entries=train)
        y_hat = gbm.predict(fit, genomes, idx_entries=test)
        print(f"{name:8s} in-sample cor={fit.metrics['cor']:.3f} "
              f"held-out cor={np.corrcoef(y_hat, y[test])[0, 1]:.3f}")

    # 3. Replicated k-fold CV (batched engine) + summary table.
    cvs, notes = gbm.cvbulk_batched(genomes, phenomes, n_replications=2, n_folds=5)
    df_across, df_per_entry = gbm.tabularise(cvs)
    print("\nCV accuracy (batched ridge engine):")
    print(df_across.groupby("trait")["cor"].describe()[["mean", "std"]])


if __name__ == "__main__":
    main()
