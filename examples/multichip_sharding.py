"""Multi-device sharding demo: marker-sharded GRM, ridge, and Gibbs.

Runs on several GPUs or, for development, a virtual CPU mesh:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/multichip_sharding.py
"""

import numpy as np


def main():
    import jax

    import genomicbreedingmodels_tpu as gbm
    from genomicbreedingmodels_tpu.parallel.mesh import make_mesh
    from genomicbreedingmodels_tpu.parallel.sharded import (
        sharded_gibbs_regression,
        sharded_grm,
        sharded_ridge_step,
    )

    n_dev = len(jax.devices())
    print(f"{n_dev} devices: {jax.devices()[0].platform}")
    mesh = make_mesh(shape=(1, n_dev))

    genomes = gbm.simulate_genomes(n=128, l=400, seed=0)
    trials, _ = gbm.simulate_trials(genomes, f_add_dom_epi=np.array([[0.5, 0.05, 0.05]]), seed=0)
    phenomes = gbm.extract_phenomes(trials)
    X = np.asarray(genomes.allele_frequencies, np.float32)
    y = np.asarray(phenomes.phenotypes[:, 0], np.float32)

    K = sharded_grm(X, mesh)  # Gram partials psum'd over ICI
    print("sharded GRM:", K.shape)

    b0, beta = sharded_ridge_step(X, y, lam=0.1, mesh=mesh)
    print("sharded ridge: beta sharded over mesh ->", beta.shape)

    mu, b = sharded_gibbs_regression(
        X, y, mesh, model="BayesC", n_iter=300, n_burnin=100
    )
    yhat = mu + X @ b
    print(f"sharded BayesC Gibbs: fit cor = {np.corrcoef(yhat, y)[0, 1]:.3f}")


if __name__ == "__main__":
    main()
