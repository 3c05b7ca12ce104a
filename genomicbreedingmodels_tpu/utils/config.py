"""Framework configuration (the reference has none — pure kwargs everywhere,
SURVEY §5). A single dataclass with env-var overrides so production runs can
be tuned without code changes."""

from __future__ import annotations

import os
from dataclasses import dataclass, fields


@dataclass
class GBMConfig:
    # numerics
    compute_dtype: str = "float32"  # device compute dtype for model solves
    gram_block_cols: int = 262_144  # GRM column-block streaming width
    # MCMC
    mcmc_block_size: int = 256
    mcmc_n_iter: int = 1_500
    mcmc_n_burnin: int = 500
    # Within-block update of the indicator models (BayesB/C, BLπ, BayesTπ —
    # and BL, which rides the same machinery degenerated to the single
    # all-ones pattern): "grouped" runs the exact collapsed 2^K-pattern draw
    # (K=mcmc_group_size) as an XLA scan; when the per-sweep pattern table
    # fits (p/K · 2^K · K² ≤ 3.6e8 floats) the pattern Choleskys are HOISTED
    # out of the sequential scan and factorized once per sweep into one
    # masked-L⁻¹ table. "pallas" runs the same update with each block's group
    # loop as one Pallas kernel launch (ops/pallas_gibbs.py; CUDA GPUs,
    # K ≤ 8). "scalar" is the one-marker-at-a-time oracle. "auto" (default)
    # = pallas on a GPU for the indicator models when the tables fit,
    # grouped everywhere else.
    mcmc_indicator_update: str = "auto"
    # Group size K: the sequential step count per sweep is p/K, the per-step
    # pattern batch 2^K·K². Not yet tuned on the GPU.
    mcmc_group_size: int = 6
    # λ paths
    n_lambda: int = 100
    lambda_min_ratio: float = 0.01
    path_cv_folds: int = 10
    # CV harness
    cv_workers: int = 1
    # REML: 8x8 log-lattice seed + 12 projected-Newton steps. Validated
    # against the f64 dense-pinv oracle (cor >= 0.999,
    # tests/test_parity_oracles.py). Not yet tuned on the GPU.
    reml_grid: int = 8
    reml_newton: int = 12

    @classmethod
    def from_env(cls) -> "GBMConfig":
        """Override any field via GBM_<UPPER_NAME> environment variables."""
        kwargs = {}
        for f in fields(cls):
            env = os.environ.get(f"GBM_{f.name.upper()}")
            if env is not None:
                typ = type(f.default)
                kwargs[f.name] = typ(env)
        return cls(**kwargs)


_config: GBMConfig | None = None


def get_config() -> GBMConfig:
    global _config
    if _config is None:
        _config = GBMConfig.from_env()
    return _config


def set_config(cfg: GBMConfig) -> None:
    global _config
    _config = cfg


def reset_config() -> None:
    """Drop the cached config so the next get_config() re-reads the env."""
    global _config
    _config = None
