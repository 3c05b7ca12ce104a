"""genomicbreedingmodels_tpu — JAX-native genomic prediction framework.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of
GenomicBreeding/GenomicBreedingModels.jl (reference mounted read-only at
/root/reference): genomic-prediction model zoo (OLS, ridge/RR-BLUP, LASSO,
Bayes A/B/C Gibbs), GWAS suite (OLS / LMM / REML scans with GRM population-
structure correction), epistasis feature engineering, and a replicated
cross-validation harness — plus the core data layer (Genomes/Phenomes/Trials,
GRM kernels, trial simulator) the reference imports from its external core
package.

Public API mirrors the reference's exports (src/GenomicBreedingModels.jl:35-48)
in snake_case Python.
"""

from .core.structs import (
    CV,
    Fit,
    Genomes,
    Phenomes,
    SimulatedEffects,
    Trials,
    checkdims,
    clone,
    slice_genomes,
    slice_phenomes,
)
from .core.simulation import extract_phenomes, simulate_genomes, simulate_trials
from .core.grm import grm_ploidy_aware, grm_simple, infer_ploidy
from .core.tabularise import summarise, tabularise
from .ops.metrics import metrics
from .prediction import extractxyetc, mean_impute, predict
from .models.linear import lasso, ols, ridge
from .models.bayesian import (
    bayesa,
    bayesb,
    bayesc,
    bayesian,
    bayesian_lasso,
    bayesian_lasso_pi,
    bayesian_ridge,
    bayest,
    bayestpi,
    gibbs_regression,
    bglr,
)
from .models.gwas import gwaslmm, gwasols, gwasprep, gwasreml, loglikreml
from .models.gblup import gblup, gblup_multitrait, reml_variance_components
from .models.multitrait import gblup_multienv, gblup_multitrait_cov, mtgblup_em
from .models.mlp import mlp
from .cv.batched import cvbulk_batched
from .plots import manhattan_data, plot_cv, plot_manhattan
from .streaming import BedShardStreamer, gblup_from_bed, grm_from_bed
from .io import (
    read_bed,
    read_genomes_tsv,
    read_phenomes_tsv,
    read_vcf,
    write_bed,
    write_genomes_tsv,
    write_phenomes_tsv,
)
from .features.endofunctions import (
    addnorm,
    invoneplus,
    log10epsdivlog10eps,
    mult,
    raise_,
    square,
)
from .features.transform import (
    epistasisfeatures,
    reconstitutefeatures,
    transform1,
    transform2,
)
from .cv.harness import (
    cvbulk,
    cvdispatch,
    cvleaveonepopulationout,
    cvmultithread,
    cvpairwisepopulation,
    cvperpopulation,
    validate,
)
from .utils.devcache import clear_device_caches

__version__ = "0.1.0"

__all__ = [
    "CV",
    "Fit",
    "Genomes",
    "Phenomes",
    "SimulatedEffects",
    "Trials",
    "checkdims",
    "clone",
    "slice_genomes",
    "slice_phenomes",
    "simulate_genomes",
    "simulate_trials",
    "extract_phenomes",
    "grm_simple",
    "grm_ploidy_aware",
    "infer_ploidy",
    "metrics",
    "extractxyetc",
    "mean_impute",
    "predict",
    "ols",
    "ridge",
    "lasso",
    "bayesa",
    "bayesb",
    "bayesc",
    "bayesian",
    "bayesian_ridge",
    "bayesian_lasso",
    "bayesian_lasso_pi",
    "bayest",
    "bayestpi",
    "gibbs_regression",
    "bglr",
    "gblup",
    "gblup_multitrait",
    "gblup_multitrait_cov",
    "gblup_multienv",
    "mtgblup_em",
    "mlp",
    "read_bed",
    "BedShardStreamer",
    "grm_from_bed",
    "gblup_from_bed",
    "manhattan_data",
    "plot_manhattan",
    "plot_cv",
    "read_genomes_tsv",
    "read_phenomes_tsv",
    "read_vcf",
    "write_bed",
    "write_genomes_tsv",
    "write_phenomes_tsv",
    "reml_variance_components",
    "gwasprep",
    "gwasols",
    "gwaslmm",
    "gwasreml",
    "loglikreml",
    "square",
    "invoneplus",
    "log10epsdivlog10eps",
    "mult",
    "addnorm",
    "raise_",
    "transform1",
    "transform2",
    "epistasisfeatures",
    "reconstitutefeatures",
    "validate",
    "cvdispatch",
    "cvmultithread",
    "cvbulk",
    "cvbulk_batched",
    "cvperpopulation",
    "cvpairwisepopulation",
    "cvleaveonepopulationout",
    "tabularise",
    "summarise",
    "clear_device_caches",
]
