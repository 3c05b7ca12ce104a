"""GBLUP: GRM-based mixed-model genomic prediction with REML variance
components.

The reference has no standalone GBLUP model function (its GWAS code embeds the
same 2-variance-component REML per marker, src/gwas.jl:450-483); BASELINE.json
names "GBLUP mixed-model solves (REML variance components + BLUP)" as a
headline capability, so it is first-class here.

Design: eigendecompose the GRM once (K = U S Uᵀ); the REML objective is
then O(n) per evaluation, optimized with the same grid-seeded projected Newton
used by the GWAS REML scan. Marker effects are recovered by the RR-BLUP
equivalence b = (σ²ᵤ/c) Zᵀ (σ²ᵤK + σ²ₑI)⁻¹ y_c (c = GRM denominator), so the
returned Fit predicts new entries through the ordinary `predict` GEMV path and
plugs into the CV harness unchanged.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..core.grm import grm_ploidy_aware, grm_simple, infer_ploidy
from ..core.structs import Fit, Genomes, Phenomes
from ..ops.metrics import metrics
from ..prediction import extractxyetc
from .gwas import _eigh_device, _reml_scan

__all__ = ["gblup", "gblup_multitrait", "reml_variance_components"]


def _eigh_sym(K: np.ndarray):
    """Eigendecomposition of the symmetrized GRM on the accelerator (f32).
    Returns f64 numpy views for downstream math."""
    s, U = _eigh_device(jnp.asarray(K, jnp.float32))
    return np.asarray(s, dtype=np.float64), np.asarray(U, dtype=np.float64)


def reml_variance_components(
    y: np.ndarray, K: np.ndarray, eig=None
) -> Tuple[float, float]:
    """REML (σ²_e, σ²_u) for y = 1μ + u + e, u ~ N(0, σ²_u K).

    y is standardized internally so the reference bounds [eps, 1]² apply; the
    components are returned on the original scale of y. `eig=(s, U)` reuses a
    precomputed eigendecomposition of the symmetrized K.
    """
    y = np.asarray(y, dtype=np.float64)
    sd = y.std(ddof=1)
    ys = (y - y.mean()) / sd
    Ksym = (K + K.T) / 2.0
    s, U = eig if eig is not None else _eigh_sym(Ksym)
    # Normalize K scale so σ²_u is per unit diagonal.
    kscale = float(np.mean(np.diag(Ksym)))
    kscale = kscale if kscale > 1e-12 else 1.0
    yt = jnp.asarray(U.T @ ys, jnp.float32)
    ones_t = jnp.asarray((U.T @ np.ones(len(y)))[:, None], jnp.float32)
    z, theta = _reml_scan(yt, ones_t[None, :, :], jnp.asarray(s / kscale, jnp.float32))
    th = np.asarray(theta[0], dtype=np.float64)
    var = sd**2
    return float(th[0] * var), float(th[1] * var / kscale)


def gblup(
    genomes: Genomes,
    phenomes: Phenomes,
    idx_entries: Optional[Sequence[int]] = None,
    idx_loci_alleles: Optional[Sequence[int]] = None,
    idx_trait: int = 0,
    GRM_type: str = "simple",
    verbose: bool = False,
) -> Fit:
    """Fit GBLUP; returns a Fit whose b_hat are RR-BLUP-equivalent marker
    effects (so `predict` and the CV harness work unchanged), with REML
    variance components and h² in `fit.extras`."""
    X, y, entries, populations, loci_alleles = extractxyetc(
        genomes, phenomes, idx_entries=idx_entries, idx_loci_alleles=idx_loci_alleles,
        idx_trait=idx_trait, add_intercept=False,
    )
    sub = Genomes(
        entries=entries, populations=populations, loci_alleles=loci_alleles,
        allele_frequencies=X,
    )
    if GRM_type == "ploidy-aware":
        grm = grm_ploidy_aware(sub, ploidy=infer_ploidy(X))
    elif GRM_type == "simple":
        grm = grm_simple(sub)
    else:
        raise ValueError(f"unrecognised GRM_type {GRM_type!r}")
    K = grm.genomic_relationship_matrix.astype(np.float64)
    denom = grm.denominator

    s, U = _eigh_sym((K + K.T) / 2.0)  # one decomposition, shared with REML
    sigma2_e, sigma2_u = reml_variance_components(y, K, eig=(s, U))
    kdiag = float(np.mean(np.diag(K)))
    h2 = sigma2_u * kdiag / (sigma2_u * kdiag + sigma2_e) if (sigma2_u + sigma2_e) > 0 else 0.0

    # Marker effects via the eigenbasis: alpha = (σ²ᵤK + σ²ₑI)⁻¹ y_c.
    yc = y - y.mean()
    d = sigma2_u * s + sigma2_e
    d[d < 1e-12] = 1e-12
    alpha = U @ ((U.T @ yc) / d)
    Z = X - X.mean(axis=0, keepdims=True)
    b = (sigma2_u / denom) * (Z.T @ alpha)
    b0 = float(y.mean() - X.mean(axis=0) @ b)
    b_hat = np.concatenate([[b0], b])
    y_pred = b0 + X @ b

    fit = Fit(
        model="gblup",
        b_hat=b_hat,
        b_hat_labels=np.concatenate([np.asarray(["intercept"], dtype=object), loci_alleles]),
        trait=str(phenomes.traits[idx_trait]),
        entries=entries,
        populations=populations,
        y_true=y,
        y_pred=y_pred,
        metrics=metrics(y, y_pred),
        extras={
            "sigma2_e": sigma2_e,
            "sigma2_u": sigma2_u,
            "h2": h2,
            "grm_type": GRM_type,
        },
    )
    if not fit.checkdims():
        raise RuntimeError("error fitting gblup")
    return fit


def gblup_multitrait(
    genomes: Genomes,
    phenomes: Phenomes,
    idx_entries: Optional[Sequence[int]] = None,
    idx_loci_alleles: Optional[Sequence[int]] = None,
    GRM_type: str = "simple",
    verbose: bool = False,
) -> list:
    """GBLUP for EVERY trait from one GRM + one eigendecomposition.

    The per-trait work after the shared O(n²p) Gram and O(n³) eigh is O(n)
    REML + two GEMVs — fitting T traits costs barely more than one (the
    reference refits everything per trait). Entries with missing phenotypes
    are handled per trait by masking in the eigenbasis via a dense refit only
    when needed (traits with complete records share the fast path).
    Returns a list of Fit, one per trait, each CV-harness compatible.
    """
    if not genomes.checkdims():
        raise ValueError("the Genomes struct is corrupted")
    if not phenomes.checkdims():
        raise ValueError("the Phenomes struct is corrupted")
    fits = []
    # Fast path: complete-record traits share GRM + eigh through one prep.
    idx_e = np.arange(genomes.n) if idx_entries is None else np.asarray(idx_entries)
    phi_all = phenomes.phenotypes[idx_e]
    complete = np.flatnonzero(np.all(np.isfinite(phi_all), axis=0))
    incomplete = [t for t in range(phenomes.t) if t not in set(complete.tolist())]

    if len(complete):
        X, y0, entries, populations, loci_alleles = extractxyetc(
            genomes, phenomes, idx_entries=idx_entries,
            idx_loci_alleles=idx_loci_alleles, idx_trait=int(complete[0]),
            add_intercept=False,
        )
        sub = Genomes(
            entries=entries, populations=populations, loci_alleles=loci_alleles,
            allele_frequencies=X,
        )
        if GRM_type == "ploidy-aware":
            grm = grm_ploidy_aware(sub, ploidy=infer_ploidy(X))
        elif GRM_type == "simple":
            grm = grm_simple(sub)
        else:
            raise ValueError(f"unrecognised GRM_type {GRM_type!r}")
        K = grm.genomic_relationship_matrix.astype(np.float64)
        denom = grm.denominator
        Ksym = (K + K.T) / 2.0
        s, U = _eigh_sym(Ksym)
        kscale = float(np.mean(np.diag(Ksym))) or 1.0
        ones_t = jnp.asarray((U.T @ np.ones(len(entries)))[:, None], jnp.float32)
        Z = X - X.mean(axis=0, keepdims=True)
        kdiag = float(np.mean(np.diag(K)))
        for t in complete.tolist():
            yt_raw = np.asarray(phenomes.phenotypes[idx_e, t], dtype=np.float64)
            sd = yt_raw.std(ddof=1)
            ys = (yt_raw - yt_raw.mean()) / sd
            yt = jnp.asarray(U.T @ ys, jnp.float32)
            _, theta = _reml_scan(yt, ones_t[None, :, :], jnp.asarray(s / kscale, jnp.float32))
            th = np.asarray(theta[0], dtype=np.float64)
            var = sd**2
            sigma2_e, sigma2_u = float(th[0] * var), float(th[1] * var / kscale)
            h2 = sigma2_u * kdiag / (sigma2_u * kdiag + sigma2_e) if (sigma2_u + sigma2_e) > 0 else 0.0
            d = np.maximum(sigma2_u * s + sigma2_e, 1e-12)
            yc = yt_raw - yt_raw.mean()
            alpha = U @ ((U.T @ yc) / d)
            b = (sigma2_u / denom) * (Z.T @ alpha)
            b0 = float(yt_raw.mean() - X.mean(axis=0) @ b)
            y_pred = b0 + X @ b
            fit = Fit(
                model="gblup",
                b_hat=np.concatenate([[b0], b]),
                b_hat_labels=np.concatenate(
                    [np.asarray(["intercept"], dtype=object), loci_alleles]
                ),
                trait=str(phenomes.traits[t]),
                entries=entries,
                populations=populations,
                y_true=yt_raw,
                y_pred=y_pred,
                metrics=metrics(yt_raw, y_pred),
                extras={"sigma2_e": sigma2_e, "sigma2_u": sigma2_u, "h2": h2,
                        "grm_type": GRM_type},
            )
            if not fit.checkdims():
                raise RuntimeError("error fitting multitrait gblup")
            fits.append(fit)
    for t in incomplete:
        fits.append(
            gblup(genomes, phenomes, idx_entries=idx_entries,
                  idx_loci_alleles=idx_loci_alleles, idx_trait=t,
                  GRM_type=GRM_type, verbose=verbose)
        )
    order = {str(phenomes.traits[t]): i for i, t in enumerate(list(complete) + incomplete)}
    fits.sort(key=lambda f: order[f.trait])
    return fits
