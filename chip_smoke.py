#!/usr/bin/env python3
"""On-card smoke test: the main paths at real sizes, each checked against a
plain f64 (or exact) reference, on one CUDA GPU.

    python chip_smoke.py           # phases 0-4 on one card
    python chip_smoke.py --multi   # the mesh phase only, on 4 cards

Every phase prints lines of the form

    [phase] shape=... wall_s=... err=... tol=... precision=... -> ok|FAIL

A failed check or a phase that raises makes the script exit non-zero; the
contract line (the last line of stdout) is printed only when every phase
passed:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

The script needs the package beside it (it refuses an installed copy) and a
GPU (there is no CPU fallback). Everything runs in this one process, so one
process holds the card. Data is synthesized from fixed seeds.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

# "dot precision" as printed per phase: f32 products at XLA's default
# precision run in TF32 on tensor-core GPUs. The one site where TF32 missed
# a check sets HIGHEST (full f32): the CV fold solves, whose GCV picked λ by
# rounding noise.
DEFAULT_PREC = "f32-default(TF32)"
HIGHEST_PREC = "f32-HIGHEST"
EXACT_PREC = "int8xint8->int32(exact)"


class Report:
    """Collects check lines; a failed check or phase fails the run."""

    def __init__(self, out=None):
        self.out = out if out is not None else sys.stdout
        self.failures: list[str] = []

    def line(self, phase, shape, wall, err, tol, precision, note=""):
        ok = bool(np.isfinite(err)) and err <= tol
        print(
            f"[{phase}] shape={shape} wall_s={wall:.3f} err={err:.3e} "
            f"tol={tol:.1e} precision={precision}"
            + (f" {note}" if note else "")
            + f" -> {'ok' if ok else 'FAIL'}",
            file=self.out, flush=True,
        )
        if not ok:
            self.failures.append(f"{phase}: err {err:.3e} > tol {tol:.1e}")
        return ok

    def info(self, phase, msg):
        print(f"[{phase}] {msg}", file=self.out, flush=True)

    def run(self, name, fn, *args):
        try:
            fn(self, *args)
        except Exception as err:  # recorded as a failure, never as success
            traceback.print_exc()
            print(f"[{name}] raised {type(err).__name__}: {err!s:.300} -> FAIL",
                  file=self.out, flush=True)
            self.failures.append(f"{name}: {type(err).__name__}")


# ---------------------------------------------------------------------------
# f64 / exact references (host numpy; tested at tiny shapes on the CPU)
# ---------------------------------------------------------------------------


def rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def cor_err(a, b) -> float:
    """1 - Pearson correlation."""
    return float(1.0 - np.corrcoef(np.asarray(a, np.float64), np.asarray(b, np.float64))[0, 1])


def gblup_f64(G_raw, y, lam: float, ploidy: int = 2):
    """GEBV = K α + mean(y), (K + λI) α = y - mean(y), with K the double-
    centered raw dosage Gram / ploidy² — the f64 version of
    gram_dosage_lower → gblup_solve_lower."""
    K = np.asarray(G_raw, np.float64) / float(ploidy * ploidy)
    rm = K.mean(axis=1)
    K = K - rm[:, None] - rm[None, :] + rm.mean()
    y = np.asarray(y, np.float64)
    yc = y - y.mean()
    alpha = np.linalg.solve(K + lam * np.eye(len(y)), yc)
    return yc - lam * alpha + y.mean()


def ols_t_f64(G, y, Q):
    """Per-marker t = b_g / sqrt([(XᵀX)⁻¹]_gg) for X = [Q, g_j] (the
    reference's pinv(XᵀX) statistic, src/gwas.jl:241-245), all markers at
    once through the Schur complement."""
    G = np.asarray(G, np.float64)
    y = np.asarray(y, np.float64)
    Q = np.asarray(Q, np.float64)
    QtQi = np.linalg.inv(Q.T @ Q)
    QtG = Q.T @ G
    Qty = Q.T @ y
    schur = np.einsum("ij,ij->j", G, G) - np.einsum("ij,ik,kj->j", QtG, QtQi, QtG)
    num = G.T @ y - QtG.T @ (QtQi @ Qty)
    vinv = 1.0 / np.maximum(schur, 1e-30)
    return num * vinv / np.sqrt(vinv)


def reml_nll_eig(theta, yr, Xr, s):
    """The reference REML objective 0.5·log|V| + yᵀPy + log|XᵀV⁻¹X| with
    V = θ₁K + θ₀I evaluated in K's eigenbasis (yr = Uᵀy, Xr = UᵀX)."""
    d = theta[1] * s + theta[0]
    if np.any(d <= 0):
        return np.inf
    Xd = Xr / d[:, None]
    XtVX = Xr.T @ Xd
    sign, logdet_x = np.linalg.slogdet(XtVX)
    if sign <= 0:
        return np.inf
    XtVy = Xd.T @ yr
    sol = np.linalg.solve(XtVX, XtVy)
    yPy = yr @ (yr / d) - XtVy @ sol
    return 0.5 * np.sum(np.log(d)) + yPy + logdet_x


def reml_fit_eig(yr, Xr, s, grid_pts=12):
    """θ = (σ²ₑ, σ²ᵤ) by the parity oracle's log-grid + pattern search."""
    from genomicbreedingmodels_tpu.parity import _pattern_search_2d

    lg = np.linspace(-5.0, 0.0, grid_pts)
    cand = [(10.0 ** a, 10.0 ** b) for a in lg for b in lg]
    vals = [reml_nll_eig(np.asarray(th), yr, Xr, s) for th in cand]
    x0 = np.log10(np.asarray(cand[int(np.argmin(vals))]))
    xo = _pattern_search_2d(lambda x: reml_nll_eig(10.0 ** x, yr, Xr, s), x0)
    return 10.0 ** xo


def gls_z_eig(theta, yr, Xr, s):
    """GLS z of the last column of X at V = θ₁K + θ₀I (eigenbasis)."""
    d = theta[1] * s + theta[0]
    Xd = Xr / d[:, None]
    cov = np.linalg.inv(Xr.T @ Xd)
    b = cov @ (Xd.T @ yr)
    return b[-1] / np.sqrt(max(cov[-1, -1], 1e-30))


def ridge_fold_f64(K, y, w, reg):
    """Dual ridge/GBLUP fold: γ = (K_ww + reg·I)⁻¹ (y_w − ȳ_w), pred =
    ȳ_w + K[:, w] γ — the f64 refit of one cv/batched.py fold."""
    tr = np.flatnonzero(w > 0)
    K = np.asarray(K, np.float64)
    y = np.asarray(y, np.float64)
    mean_y = y[tr].mean()
    gamma = np.linalg.solve(K[np.ix_(tr, tr)] + reg * np.eye(len(tr)), y[tr] - mean_y)
    return mean_y + K[:, tr] @ gamma


def ridge_gcv_f64(K, y, w, lambdas):
    """The training-only GCV curve of one ridge fold in f64, the criterion
    cv/batched.py:_fold_solve minimizes: MSE_train / max((1 − edf/n_w)², 1e-6)
    with the training residual λ·n_w·γ."""
    tr = np.flatnonzero(w > 0)
    n_w = len(tr)
    K = np.asarray(K, np.float64)
    y = np.asarray(y, np.float64)
    s, U = np.linalg.eigh(K[np.ix_(tr, tr)])
    s = np.maximum(s, 0.0)
    Uty = U.T @ (y[tr] - y[tr].mean())
    out = []
    for lam in np.asarray(lambdas, np.float64):
        d = s + lam * n_w
        res = lam * n_w * (U @ (Uty / d))
        edf = np.sum(s / d)
        out.append((res @ res / n_w) / max((1.0 - edf / n_w) ** 2, 1e-6))
    return np.asarray(out)


def lasso_fold_f64(X, y, w, lam, n_iter=300):
    """f64 FISTA on (1/2n_w)‖w(y_c − Z b)‖² + λ‖b‖₁ with the training-row
    centering of cv/batched.py:_lasso_fold; returns the full-panel
    prediction."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    tr = np.flatnonzero(w > 0)
    mean_y = y[tr].mean()
    mean_x = X[tr].mean(axis=0)
    Zt = X[tr] - mean_x
    yc = y[tr] - mean_y
    n_tr = len(tr)
    step = 1.0 / max(np.linalg.eigvalsh(Zt @ Zt.T)[-1] / n_tr, 1e-12)
    b = v = np.zeros(X.shape[1])
    tk = 1.0
    for _ in range(n_iter):
        grad = Zt.T @ (Zt @ v - yc) / n_tr
        z = v - step * grad
        b_new = np.sign(z) * np.maximum(np.abs(z) - step * lam, 0.0)
        tk_new = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * tk * tk))
        v = b_new + ((tk - 1.0) / tk_new) * (b_new - b)
        b, tk = b_new, tk_new
    return mean_y + (X - mean_x) @ b


# ---------------------------------------------------------------------------
# device, contract line
# ---------------------------------------------------------------------------


def nvidia_smi_line() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return (r.stdout or r.stderr).strip().splitlines()[0] if (r.stdout or r.stderr) else "n/a"
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi unavailable: {err}"


def contract_line(devices) -> str:
    d0 = devices[0]
    return json.dumps({
        "ok": True,
        "device": {"platform": d0.platform, "kind": d0.device_kind, "count": len(devices)},
    })


def _sync(x):
    import jax

    return jax.block_until_ready(x)


def _timed(fn, *args, reps=1):
    """(result, best wall seconds of `reps` warm calls); compiles first."""
    out = _sync(fn(*args))
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        out = _sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return out, best


def _dot_kernels(hlo_text: str) -> str:
    """Names of the GEMM implementations in a compiled GPU HLO module."""
    import re

    found = set(re.findall(r'custom_call_target="([^"]+)"', hlo_text))
    if '"kind":"__triton_gemm"' in hlo_text or "__triton_gemm" in hlo_text:
        found.add("__triton_gemm (XLA Triton GEMM fusion)")
    if "__cutlass" in hlo_text:
        found.add("cutlass")
    gemmish = sorted(f for f in found if any(t in f.lower() for t in ("gemm", "matmul", "blas", "cutlass", "triton")))
    return ",".join(gemmish) or "no GEMM custom call (loop/input fusion)"


# ---------------------------------------------------------------------------
# phase 1: flagship GRM + GBLUP
# ---------------------------------------------------------------------------


def phase_flagship(rep: Report, n=8192, p=262_144, lam=None, slab=256):
    import jax
    import jax.numpy as jnp

    from genomicbreedingmodels_tpu.ops.chol import gblup_solve_lower
    from genomicbreedingmodels_tpu.ops.grm import _gram_panel_int8_lower, gram_dosage_lower

    # λ = E[diag K] (uniform {0,1,2} dosages: variance 2/3 per marker, / ploidy²),
    # the h² = 0.5 ratio: the shrinkage λα is half of y_c, so the GEBV moves
    # with the solve.
    lam = p / 6.0 if lam is None else lam
    kx, ky = jax.random.split(jax.random.PRNGKey(0))
    D = _sync(jax.random.randint(kx, (n, p), 0, 3, dtype=jnp.int8))
    y = jax.random.normal(ky, (n,), dtype=jnp.float32)
    nb = max(1, min(16, n // 512))

    @jax.jit
    def fused_step(D, y):
        return gblup_solve_lower(gram_dosage_lower(D, ploidy=2), y, jnp.float32(lam))

    t0 = time.perf_counter()
    compiled = fused_step.lower(D, y).compile()
    t_compile = time.perf_counter() - t0
    gebv, dt = _timed(compiled, D, y, reps=3)
    rep.info("1.grm+gblup", f"s8xs8->s32 dot lowered to: {_dot_kernels(compiled.as_text())}")

    # Raw int32 Gram, last `slab` rows (full lower-triangle extent), against
    # an independent f32 dot at HIGHEST: every partial sum is an integer
    # below 2^24, so the reference is exact.
    G_low = _sync(jax.jit(lambda A: _gram_panel_int8_lower(A, nb))(D))
    t0 = time.perf_counter()
    r0 = n - slab
    ref = jnp.dot(D[r0:].astype(jnp.float32), D.astype(jnp.float32).T,
                  precision=jax.lax.Precision.HIGHEST)
    ref = jnp.where(jnp.arange(n)[None, :] <= jnp.arange(r0, n)[:, None], ref, 0.0)
    mism = int(_sync(jnp.sum(G_low[r0:].astype(jnp.float32) != ref)))
    rep.line("1.grm-int32-exact", f"rows[{r0}:{n}]x{n} of {n}x{p} int8",
             time.perf_counter() - t0, float(mism), 0.0, EXACT_PREC,
             "err=count of unequal entries")

    G_full = np.asarray(G_low, np.int64)
    G_full = G_full + np.tril(G_full, -1).T
    t0 = time.perf_counter()
    g64 = gblup_f64(G_full, np.asarray(y), lam)
    t_ref = time.perf_counter() - t0
    gebv = np.asarray(gebv, np.float64)
    yc = np.asarray(y, np.float64) - float(np.mean(np.asarray(y, np.float64)))
    # Tolerance 1e-4 of the largest GEBV: far below any difference a ranking
    # of candidates can see, and well above the f32 floor of this solve
    # (cond(K + λI) ≈ 2.4; ~4e-6 at full f32, ~3e-5 in TF32 on an H100).
    rep.line("1.grm+gblup", f"{n}x{p} int8 lambda={lam:.6g}", dt, rel_err(gebv, g64), 1e-4,
             f"{EXACT_PREC}+solve:{DEFAULT_PREC}",
             f"compile_s={t_compile:.1f} host_f64_solve_s={t_ref:.1f} "
             f"SNPs/s={n * p / dt:.4e} err=max|gebv-f64|/max|f64| "
             f"shrinkage |λα|/|y_c|={np.linalg.norm(yc - (g64 - g64.mean())) / np.linalg.norm(yc):.3f}")


# ---------------------------------------------------------------------------
# phase 2: Bayesian samplers
# ---------------------------------------------------------------------------


def synth_panel(n, p, seed):
    """Device-synthesized dosage/2 panel with a 1%-causal h²≈0.5 trait (the
    synthesis of bench.py's at-size sampler section)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def synth(key):
        kx, kb, ke = jax.random.split(key, 3)
        X = jax.random.randint(kx, (n, p), 0, 3, dtype=jnp.int8).astype(jnp.float32) * 0.5
        beta = jax.random.normal(kb, (p,), dtype=jnp.float32) * (
            jax.random.uniform(jax.random.fold_in(kb, 1), (p,)) < 0.01
        )
        g = jnp.dot(X, beta, precision=jax.lax.Precision.HIGHEST)
        y = g + jax.random.normal(ke, (n,), dtype=jnp.float32) * jnp.std(g)
        return X, y

    X, y = synth(jax.random.key(seed, impl="rbg"))
    return _sync(X), np.asarray(y)


def block_inputs(X, y, bs, K, seed=0):
    """One real block's inputs for the grouped update: centered columns of
    X, u = X_bᵀ(y - ȳ), a sparse current effect vector, the last 3 markers
    invalid (padding), and the sweep tables."""
    import jax
    import jax.numpy as jnp

    from genomicbreedingmodels_tpu.ops.pallas_gibbs import build_group_tables, group_patterns

    hi = jax.lax.Precision.HIGHEST
    Xb = X[:, :bs] - jnp.mean(X[:, :bs], axis=0)
    Cb = jnp.dot(Xb.T, Xb, precision=hi)
    r = jnp.asarray(y - y.mean(), jnp.float32)
    rng = np.random.default_rng(seed)
    val = np.ones(bs, np.float32)
    val[-3:] = 0.0
    u = jnp.dot(Xb.T, r, precision=hi) * jnp.asarray(val)
    b = jnp.asarray((rng.normal(size=bs) * 0.02 * (rng.random(bs) < 0.3) * val).astype(np.float32))
    s2 = jnp.full((bs,), 4e-4, jnp.float32)
    sig_e2 = jnp.float32(np.var(y) * 0.5)
    G = bs // K
    W, const = build_group_tables(Cb[None], s2, jnp.asarray(val), sig_e2,
                                  jnp.float32(0.2), group_patterns(K))
    gum = -np.log(-np.log(rng.uniform(1e-12, 1 - 1e-7, size=(G, 1 << K))))
    eta = jnp.asarray(rng.normal(size=bs).astype(np.float32))
    return (Cb, u, b, jnp.asarray(val), eta, W[0], const[0] + jnp.asarray(gum, jnp.float32),
            sig_e2, group_patterns(K))


def phase_block_kernel(rep: Report, X, y, bs=600, K=6, tag="2.block-kernel"):
    import jax

    from genomicbreedingmodels_tpu.ops.pallas_gibbs import (
        grouped_block_reference,
        grouped_block_update,
    )

    args = block_inputs(X, y, bs, K)
    *kargs, pats = args
    kern = jax.jit(grouped_block_update)
    ref = jax.jit(lambda *a: grouped_block_reference(*a, pats))
    (dk, bk, ik), t_k = _timed(kern, *kargs, reps=20)
    (dr, br, ir), t_r = _timed(ref, *kargs, reps=20)
    mism = int(np.sum(np.asarray(ik) != np.asarray(ir)))
    rep.line(tag + "-patterns", f"bs={bs} K={K}", t_k, float(mism), 0.0, "f32",
             "err=markers whose inclusion differs")
    rep.line(tag + "-draws", f"bs={bs} K={K}", t_k, rel_err(bk, br), 1e-4, "f32",
             f"kernel_s/block={t_k:.3e} xla_scan_s/block={t_r:.3e}")
    return t_k, t_r


def phase_sampler(rep: Report, n=10_000, p=102_000, bs=600, sweeps=20, burn=5):
    from genomicbreedingmodels_tpu.models.bayesian import gibbs_regression

    X, y = synth_panel(n, p, 11)
    expect = float(np.var(y)) * 0.5  # var(y)·(1 − h²), h² = 0.5 by construction
    for model in ("BayesC", "BRR"):
        kw = dict(model=model, n_iter=sweeps, n_burnin=burn, seed=4, block_size=bs)
        t0 = time.perf_counter()
        gibbs_regression(X, y, **kw)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        mu, b, diag = gibbs_regression(X, y, **kw)
        dt = time.perf_counter() - t0
        s2 = float(np.mean(diag["sigma_e2_trace"][burn:]))
        ratio = s2 / expect
        finite = bool(np.all(np.isfinite(b))) and np.isfinite(mu)
        # err = distance of σ²ₑ/expected outside the band [0.25, 2.0]
        err = 0.0 if (finite and 0.25 <= ratio <= 2.0) else float("inf")
        rep.line(f"2.sampler-{model}", f"{n}x{p} bs={bs} {sweeps} sweeps", dt, err, 0.0,
                 DEFAULT_PREC, f"first_call_s={t_first:.1f} sigma_e2/expected={ratio:.3f} "
                 f"(band 0.25-2.0) effects_finite={finite} "
                 f"updates/s={sweeps * p / dt:.4e}")
    phase_block_kernel(rep, X, y, bs=bs, K=6)
    del X


def signal_panel(n, p, seed=7):
    rng = np.random.default_rng(seed)
    X = (rng.integers(0, 3, size=(n, p)) / 2.0).astype(np.float32)
    beta = rng.normal(size=p) * (rng.uniform(size=p) < 0.01)
    g = X @ beta
    y = (g + rng.normal(size=n) * max(g.std(), 1e-3)).astype(np.float32)
    return X, y


def phase_chains(rep: Report, n=2048, p=32_768, sweeps=300, burn=100,
                 modes=("pallas", "grouped", "scalar")):
    from genomicbreedingmodels_tpu.models.bayesian import gibbs_regression

    X, y = signal_panel(n, p)
    out = {}
    for mode in modes:
        t0 = time.perf_counter()
        mu, b, diag = gibbs_regression(X, y, model="BayesC", n_iter=sweeps, n_burnin=burn,
                                       seed=1, indicator_update=mode)
        out[mode] = (X @ b, float(np.mean(diag["sigma_e2_trace"][burn:])),
                     time.perf_counter() - t0)
        rep.info("2.chains", f"{mode}: {sweeps} sweeps in {out[mode][2]:.1f}s (incl. compile) "
                 f"sigma_e2={out[mode][1]:.4f}")
    base = modes[0]
    for other in modes[1:]:
        g0, s0, t0_ = out[base]
        g1, s1, t1_ = out[other]
        rep.line(f"2.chains-{base}-vs-{other}-gebv", f"{n}x{p} {sweeps} sweeps", t0_ + t1_,
                 cor_err(g0, g1), 0.01, DEFAULT_PREC, "err=1-cor(GEBV)")
        rep.line(f"2.chains-{base}-vs-{other}-sigma_e2", f"{n}x{p} {sweeps} sweeps",
                 t0_ + t1_, abs(s0 - s1) / s1, 0.25, DEFAULT_PREC, "err=|Δσ²ₑ|/σ²ₑ")


def fold_masks(n, folds):
    masks = np.ones((folds, n), np.float32)
    for f in range(folds):
        masks[f, f::folds] = 0.0
    return masks


def phase_cv_chains(rep: Report, n=2048, p=32_768, folds=4, sweeps=100, burn=30):
    """Fold-batched BayesC chains (gibbs_cv_folds): "auto" on the GPU runs the
    block kernel with one program per fold; the XLA grouped scan is its
    reference (same draws)."""
    import dataclasses

    from genomicbreedingmodels_tpu.models.bayesian import _block_kernel_on, gibbs_cv_folds
    from genomicbreedingmodels_tpu.utils.config import get_config, set_config

    X, y = signal_panel(n, p)
    masks = fold_masks(n, folds)
    cfg0 = get_config()
    rep.info("2.cv-chains", "auto picks the kernel: "
             f"{_block_kernel_on('auto', True, cfg0.mcmc_group_size, p, batch=folds)}")
    out = {}
    kw = dict(model="BayesC", n_iter=sweeps, n_burnin=burn, seed=2)
    try:
        for mode in ("auto", "grouped"):
            set_config(dataclasses.replace(cfg0, mcmc_indicator_update=mode))
            gibbs_cv_folds(X, y, masks, **kw)  # compile
            t0 = time.perf_counter()
            mus, betas = gibbs_cv_folds(X, y, masks, **kw)
            out[mode] = (mus[:, None] + betas @ X.T.astype(np.float64), time.perf_counter() - t0)
    finally:
        set_config(cfg0)
    err = max(cor_err(a, b) for a, b in zip(out["auto"][0], out["grouped"][0]))
    rep.line("2.cv-chains-kernel-vs-grouped-gebv", f"{folds} folds x {n}x{p} {sweeps} sweeps",
             out["auto"][1], err, 0.01, DEFAULT_PREC,
             f"kernel_s={out['auto'][1]:.3f} xla_scan_s={out['grouped'][1]:.3f} "
             "err=max over folds of 1-cor(GEBV)")


# ---------------------------------------------------------------------------
# phase 3: GWAS and CV through the public API
# ---------------------------------------------------------------------------


def gwas_inputs(n, p, seed=3):
    import genomicbreedingmodels_tpu as gbm

    rng = np.random.default_rng(seed)
    freq = rng.integers(0, 3, size=(n, p)).astype(np.float64) / 2.0
    y = freq[:, :20] @ rng.normal(size=20) + rng.normal(size=n) * 2.0
    genomes = gbm.Genomes(
        entries=np.array([f"e{i:05d}" for i in range(n)]),
        populations=np.array(["pop_1"] * n),
        loci_alleles=np.array([f"chr1\t{i}\tA|T\tA" for i in range(p)]),
        allele_frequencies=freq,
    )
    phenomes = gbm.Phenomes(entries=genomes.entries, populations=genomes.populations,
                            traits=np.array(["t"]), phenotypes=y[:, None])
    return genomes, phenomes


def phase_gwas(rep: Report, n=2048, p=32_768):
    import genomicbreedingmodels_tpu as gbm
    from genomicbreedingmodels_tpu.parity import _pc1_oracle

    genomes, phenomes = gwas_inputs(n, p)
    G, yv, K, _ = gbm.gwasprep(genomes, phenomes)
    G, yv, K = (np.asarray(a, np.float64) for a in (G, yv, K))
    Ksym = 0.5 * (K + K.T)
    s, U = np.linalg.eigh(Ksym)
    pc1 = _pc1_oracle(K)
    yr = U.T @ yv
    ones = np.ones(len(yv))

    fits = {}
    for name, fn in (("gwasols", gbm.gwasols), ("gwaslmm", gbm.gwaslmm),
                     ("gwasreml", gbm.gwasreml)):
        fn(genomes=genomes, phenomes=phenomes)
        t0 = time.perf_counter()
        fits[name] = fn(genomes=genomes, phenomes=phenomes)
        fits[name + "_s"] = time.perf_counter() - t0

    t_ols = ols_t_f64(G, yv, np.stack([ones, pc1], axis=1))
    rep.line("3.gwasols", f"{n}x{p}", fits["gwasols_s"],
             cor_err(fits["gwasols"].b_hat, t_ols), 1e-3, DEFAULT_PREC,
             "err=1-cor(t) over all markers vs f64 per-marker pinv t")

    X0r = U.T @ np.stack([ones, pc1], axis=1)
    th = reml_fit_eig(yr, X0r, s)
    z_lib = np.asarray(fits["gwaslmm"].b_hat, np.float64)
    top = np.argsort(-np.abs(z_lib))[:12]
    z_o = [gls_z_eig(th, yr, np.concatenate([X0r, (U.T @ G[:, j])[:, None]], axis=1), s)
           for j in top]
    rep.line("3.gwaslmm", f"{n}x{p}", fits["gwaslmm_s"], cor_err(z_lib[top], z_o), 1e-3,
             DEFAULT_PREC, "err=1-cor(z) top-12 vs f64 GLS at f64-refit null components")

    z_lib = np.asarray(fits["gwasreml"].b_hat, np.float64)
    top = np.argsort(-np.abs(z_lib))[:12]
    z_o = []
    for j in top:
        Xr = U.T @ np.stack([ones, G[:, j]], axis=1)
        z_o.append(gls_z_eig(reml_fit_eig(yr, Xr, s, grid_pts=14), yr, Xr, s))
    rep.line("3.gwasreml", f"{n}x{p}", fits["gwasreml_s"], cor_err(z_lib[top], z_o), 1e-3,
             DEFAULT_PREC, "err=1-cor(z) top-12 vs f64 per-marker REML (grid + pattern search)")


def phase_cv(rep: Report, n=2048, p=32_768):
    import genomicbreedingmodels_tpu as gbm
    from genomicbreedingmodels_tpu.cv.batched import cvbulk_batched

    rng = np.random.default_rng(11)
    freq = rng.uniform(size=(n, p)).astype(np.float32)
    beta = rng.normal(size=p) * (rng.uniform(size=p) < 0.01)
    yy = freq @ beta
    yy = yy + rng.normal(size=n) * yy.std()
    genomes = gbm.Genomes(
        entries=np.array([f"e{i:05d}" for i in range(n)]),
        populations=np.array(["pop_1"] * n),
        loci_alleles=np.array([f"chr1\t{i}\tA|T\tA" for i in range(p)]),
        allele_frequencies=freq,
    )
    phenomes = gbm.Phenomes(entries=genomes.entries, populations=genomes.populations,
                            traits=np.array(["t"]), phenotypes=yy[:, None])
    kw = dict(models=("ridge", "gblup", "lasso"), n_replications=1, n_folds=5,
              store_effects=False, seed=42)
    cvbulk_batched(genomes, phenomes, **kw)
    t0 = time.perf_counter()
    cvs, _ = cvbulk_batched(genomes, phenomes, **kw)
    dt = time.perf_counter() - t0
    # The training masks, rebuilt with the engine's own fold RNG.
    labels = np.random.default_rng(42).integers(1, 6, size=n)
    w = (labels != 1).astype(np.float64)
    val = np.flatnonzero(labels == 1)
    X64 = freq.astype(np.float64)
    Z = X64 - X64.mean(axis=0)
    K = Z @ Z.T
    # Ridge's λ, every fold: the engine's GCV choice against the f64 GCV's.
    grid = np.logspace(-4, 1, 12)
    misses, gaps = [], []
    for j in range(1, 6):
        cv = next(c for c in cvs if c.fit.model == "ridge" and c.fold == f"fold_{j}")
        gcv = ridge_gcv_f64(K, yy, (labels != j).astype(np.float64), grid)
        lam = float(cv.fit.extras["lambda"])
        pick = int(np.argmin(np.abs(grid - lam)))
        gaps.append(gcv[pick] / gcv.min() - 1.0)
        if pick != int(np.argmin(gcv)):
            misses.append(f"fold_{j}: {lam:.4g} vs {grid[np.argmin(gcv)]:.4g}")
    rep.line("3.cv-ridge-lambda", f"{n}x{p} 1x5 folds", dt, float(len(misses)), 0.0,
             f"gram:{DEFAULT_PREC}+fold solve:{HIGHEST_PREC}",
             f"err=folds whose GCV λ differs from the f64 GCV's {misses} "
             f"f64 GCV excess of the engine's picks={max(gaps):.3e}")
    for model in ("ridge", "gblup", "lasso"):
        cv = next(c for c in cvs if c.fit.model == model and c.fold == "fold_1")
        lam = float(cv.fit.extras["lambda"])
        if model == "ridge":
            pred = ridge_fold_f64(K, yy, w, lam * w.sum())
        elif model == "gblup":
            pred = ridge_fold_f64(K, yy, w, lam)
        else:
            pred = lasso_fold_f64(freq, yy, w, lam)
        cor_dev = float(cv.metrics["cor"])
        cor_ref = float(np.corrcoef(yy[val], pred[val])[0, 1])
        tol = 2e-2 if model == "lasso" else 1e-3
        prec = DEFAULT_PREC if model == "lasso" else f"gram:{DEFAULT_PREC}+fold solve:{HIGHEST_PREC}"
        rep.line(f"3.cv-{model}", f"{n}x{p} 1x5 folds", dt, abs(cor_dev - cor_ref), tol,
                 prec, f"err=|Δ validation cor| fold_1 vs f64 refit at the "
                 f"engine's λ={lam:.4g} (cor={cor_dev:.4f})")


# ---------------------------------------------------------------------------
# phase 4: parity ledger on the card
# ---------------------------------------------------------------------------


def phase_parity(rep: Report):
    from genomicbreedingmodels_tpu.parity import run_parity_ledger

    t0 = time.perf_counter()
    rows = run_parity_ledger(emit=lambda s: None)
    dt = time.perf_counter() - t0
    for r in rows:
        rep.line(f"4.parity-{r['model']}", "parity sizes", dt, r["threshold"] - r["value"],
                 0.0, DEFAULT_PREC, f"{r['quantity']}={r['value']:.6f} "
                 f"(threshold {r['threshold']})")


# ---------------------------------------------------------------------------
# --multi: mesh paths on 4 cards
# ---------------------------------------------------------------------------


MULTI_SIZES = dict(grm=(8192, 262_144), cg=(8192, 65_536), cv=(1024, 16_384),
                   gwas=(2048, 32_768), gibbs=(2048, 32_768, 300, 100),
                   cv_chains=(1024, 16_384, 4, 100, 30), pairs=(512, 4096, 256))


def phase_multi(rep: Report, sizes=MULTI_SIZES, only=None):
    """Each mesh path against the same computation on one card (or, for
    CG, the dense f64 solve). Only the partitioning differs, so a lost or
    double-counted shard moves results by O(1); the tolerances allow the
    GEMMs of other shard shapes to round and sum in another order (TF32
    operands: 2^-11 per product)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import genomicbreedingmodels_tpu as gbm
    from genomicbreedingmodels_tpu.cv.batched import cvbulk_batched
    from genomicbreedingmodels_tpu.models.bayesian import gibbs_cv_folds, gibbs_regression
    from genomicbreedingmodels_tpu.ops.grm import gram_dosage
    from genomicbreedingmodels_tpu.parallel.mesh import make_mesh
    from genomicbreedingmodels_tpu.parallel.sharded import (
        multitrait_gblup_step,
        sharded_gblup_cg,
        sharded_gibbs_regression,
        sharded_grm,
        sharded_ridge_step,
    )

    devs = jax.devices()
    mesh = make_mesh(shape=(1, len(devs)))
    mesh22 = make_mesh(shape=(2, len(devs) // 2))
    one = make_mesh(shape=(1, 1))  # the single-card program
    used = {d.id for d in mesh.devices.flat}
    rep.line("M.mesh", f"{mesh.shape}", 0.0, float(len(devs) - len(used)), 0.0, "n/a",
             f"devices in mesh={sorted(used)}")

    def _m_grm(_rep):
        # Sharded GRM, 8192 x 262144 int8, vs the single-card gram_dosage.
        n, p = sizes["grm"]
        D = _sync(jax.random.randint(jax.random.PRNGKey(0), (n, p), 0, 3, dtype=jnp.int8))
        Ds = jax.device_put(D, NamedSharding(mesh, P(None, "mp")))
        shard_devs = {s.device.id for s in Ds.addressable_shards}
        K_sh, t_sh = _timed(lambda A: sharded_grm(A, mesh), Ds, reps=3)
        K_1, t_1 = _timed(lambda A: gram_dosage(A, ploidy=2), D, reps=3)
        rep.line("M.sharded-grm", f"{n}x{p} int8 over {len(shard_devs)} devices", t_sh,
                 float(np.max(np.abs(np.asarray(K_sh) - np.asarray(K_1)))), 0.0,
                 EXACT_PREC, f"single_card_s={t_1:.4f} err=max|Δ|")
        del D, Ds, K_sh, K_1

    def _m_cg_ridge_multitrait(_rep):
        # Matrix-free CG GBLUP vs the dense f64 solve of the same system.
        n, p = sizes["cg"]
        X, y = synth_panel(n, p, 5)
        Xh = np.asarray(X)
        lam = 0.5
        t0 = time.perf_counter()
        alpha, gebv = sharded_gblup_cg(Xh, y, lam, mesh, n_iter=400, tol=1e-7)
        gebv = np.asarray(gebv)
        dt = time.perf_counter() - t0
        Z = Xh.astype(np.float64) - Xh.mean(axis=0)
        Kd = Z @ Z.T / p
        yc = y.astype(np.float64) - y.mean()
        g_ref = Kd @ np.linalg.solve(Kd + lam * np.eye(n), yc) + y.mean()
        rep.line("M.sharded-cg", f"{n}x{p} over {len(devs)} devices", dt, rel_err(gebv, g_ref), 1e-3,
                 DEFAULT_PREC, "err=max|gebv-f64 dense|/max|f64|")

        # Marker-sharded RR-BLUP step, same panel, vs the same program on one card.
        Xs = jax.device_put(X, NamedSharding(mesh, P(None, "mp")))
        X1 = jax.device_put(X, devs[0])
        lam_r = 1.0  # n·λ = n, against diag(Z Zᵀ) ≈ p/6
        (b0_m, beta_m), t_m = _timed(lambda A: sharded_ridge_step(A, y, lam_r, mesh), Xs)
        (b0_1, beta_1), t_1 = _timed(lambda A: sharded_ridge_step(A, y, lam_r, one), X1)
        err = max(rel_err(beta_m, beta_1), abs(float(b0_m) - float(b0_1)) / max(abs(float(b0_1)), 1e-30))
        rep.line("M.sharded-ridge", f"{n}x{p} over {len(devs)} devices", t_m, err, 1e-3,
                 DEFAULT_PREC, f"single_card_s={t_1:.4f} err=max(rel |Δβ|, rel |Δb0|) vs one card")

        # Multi-trait GBLUP on the (dp, mp) = (2, 2) mesh: traits over dp, markers over mp.
        rng = np.random.default_rng(21)
        Y = (y[None, :] + rng.normal(size=(4, n)) * y.std()).astype(np.float32)
        Xs22 = jax.device_put(X, NamedSharding(mesh22, P(None, "mp")))
        g_m, t_m = _timed(lambda A: multitrait_gblup_step(A, Y, lam, mesh22), Xs22)
        g_1, t_1 = _timed(lambda A: multitrait_gblup_step(A, Y, lam, one), X1)
        Yc = Y.astype(np.float64) - Y.mean(axis=1, keepdims=True)
        g_64 = (Kd @ np.linalg.solve(Kd + lam * np.eye(n), Yc.T)).T + Y.mean(axis=1, keepdims=True)
        rep.line("M.multitrait-gblup", f"4 traits x {n}x{p} over mesh {dict(mesh22.shape)}", t_m,
                 rel_err(g_m, g_1), 1e-3, DEFAULT_PREC,
                 f"single_card_s={t_1:.4f} err=max rel |ΔGEBV| vs one card "
                 f"(vs f64: mesh {rel_err(g_m, g_64):.3e}, one card {rel_err(g_1, g_64):.3e})")
        del X, Xs, X1, Xs22, Z, Kd

    def _m_gwasreml(_rep):
        # Marker-sharded per-marker REML scan (gbm.gwasreml with a mesh runs
        # parallel/sharded.py:sharded_gwasreml) vs the single-card scan.
        n, p = sizes["gwas"]
        genomes, phenomes = gwas_inputs(n, p)
        gbm.gwasreml(genomes=genomes, phenomes=phenomes, mesh=mesh)
        t0 = time.perf_counter()
        z_m = gbm.gwasreml(genomes=genomes, phenomes=phenomes, mesh=mesh).b_hat
        dt = time.perf_counter() - t0
        z_1 = gbm.gwasreml(genomes=genomes, phenomes=phenomes).b_hat
        # 1-cor over all markers: rounding moves it ~1e-10, a lost shard ~0.25.
        rep.line("M.sharded-gwasreml", f"{n}x{p} over {len(devs)} devices", dt, cor_err(z_m, z_1),
                 1e-6, DEFAULT_PREC, f"err=1-cor(z) vs one card, max|Δz|/max|z|="
                 f"{rel_err(z_m, z_1):.3e}")

    def _m_cv(_rep):
        # Fold-sharded CV vs the same folds on one card: the same λ in every fold
        # and the same predictions (bf16-bulk FISTA iterates are not bit-stable
        # across program partitionings, hence a tolerance rather than equality).
        genomes, phenomes = gwas_inputs(*sizes["cv"], seed=9)
        kw = dict(models=("ridge", "gblup", "lasso"), n_replications=1, n_folds=4,
                  store_effects=False)
        t0 = time.perf_counter()
        cv_m, _ = cvbulk_batched(genomes, phenomes, mesh=mesh, **kw)
        dt = time.perf_counter() - t0
        cv_1, _ = cvbulk_batched(genomes, phenomes, **kw)
        assert len(cv_m) == len(cv_1)
        per_model, flips = {}, []
        for a, b in zip(cv_m, cv_1):
            assert (a.fit.model, a.replication, a.fold) == (b.fit.model, b.replication, b.fold)
            la, lb = a.fit.extras["lambda"], b.fit.extras["lambda"]
            if la != lb:
                flips.append(f"{a.fit.model}/{a.fold}: {la:.4g} vs {lb:.4g}")
            d = rel_err(a.y_pred, b.y_pred)
            per_model[a.fit.model] = max(per_model.get(a.fit.model, 0.0), d)
        rep.line("M.sharded-cv", "{}x{} 1x4 folds x 3 models".format(*sizes["cv"]), dt,
                 float("inf") if flips else max(per_model.values()), 2e-3,
                 f"fold solve:{HIGHEST_PREC}",
                 "err=max rel |Δ validation prediction| mesh vs single device "
                 f"{ {m: float(f'{v:.3e}') for m, v in per_model.items()} } "
                 f"(inf if a fold's λ differs: {flips})")

    def _m_bayes_cv(_rep):
        # Fold-sharded Bayesian CV chains (block kernel on the GPU) vs one card.
        cn, cp, folds, sweeps, burn = sizes["cv_chains"]
        Xc, yc_ = signal_panel(cn, cp, seed=8)
        masks = fold_masks(cn, folds)
        kw = dict(model="BayesC", n_iter=sweeps, n_burnin=burn, seed=2)
        t0 = time.perf_counter()
        mus_m, b_m = gibbs_cv_folds(Xc, yc_, masks, mesh=mesh, **kw)
        dt = time.perf_counter() - t0
        mus_1, b_1 = gibbs_cv_folds(Xc, yc_, masks, **kw)
        err = max(cor_err(Xc @ bm, Xc @ b1) for bm, b1 in zip(b_m, b_1))
        rep.line("M.sharded-bayes-cv", f"{folds} folds x {cn}x{cp} {sweeps} sweeps over "
                 f"{len(devs)} devices", dt, err, 0.01, DEFAULT_PREC,
                 "err=max over folds of 1-cor(GEBV) vs one card")

    def _m_bayesc(_rep):
        # Marker-sharded BayesC vs the single-card chain (phase-2 agreement bounds).
        gn, gp, sweeps, burn = sizes["gibbs"]
        Xs, ys = signal_panel(gn, gp)
        t0 = time.perf_counter()
        mu_s, b_s = sharded_gibbs_regression(Xs, ys, mesh, axis="mp", model="BayesC",
                                             n_iter=sweeps, n_burnin=burn, block_size=256, seed=1)
        dt = time.perf_counter() - t0
        mu_1, b_1, _ = gibbs_regression(Xs, ys, model="BayesC", n_iter=sweeps, n_burnin=burn,
                                        seed=1)
        rep.line("M.sharded-bayesc", f"{gn}x{gp} {sweeps} sweeps over {len(devs)} devices", dt,
                 cor_err(Xs @ b_s, Xs @ b_1), 0.01, DEFAULT_PREC, "err=1-cor(GEBV) vs single-card chain")

    def _m_pairs(_rep):
        # Meshed epistasis pair scan vs the single-card scan.
        from genomicbreedingmodels_tpu.features.endofunctions import mult
        from genomicbreedingmodels_tpu.features.transform import transform2

        pn, pl_, k = sizes["pairs"]
        g2, ph2 = gwas_inputs(pn, pl_, seed=13)
        t0 = time.perf_counter()
        out_m = transform2(mult, g2, ph2, n_new_features_per_transformation=k, mesh=mesh)
        dt = time.perf_counter() - t0
        out_1 = transform2(mult, g2, ph2, n_new_features_per_transformation=k)
        same = set(out_m.loci_alleles.tolist()) == set(out_1.loci_alleles.tolist())
        rep.line("M.meshed-pairs", f"{pn}x{pl_} top-{k} pairs", dt, 0.0 if same else 1.0, 0.0,
                 DEFAULT_PREC, "err=1 if the selected pair sets differ")

    checks = {"grm": _m_grm, "cg-ridge-multitrait": _m_cg_ridge_multitrait,
              "gwasreml": _m_gwasreml, "cv": _m_cv, "bayes-cv": _m_bayes_cv,
              "bayesc": _m_bayesc, "pairs": _m_pairs}
    for name in only or checks:
        rep.run(f"M.{name}", checks[name])


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the mesh phase, on 4 cards")
    ap.add_argument("--only", default=None,
                    help="with --multi: comma-separated mesh checks to run "
                         "(grm, cg-ridge-multitrait, gwasreml, cv, bayes-cv, bayesc, pairs)")
    args = ap.parse_args(argv)

    import jax

    import genomicbreedingmodels_tpu as gbm
    from genomicbreedingmodels_tpu.utils.backend import enable_compile_cache

    if Path(gbm.__file__).resolve().parents[1] != HERE:
        print(f"chip_smoke: the package beside this script is missing "
              f"(imported {gbm.__file__})", file=sys.stderr)
        return 2
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a CUDA GPU; JAX's default device is "
              f"{devices[0].platform!r}. No CPU fallback.", file=sys.stderr)
        return 2
    want = 4 if args.multi else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devices)}", file=sys.stderr)
        return 2
    cache = enable_compile_cache()
    rep = Report()
    rep.info("0.device", f"jax={jax.__version__} devices={len(devices)} "
             f"kind={devices[0].device_kind!r} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
             f"compile_cache={cache}")
    smi = nvidia_smi_line()
    rep.info("0.device", f"nvidia-smi: {smi}")
    t_start = time.perf_counter()
    if args.multi:
        rep.run("M", phase_multi, MULTI_SIZES,
                args.only.split(",") if args.only else None)
    else:
        for name, fn in (("1", phase_flagship), ("2", phase_sampler), ("2c", phase_chains),
                         ("2f", phase_cv_chains), ("3g", phase_gwas), ("3c", phase_cv),
                         ("4", phase_parity)):
            rep.run(name, fn)
    rep.info("done", f"wall_s={time.perf_counter() - t_start:.1f}")
    if rep.failures:
        print("chip_smoke FAILED: " + "; ".join(rep.failures), file=sys.stderr)
        return 1
    print(smi, flush=True)
    print(contract_line(devices if args.multi else devices[:1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
