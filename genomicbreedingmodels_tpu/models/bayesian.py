"""Native JAX Gibbs samplers for the Bayesian alphabet (Bayes A/B/C, Bayesian
ridge, Bayesian LASSO).

This replaces the reference's subprocess FFI to R's BGLR package (reference
src/bayes.jl:28-105 writes TSVs, generates an R script, shells out to Rscript,
and parses effects back). Here the whole MCMC chain is ONE compiled XLA
program: `lax.scan` over sweeps, and within each sweep a blocked marker update
that keeps every n-dimensional operation a GEMM/GEMV.

Blocked-exact design: Gibbs over marker effects is inherently sequential
(each conditional depends on the latest residual). Naively that is p
residual-vector updates per sweep. Instead markers are partitioned into
blocks of size `block_size`; per block we compute u = X_bᵀ r once (GEMV) and
precompute the block Gram C_b = X_bᵀ X_b once per chain (one matmul per
block). Two block-update strategies, chosen per model:

- **Joint block draw** (BayesA / BRR / BayesT — continuous priors): the
  block conditional is jointly Gaussian, so the whole block is sampled in
  ONE Cholesky draw of the bs x bs conditional precision — exact block-Gibbs
  with better mixing than scalar updates, and all dense matrix work.
- **Grouped pattern draw** (all indicator models — BayesB / BayesC /
  BLπ / BayesTπ): markers advance K at a time (default K=6, see
  utils/config.py). Per group the 2^K
  inclusion patterns are scored with the COLLAPSED (effect-integrated)
  marginal likelihood — a vmapped batch of 2^K K×K Cholesky factorizations —
  the pattern is sampled exactly by Gumbel-max, and the included effects are
  then drawn jointly from the K-dim Gaussian conditional. This is exact
  partially-collapsed blocked Gibbs: (γ_g, b_g) is sampled from its exact
  full conditional given everything outside the group, so the stationary
  distribution is identical to the scalar scan's (and mixing is better,
  since correlated indicators move jointly). Sequential dependency drops
  from p scan steps per sweep to p/K. On the GPU the group loop of each
  block runs as one Pallas kernel launch (ops/pallas_gibbs.py); elsewhere
  as an XLA scan.
- **BL** (double-exponential, no indicator) rides the grouped machinery
  degenerated to the single all-ones pattern: K-marker joint Gaussian
  draws per group step — exact blocked Gibbs whose moves stay damped where
  the FULL-block bs-dim joint draw's null-space moves feed BL's
  σ²ₑ-coupled shrinkage loop and diverge (p > n).
- **Sequential scalar scan** (available for every model via
  `indicator_update="scalar"` as the equivalence oracle): the within-block
  pass tracks already-updated markers through C_b rows (length-`block_size`
  axpys) instead of touching the length-n residual; the scan is unrolled 8x
  (loop overhead dominates the tiny step body).

Either way the residual is corrected once per block with a single GEMV and
the chain has exactly the correct stationary distribution (the scalar path
is bit-for-bit fully-sequential Gibbs; the joint path is standard blocked
Gibbs).

Priors follow BGLR's gaussian defaults (R2=0.5, df=5, scaled-inverse-χ²
residual and marker variances, Beta-updated inclusion probability for
Bayes B/C), so posterior means match the reference's backend to MCMC noise.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.structs import Fit, Genomes, Phenomes
from ..ops.metrics import metrics
from ..ops.pallas_gibbs import (
    MAX_GROUP_SIZE,
    build_group_tables,
    group_patterns,
    grouped_block_reference,
    grouped_block_update,
)
from ..prediction import extractxyetc
from ..utils.backend import platform
from ..utils.devcache import SingleSlotCache, host_fingerprint

# Padded device panel of the most recent host-panel chain (gibbs_regression).
_PANEL_CACHE = SingleSlotCache()

__all__ = [
    "gibbs_regression",
    "gibbs_cv_folds",
    "bglr",
    "bayesian",
    "bayesa",
    "bayesb",
    "bayesc",
    "bayesian_ridge",
    "bayesian_lasso",
    "bayesian_lasso_pi",
    "bayest",
    "bayestpi",
    "BAYESIAN_MODELS",
]

BAYESIAN_MODELS = ("BayesA", "BayesB", "BayesC", "BRR", "BL", "BLPi", "BayesT", "BayesTPi")

_MODEL_IDS = {m: i for i, m in enumerate(BAYESIAN_MODELS)}
_INDICATOR_MODELS = ("BayesB", "BayesC", "BLPi", "BayesTPi")

# Sweep-hoisted pattern tables: the W̃ table is (p/K)·2^K·K² floats per chain,
# plus ~2x that transiently while the batched elimination builds it.
_GROUP_TABLE_MAX_FLOATS = int(3.6e8)


def _group_tables_fit(p_pad: int, K: int, n_pat: int, batch: int = 1) -> bool:
    """Whether `batch` chains' hoisted pattern tables fit the table budget."""
    return max(1, batch) * (p_pad // K) * n_pat * K * K <= _GROUP_TABLE_MAX_FLOATS


def _block_kernel_on(mode: str, indicator: bool, group_size: int, p_pad: int,
                     batch: int = 1) -> bool:
    """Whether the indicator draw runs as the Pallas block kernel.

    "auto" takes it on a GPU for the indicator models when `batch` chains'
    hoisted pattern tables fit (vmapped chains run one kernel program per
    chain, a leading grid axis); "pallas" asks for it and is a ValueError
    off the GPU; anything else is the XLA path."""
    if not indicator or group_size <= 1:
        return False
    if mode == "auto":
        return (
            platform() == "gpu"
            and group_size <= MAX_GROUP_SIZE
            and _group_tables_fit(p_pad, group_size, 1 << group_size, batch)
        )
    if mode == "pallas" and platform() != "gpu":
        raise ValueError(
            'indicator_update="pallas" runs a CUDA kernel; the default device '
            f"is {platform()!r}. Use \"grouped\" (the same update as an XLA scan)."
        )
    return mode == "pallas"


def _chi2(key, df, shape=()):
    return 2.0 * jax.random.gamma(key, df / 2.0, shape=shape)


@partial(
    jax.jit,
    static_argnames=("model_id", "n_iter", "n_burnin", "block_size", "n_blocks", "axis_name", "seq_rounds", "response_id", "n_cats", "return_state", "pinned", "group_size", "pallas_groups", "vary_axes", "batch_hint"),
)
def _gibbs_chain(
    X: jnp.ndarray,  # (n, p_pad)  [local marker shard when axis_name is set]
    y: jnp.ndarray,  # (n,)
    valid: jnp.ndarray,  # (p_pad,) 1.0 for real markers
    key: jnp.ndarray,
    hyper: Dict[str, jnp.ndarray],
    model_id: int,
    n_iter: int,
    n_burnin: int,
    block_size: int,
    n_blocks: int,
    axis_name: str = None,
    seq_rounds: int = 1,
    response_id: int = 0,
    n_cats: int = 0,
    iters=None,
    state_in=None,
    return_state: bool = False,
    pinned: bool = False,
    group_size: int = 0,
    pallas_groups: bool = False,
    row_mask=None,
    vary_axes: tuple = (),
    batch_hint: int = 1,
):
    """When `axis_name` is set the chain runs marker-sharded under shard_map:
    each device owns p_pad local markers, processes its own blocks, and the
    residual is kept replicated by psum-ing the per-round block deltas
    across devices. Within a device the update is the exact sequential conditional; the
    D blocks updated concurrently across devices in one round condition on
    the round-start residual (block-Jacobi across devices) — the standard
    distributed-Gibbs approximation, exact again at D=1. Global scalar draws
    use replicated keys; per-marker draws fold in the device index.

    `seq_rounds = D` switches to exact Gauss-Seidel across devices: each
    block round is split into D turns and only the device whose turn it is
    commits its delta (needed for BL, whose sig_e2-proportional shrinkage
    turns Jacobi overshoot into a positive feedback loop)."""

    def _psum(v):
        return jax.lax.psum(v, axis_name) if axis_name is not None else v

    def _pcast(v, axes):
        if not axes:
            return v
        try:
            return jax.lax.pcast(v, axes, to="varying")
        except ValueError:  # idempotent: pcast rejects already-varying inputs
            return v

    def _vary_amb(v):
        # Ambient mesh axes the WHOLE chain runs under (e.g. the fold axis
        # of gibbs_cv_folds's mesh dispatch): there every carried component
        # is device-varying, scalars included.
        return _pcast(v, tuple(vary_axes))

    def _vary(v):
        # Marker-axis state under the marker-sharded sampler (replicated
        # scalars like π/σ²ₑ stay replicated there — they come from psums),
        # plus any ambient axes.
        return _vary_amb(_pcast(v, () if axis_name is None else (axis_name,)))

    dev_ix = jax.lax.axis_index(axis_name) if axis_name is not None else 0
    n, p_pad = X.shape
    bs = block_size
    # Row-masked mode (fold-batched CV): `row_mask` zeroes held-out entries.
    # Masked rows of the centered X are zero, so they contribute nothing to
    # u = Xᵀr, the block Grams, or the residual GEMVs; the only places the
    # entry count enters explicitly (column means, intercept draw, residual
    # χ², inits) use n_eff = Σ mask instead of the static n. The unmasked
    # program is left textually identical (bit-identical chains vs prior
    # rounds).
    masked = row_mask is not None
    if masked and response_id == 1:
        raise ValueError("row-masked chains support gaussian responses only")
    n_eff = jnp.sum(row_mask) if masked else n
    # Center the design; the intercept absorbs the column means and the
    # returned mu is adjusted back at the end. Centering removes the common
    # all-positive direction of allele-frequency columns — essential for the
    # sharded block-Jacobi rounds (uncentered concurrent blocks all absorb
    # the residual mean and overshoot), and better-conditioned generally.
    if masked:
        mu_cols = jnp.sum(X * row_mask[:, None], axis=0) / n_eff
        X = (X - mu_cols[None, :]) * row_mask[:, None]
    else:
        mu_cols = jnp.mean(X, axis=0)  # (p_pad,) local
        X = X - mu_cols[None, :]
    x2 = jnp.sum(X * X, axis=0)  # (p_pad,)
    # Per-block Gram matrices: (B, bs, bs); one matmul per block via a
    # lax.map over (n, bs) slices. The previous batched-einsum formulation
    # went through a block-major transposed COPY of the whole panel
    # (X.T.reshape) — a second panel-sized buffer that, at 10k x 100k
    # (4.1 GB), pushed the chain's peak past HBM.
    C = jax.lax.map(
        lambda blk: jnp.dot(
            jax.lax.dynamic_slice(X, (0, blk * bs), (n, bs)).T,
            jax.lax.dynamic_slice(X, (0, blk * bs), (n, bs)),
            preferred_element_type=jnp.float32,
        ),
        jnp.arange(n_blocks),
    )

    df_b = hyper["df_b"]
    S_b0 = hyper["S_b0"]
    df_e = hyper["df_e"]
    S_e0 = hyper["S_e0"]
    pi_in0 = hyper["pi_in"]
    pi_counts = hyper["pi_counts"]
    p_real = _psum(jnp.sum(valid))

    has_indicator = model_id in (
        _MODEL_IDS["BayesB"], _MODEL_IDS["BayesC"], _MODEL_IDS["BLPi"], _MODEL_IDS["BayesTPi"],
    )
    per_marker_var = model_id in (
        _MODEL_IDS["BayesA"], _MODEL_IDS["BayesB"], _MODEL_IDS["BL"],
        _MODEL_IDS["BLPi"], _MODEL_IDS["BayesT"], _MODEL_IDS["BayesTPi"],
    )
    is_bl = model_id in (_MODEL_IDS["BL"], _MODEL_IDS["BLPi"])
    # BayesT/BayesTπ (reference dead-code spec, src/bayes.jl:745-855): fixed
    # unscaled t prior — the per-marker scaled-inv-χ² machinery of BayesA but
    # with the hyper-scale S pinned instead of Gamma-updated.
    fixed_scale = model_id in (_MODEL_IDS["BayesT"], _MODEL_IDS["BayesTPi"])
    # Grouped pattern draw covers every indicator model: the collapsed
    # pattern weights only consume the per-marker prior variances s2 (which
    # already encode BayesB's scaled-t draw, BLπ's σ²ₑ·τ², and BayesTπ's
    # fixed-scale t — all constant across a sweep's marker scan), σ²ₑ, and π,
    # so BLπ/BayesTπ use the identical machinery as BayesB/C.
    # BL (no indicator) uses the SAME machinery degenerated to the single
    # all-ones pattern: a K-marker joint Gaussian draw per group step —
    # exact blocked Gibbs whose moves are small enough to stay damped
    # (it is the FULL-block bs-dim joint draw whose null-space moves feed
    # BL's σ²ₑ-coupled shrinkage loop when p > n; equivalence + stability
    # vs the scalar scan is tested on a p>n LD panel).
    grouped = group_size > 1 and (has_indicator or model_id == _MODEL_IDS["BL"])
    if grouped:
        K_g = group_size
        gpb = bs // K_g
        n_pat = (1 << K_g) if has_indicator else 1
        patterns = group_patterns(K_g, n_pat)
        # Sweep-level HOISTING of the per-(group, pattern) Cholesky batch:
        # s2 / σ²ₑ / π are constant across the whole block scan of one sweep
        # (they update in steps 3-5 AFTER it), so every group's 2^K pattern
        # factorization is built ONCE per sweep as one batched computation
        # (ops/pallas_gibbs.py:build_group_tables) instead of inside each
        # sequential group step — the group step then shrinks to a
        # quadratic-form einsum + Gumbel-argmax + one K-vector matvec. Gated
        # by table size (`batch_hint` = chains vmapped over this function,
        # e.g. gibbs_cv_folds's F folds: their tables are resident together).
        # The Pallas block kernel reads the tables, so it always hoists.
        # Non-hoisted chains fall back to in-step elimination.
        hoist_groups = pallas_groups or _group_tables_fit(p_pad, K_g, n_pat, batch_hint)
    else:
        hoist_groups = False
    # Joint-block models (BRR/BayesA/BayesT — no indicator, no BL): the block
    # precision P_b = C_b/σ²ₑ + diag(1/s²) is ALSO sweep-constant, so all
    # n_blocks Choleskys + their explicit inverses batch into ONE per-sweep
    # factorization (dense batched work), and the sequential block step shrinks
    # from {cholesky, cho_solve, trsv} — each a dispatch-heavy sequential
    # lowering inside the scan — to two (bs, bs) GEMVs against the hoisted
    # L⁻¹ slice. Gate on total table floats (the L⁻¹ table is the same size
    # as the block-Gram stack C; batch_hint covers vmapped CV folds).
    # bs gate: the win comes from collapsing n_blocks sequential in-scan
    # Choleskys into one batched bs-step factorization; past some block width
    # the batched build's own sequential column loop outgrows what it saves.
    hoist_joint = (
        not grouped
        and not has_indicator
        and not is_bl
        and bs <= 384
        and max(1, batch_hint) * n_blocks * bs * bs <= int(1.0e8)
    )

    def _build_joint_tables(s2, sig_e2):
        """Batched L⁻¹ of every block's joint-draw precision (B, bs, bs).

        Padded/invalid markers carry zero Gram rows and a pinned unit
        diagonal, so their L⁻¹ rows/cols are exactly e_k — the draw is
        finite there and masked back to zero in the block step (same
        convention as the in-step path below).
        """
        dinv = jnp.where(valid > 0, 1.0 / jnp.maximum(s2, 1e-12), 1.0)
        Pm = C / sig_e2 + jnp.eye(bs)[None, :, :] * dinv.reshape(n_blocks, 1, bs)
        Lall = jnp.linalg.cholesky(Pm)
        eye_b = jnp.broadcast_to(jnp.eye(bs), (n_blocks, bs, bs))
        return jax.scipy.linalg.solve_triangular(Lall, eye_b, lower=True)

    def block_step(carry, gb, tables=None):
        b, r, s2, sig_e2, pi_in, incl_acc, key = carry
        key, k_blk = jax.random.split(key)
        if axis_name is not None:
            k_blk = jax.random.fold_in(k_blk, dev_ix)
        if seq_rounds > 1:
            blk = gb // seq_rounds
            active = (gb % seq_rounds) == dev_ix
        else:
            blk = gb
            active = jnp.bool_(True)
        Xblk = jax.lax.dynamic_slice(X, (0, blk * bs), (n, bs))
        u = jnp.dot(Xblk.T, r, preferred_element_type=jnp.float32)  # (bs,)
        b_blk = jax.lax.dynamic_slice(b, (blk * bs,), (bs,))
        x2_blk = jax.lax.dynamic_slice(x2, (blk * bs,), (bs,))
        s2_blk = jax.lax.dynamic_slice(s2, (blk * bs,), (bs,))
        val_blk = jax.lax.dynamic_slice(valid, (blk * bs,), (bs,))
        Cb = C[blk]
        # Pre-draw the block's random numbers so the sequential pass is pure
        # arithmetic (one draw per marker, consumed in order).
        k1, k2 = jax.random.split(k_blk)
        normals = jax.random.normal(k1, (bs,))
        if not grouped:
            uniforms = jax.random.uniform(k2, (bs,))

        def marker_step(carry, j):
            """One marker's exact sequential-Gibbs update within the block.

            Read-only block state (Cb, u, x2_blk, ...) is closed over; the
            carry holds only what mutates (cdelta, delta, b_blk) so XLA keeps
            the loop state in registers/VMEM without re-copying the Gram tile.
            """
            cdelta, delta, b_blk = carry
            num = u[j] - cdelta[j] + x2_blk[j] * b_blk[j]  # x_jᵀ(y - μ - X₋ⱼ b₋ⱼ)
            prec = x2_blk[j] / sig_e2 + 1.0 / s2_blk[j]
            mean = (num / sig_e2) / prec
            sd = jnp.sqrt(1.0 / prec)
            b_new_in = mean + sd * normals[j]
            if has_indicator:
                # Marginal (effect-integrated) inclusion odds.
                log_odds = (
                    jnp.log(pi_in / (1.0 - pi_in))
                    - 0.5 * jnp.log(s2_blk[j] * prec)
                    + 0.5 * mean * mean * prec
                )
                incl = uniforms[j] < jax.nn.sigmoid(log_odds)
                b_new = jnp.where(incl, b_new_in, 0.0)
            else:
                incl = jnp.bool_(True)
                b_new = b_new_in
            b_new = jnp.where(val_blk[j] > 0, b_new, 0.0)
            d = b_new - b_blk[j]
            # C_b is symmetric, so the column C_b[:, j] equals the row
            # C_b[j, :]; the row is a contiguous dynamic slice while the
            # column would be a strided gather.
            cdelta = cdelta + Cb[j, :] * d  # length-bs axpy
            delta = delta.at[j].set(d)
            b_blk = b_blk.at[j].set(b_new)
            return (cdelta, delta, b_blk), incl

        if grouped and tables is not None:
            # Hoisted grouped draw: the per-pattern Choleskys were factorized
            # once for the whole sweep (build_group_tables); each group step
            # is only the v-dependent part — Z = W̃v per pattern, score
            # const + ½‖Z‖² + gumbel, then the selected pattern's joint draw
            # b = W̃ᵀ(Z + η). Exactly the same update law as the in-step
            # elimination branch below. The group loop runs either as one
            # Pallas kernel launch per block (GPU) or as an XLA scan.
            W_all, const_all = tables
            Wb = jax.lax.dynamic_slice(
                W_all, (blk, 0, 0, 0, 0), (1, gpb, n_pat, K_g, K_g)
            )[0]
            cb = jax.lax.dynamic_slice(const_all, (blk, 0, 0), (1, gpb, n_pat))[0]
            gum = -jnp.log(-jnp.log(jax.random.uniform(
                k2, (gpb, n_pat), minval=1e-12, maxval=1.0 - 1e-7
            )))
            if pallas_groups:
                delta, b_blk_new, incl = grouped_block_update(
                    Cb, u, b_blk, val_blk, normals, Wb, cb + gum, sig_e2
                )
            else:
                delta, b_blk_new, incl = grouped_block_reference(
                    Cb, u, b_blk, val_blk, normals, Wb, cb + gum, sig_e2,
                    patterns, vary=_vary,
                )
        elif grouped:
            # Exact partially-collapsed draw of (γ_g, b_g), K markers at a
            # time: score all 2^K inclusion patterns with the COLLAPSED
            # (effect-integrated) marginal likelihood, Gumbel-max sample the
            # pattern, then draw the included effects jointly from the K-dim
            # Gaussian conditional. Same stationary distribution as the
            # scalar scan (it samples the pair from its exact full
            # conditional given everything outside the group) with 1/K the
            # sequential scan steps — which is what the scalar path was
            # bound by (per-step dispatch, not FLOPs). Equivalence is tested
            # against the scalar oracle in tests/test_bayesian.py.
            # (All 2^K inclusion patterns precomputed at function level;
            # bit j of pattern m is γ_mj.)
            n_groups = gpb
            gum = -jnp.log(-jnp.log(jax.random.uniform(
                k2, (n_groups, n_pat), minval=1e-12, maxval=1.0 - 1e-7
            )))
            log_pi = jnp.log(pi_in)
            log_1mpi = jnp.log1p(-jnp.minimum(pi_in, 1.0 - 1e-7))  # pi=1
            # (BL's degenerate single-pattern case) would give -inf*0 = NaN

            def group_step(carry, g):
                """One K-marker group. With v = X_gᵀ(residual with the whole
                group removed)/σ²ₑ and P(γ) = (C_gg ⊙ γγᵀ)/σ²ₑ +
                diag(γ/s² + (1−γ)), the pattern weight is
                  Σγ·logπ + Σ(1−γ)·log(1−π) − ½Σ_γ log s² − ½log|P| + ½vᵀP⁻¹v
                (the Gaussian (2π)^{k/2} normalizers cancel between prior and
                posterior exactly). Excluded coords ride along as identity
                rows: they add 0 to both the determinant and the quadratic
                form, and Cholesky has no fill-in across the decoupled index
                sets, so the masked K-dim draw equals the included-submatrix
                draw exactly.
                """
                cdelta, delta, b_blk = carry
                r0 = g * K_g
                Cb_rows = jax.lax.dynamic_slice(Cb, (r0, 0), (K_g, bs))
                C_gg = jax.lax.dynamic_slice(Cb_rows, (0, r0), (K_g, K_g))
                u_cur = (
                    jax.lax.dynamic_slice(u, (r0,), (K_g,))
                    - jax.lax.dynamic_slice(cdelta, (r0,), (K_g,))
                )
                b_cur = jax.lax.dynamic_slice(b_blk, (r0,), (K_g,))
                s2_g = jax.lax.dynamic_slice(s2_blk, (r0,), (K_g,))
                val_g = jax.lax.dynamic_slice(val_blk, (r0,), (K_g,))
                v = (u_cur + C_gg @ b_cur) / sig_e2

                # Batched over all 2^K patterns at once. The K×K Cholesky,
                # forward solve, and back solve are HAND-UNROLLED (static K)
                # into pure elementwise tensor ops on (2^K, K[, K]) shapes:
                # XLA's generic batched cholesky/triangular_solve lowers to
                # per-column loops whose dispatch overhead dominates at this
                # size; the unrolled dataflow fuses into a handful of
                # elementwise kernels.
                M = patterns * val_g[None, :]  # (n_pat, K)
                vm = jnp.where(M > 0, v[None, :], 0.0)  # (n_pat, K)
                # BORDERED matrix [[P, v], [vᵀ, 0]]: running the K Cholesky
                # elimination steps over the first K columns makes the border
                # row accumulate the forward solve w = L⁻¹v for free (its
                # entry in column j is exactly w_j) and the corner accumulate
                # −‖w‖² — no separate triangular solve or reduction needed.
                Pm = (C_gg / sig_e2)[None] * (M[:, :, None] * M[:, None, :]) + (
                    jnp.eye(K_g)[None]
                    * jnp.where(M > 0, 1.0 / s2_g[None, :], 1.0)[:, :, None]
                )
                acc = jnp.concatenate(
                    [
                        jnp.concatenate([Pm, vm[:, None, :]], axis=1),
                        jnp.concatenate(
                            [vm[:, :, None], jnp.zeros((n_pat, 1, 1))], axis=1
                        ),
                    ],
                    axis=2,
                )  # (n_pat, K+1, K+1)
                cols = []
                half_logdet = jnp.zeros((n_pat,))
                row_mask = jnp.tril(jnp.ones((K_g + 1, K_g), jnp.float32))
                for j in range(K_g):
                    dj = jnp.maximum(acc[:, j, j], 1e-30)
                    half_logdet = half_logdet + 0.5 * jnp.log(dj)
                    col = acc[:, :, j] * jax.lax.rsqrt(dj)[:, None]
                    col = col * row_mask[:, j][None, :]  # rows < j are 0
                    acc = acc - col[:, :, None] * col[:, None, :]
                    cols.append(col)
                Lb = jnp.stack(cols, axis=2)  # (n_pat, K+1, K) bordered lower
                quad = -acc[:, K_g, K_g]  # = ‖L⁻¹v_m‖² = v_mᵀP⁻¹v_m
                logws = (
                    jnp.sum(M, axis=1) * log_pi
                    + jnp.sum(val_g[None, :] * (1.0 - patterns), axis=1) * log_1mpi
                    - 0.5 * jnp.sum(jnp.where(M > 0, jnp.log(s2_g)[None, :], 0.0), axis=1)
                    - half_logdet  # = −½ log|P|
                    + 0.5 * quad
                    - 1e30 * jnp.sum(patterns * (1.0 - val_g)[None, :], axis=1)
                )
                m_star = jnp.argmax(logws + gum[g])
                gam = patterns[m_star] * val_g
                Lsel = Lb[m_star]  # (K+1, K); row K is w = L⁻¹v_m
                w = Lsel[K_g, :]
                eta = jax.lax.dynamic_slice(normals, (r0,), (K_g,))
                # mean = P⁻¹v_m = L⁻ᵀw; mean + L⁻ᵀη in ONE back substitution,
                # K unrolled steps.
                rhs = w + eta
                b_acc = jnp.zeros((K_g,))
                for j in range(K_g - 1, -1, -1):
                    bj = (rhs[j] - jnp.dot(Lsel[:K_g, j], b_acc)) / Lsel[j, j]
                    b_acc = b_acc.at[j].set(bj)
                b_new = jnp.where(gam > 0, b_acc, 0.0)
                d = b_new - b_cur
                cdelta = cdelta + jnp.dot(d, Cb_rows, preferred_element_type=jnp.float32)
                delta = jax.lax.dynamic_update_slice(delta, d, (r0,))
                b_blk = jax.lax.dynamic_update_slice(b_blk, b_new, (r0,))
                return (cdelta, delta, b_blk), gam > 0

            init = (_vary(jnp.zeros(bs)), _vary(jnp.zeros(bs)), b_blk)
            # unroll: the group body is elementwise dataflow; unrolling lets
            # XLA overlap the next group's pattern build with this group's
            # tail (they only couple through the small cdelta/b_blk carry).
            (cdelta, delta, b_blk_new), incl_g = jax.lax.scan(
                group_step, init, jnp.arange(n_groups), unroll=4
            )
            incl = incl_g.reshape(bs)
        elif has_indicator or is_bl:
            # Indicator models need the per-marker discrete draws; BL keeps
            # the scalar scan too — its σ²ₑ-proportional shrinkage feedback
            # turns the joint draw's larger null-space moves into a positive
            # feedback loop when p > n (observed to diverge), while the
            # one-at-a-time update stays damped.
            init = (_vary(jnp.zeros(bs)), _vary(jnp.zeros(bs)), b_blk)
            # unroll: per-step loop overhead dominates the tiny marker body.
            (cdelta, delta, b_blk_new), incl = jax.lax.scan(
                marker_step, init, jnp.arange(bs), unroll=8
            )
        else:
            # No inclusion indicators → the block conditional b_b | rest is
            # jointly Gaussian: N(Σ⁻¹ rhs, Σ⁻¹) with Σ = C_b/σ²ₑ + D⁻¹ and
            # rhs = X_bᵀ(y − μ − X₋ᵦ b₋ᵦ)/σ²ₑ = (u + C_b b_b)/σ²ₑ. Sampling
            # the whole block in ONE Cholesky draw is exact block-Gibbs
            # (better mixing than the scalar scan) and replaces bs sequential
            # scan steps with dense matrix work. Padded markers have zero columns
            # (C_b row/col = 0, u = 0); their diagonal is pinned so the draw
            # is finite, then masked back to zero.
            rhs = (u + jnp.dot(Cb, b_blk, preferred_element_type=jnp.float32)) / sig_e2
            if tables is not None:
                # Hoisted path (hoist_joint): the block's L⁻¹ was batch-
                # factorized once for the whole sweep; mean + L⁻ᵀη in two
                # GEMVs — mean = L⁻ᵀ(L⁻¹ rhs), draw = L⁻ᵀ(L⁻¹ rhs + η).
                # Same update law as the in-step Cholesky below (f32 op
                # order differs).
                Linv_b = jax.lax.dynamic_slice(tables, (blk, 0, 0), (1, bs, bs))[0]
                w = jnp.dot(Linv_b, rhs, preferred_element_type=jnp.float32)
                b_new = jnp.dot(
                    w + normals, Linv_b, preferred_element_type=jnp.float32
                )  # (w+η) @ L⁻¹ = L⁻ᵀ(w+η)
            else:
                dinv = jnp.where(val_blk > 0, 1.0 / jnp.maximum(s2_blk, 1e-12), 1.0)
                prec = Cb / sig_e2 + jnp.diag(dinv)
                Lc = jnp.linalg.cholesky(prec)
                mean = jax.scipy.linalg.cho_solve((Lc, True), rhs)
                b_new = mean + jax.scipy.linalg.solve_triangular(
                    Lc.T, normals, lower=False
                )
            b_new = jnp.where(val_blk > 0, b_new, 0.0)
            b_blk_new = b_new
            delta = b_new - b_blk
            incl = jnp.ones((bs,), bool)
        # Gate: in sequential-device mode only the device whose turn it is
        # commits; the others recompute their block when their turn comes.
        delta = jnp.where(active, delta, 0.0)
        b_blk_new = jnp.where(active, b_blk_new, b_blk)
        incl_blk = jnp.where(active, incl.astype(jnp.float32),
                             jax.lax.dynamic_slice(incl_acc, (blk * bs,), (bs,)))
        r = r - _psum(jnp.dot(Xblk, delta, preferred_element_type=jnp.float32))
        b = jax.lax.dynamic_update_slice(b, b_blk_new, (blk * bs,))
        incl_acc = jax.lax.dynamic_update_slice(incl_acc, incl_blk, (blk * bs,))
        return (b, r, s2, sig_e2, pi_in, incl_acc, key), None

    is_ordinal = response_id == 1

    def sweep(state, it):
        b, r, s2, sig_e2, mu, pi_in, S_scale, key, acc_b, acc_mu, acc_n, z, gam = state
        key, k_mu, k_e, k_s2, k_scale, k_hyper, k_pi1, k_pi2, k_blks, k_z, k_gam = jax.random.split(key, 11)
        if axis_name is not None:
            # Per-marker draws must differ across shards; global scalar draws
            # (k_mu, k_e, k_hyper, k_pi*) stay replicated.
            k_s2 = jax.random.fold_in(k_s2, dev_ix)
            k_scale_local = jax.random.fold_in(k_scale, dev_ix)
        else:
            k_scale_local = k_scale

        # 1) Marker effects, blocked-exact Gibbs. With hoisting, the grouped
        # pattern tables are factorized once here (s2/σ²ₑ/π are constant
        # until steps 3-5 below) and every block step reads its slice.
        if hoist_groups:
            tables = build_group_tables(C, s2, valid, sig_e2, pi_in, patterns)
            body = lambda c, gb: block_step(c, gb, tables)  # noqa: E731
        elif hoist_joint:
            tables = _build_joint_tables(s2, sig_e2)
            body = lambda c, gb: block_step(c, gb, tables)  # noqa: E731
        else:
            body = block_step
        incl_acc0 = _vary(jnp.zeros(p_pad))
        (b, r, s2, sig_e2, pi_in, incl_acc, _), _ = jax.lax.scan(
            body, (b, r, s2, sig_e2, pi_in, incl_acc0, k_blks),
            jnp.arange(n_blocks * seq_rounds),
        )
        incl = incl_acc * valid
        active = jnp.where(has_indicator, incl, valid)

        # 2) Intercept.
        if masked:
            mu_new = mu + jnp.sum(r) / n_eff + jnp.sqrt(sig_e2 / n_eff) * jax.random.normal(k_mu)
            r = r - (mu_new - mu) * row_mask
        else:
            mu_new = mu + jnp.mean(r) + jnp.sqrt(sig_e2 / n) * jax.random.normal(k_mu)
            r = r - (mu_new - mu)
        mu = mu_new

        if is_ordinal:
            # 2b) Albert-Chib probit augmentation: y holds category codes
            # 0..C-1; the latent liability z replaces the response and the
            # residual variance is fixed at 1 (probit identification).
            from jax.scipy.special import ndtr, ndtri

            eta = z - r
            # Interior thresholds gamma_1..gamma_{C-1}; gamma_1 pinned at 0.
            BIG = jnp.float32(1e10)
            lo_k = jnp.stack([
                jnp.max(jnp.where(y == k, z, -BIG)) for k in range(n_cats - 1)
            ])
            hi_k = jnp.stack([
                jnp.min(jnp.where(y == k + 1, z, BIG)) for k in range(n_cats - 1)
            ])
            u_g = jax.random.uniform(k_gam, (n_cats - 1,))
            gam_new = lo_k + u_g * (hi_k - lo_k)
            gam = gam.at[:].set(gam_new)
            gam = gam.at[0].set(0.0)  # identifiability
            full_gam = jnp.concatenate([jnp.array([-BIG]), gam, jnp.array([BIG])])
            lo = full_gam[y.astype(jnp.int32)]
            hi = full_gam[y.astype(jnp.int32) + 1]
            # Truncated-normal draw by inverse CDF.
            a = ndtr(lo - eta)
            bcdf = ndtr(hi - eta)
            u_z = jax.random.uniform(k_z, (n,), minval=1e-6, maxval=1.0 - 1e-6)
            q = jnp.clip(a + u_z * (bcdf - a), 1e-6, 1.0 - 1e-6)
            z = eta + ndtri(q)
            r = z - eta
            sig_e2 = jnp.float32(1.0)
            sse = jnp.dot(r, r)
        else:
            # 3) Residual variance: σ²ₑ = (SSE + Sₑ) / χ²(n + dfₑ) (BGLR).
            # Masked rows carry r = 0, so SSE needs no masking; the χ²
            # degrees of freedom count only real training rows.
            sse = jnp.dot(r, r)
            sig_e2 = (sse + S_e0) / _chi2(k_e, df_e + (n_eff if masked else n))
        if pinned:
            # Oracle mode: variances held fixed so the marker-effect posterior
            # is exactly Gaussian (conjugate) — used by the f64 parity suite.
            sig_e2 = hyper["fix_e"]

        # 4) Marker variances.
        if per_marker_var:
            if is_bl:
                # Bayesian LASSO: τ²ⱼ via inverse-Gaussian; λ² via Gamma.
                lam2 = S_scale
                mu_ig = jnp.sqrt(lam2 * sig_e2 / jnp.maximum(b * b, 1e-12))
                nrm = jax.random.normal(k_s2, (p_pad,))
                v = nrm * nrm
                x_ig = (
                    mu_ig
                    + mu_ig * mu_ig * v / (2.0 * lam2)
                    - mu_ig / (2.0 * lam2) * jnp.sqrt(4.0 * lam2 * mu_ig * v + mu_ig**2 * v * v)
                )
                ubern = jax.random.uniform(k_scale_local, (p_pad,))
                inv_tau2 = jnp.where(ubern <= mu_ig / (mu_ig + x_ig), x_ig, mu_ig * mu_ig / jnp.maximum(x_ig, 1e-20))
                s2 = jnp.clip(sig_e2 / jnp.maximum(inv_tau2, 1e-12), 1e-10, 1e6)
                if has_indicator:
                    # BLπ (reference spec: Laplace + point mass): excluded
                    # markers refresh τ² from its prior Exp(λ²/2) instead of
                    # the b=0-degenerate inverse-Gaussian conditional.
                    u_pr = jax.random.uniform(
                        jax.random.fold_in(k_s2, 1), (p_pad,), minval=1e-12, maxval=1.0
                    )
                    tau2_prior = -2.0 * jnp.log(u_pr) / jnp.maximum(lam2, 1e-12)
                    s2_prior = jnp.clip(sig_e2 * tau2_prior, 1e-10, 1e6)
                    s2 = jnp.where(active > 0, s2, s2_prior)
                # λ² | τ² ~ Gamma(p + shape, Στ²/2 + rate)
                tau2_sum = _psum(jnp.sum(jnp.where(valid > 0, s2 / sig_e2, 0.0)))
                lam2 = jax.random.gamma(k_hyper, p_real + 1.1) / (0.5 * tau2_sum + 1.1 / hyper["lam2_0"])
                # Keep λ² in a numerically safe f32 range: the shrinkage
                # feedback (σ²ₑ↓ → Στ²↑ → λ²↓ → τ²↑) can otherwise underflow
                # λ²·σ²ₑ and NaN the inverse-Gaussian draw next sweep.
                S_scale = jnp.clip(lam2, 1e-10, 1e10)
            else:
                # Scaled-t (BayesA/B): σ²ⱼ | bⱼ ~ (S + bⱼ²)/χ²(df+1) when active,
                # prior draw S/χ²(df) when excluded.
                chis = _chi2(k_s2, df_b + 1.0, (p_pad,))
                chis0 = _chi2(k_scale_local, df_b, (p_pad,))
                s2_in = (S_scale + b * b) / chis
                s2_out = S_scale / chis0
                s2 = jnp.where(active > 0, s2_in, s2_out)
                s2 = jnp.clip(s2, 1e-10, 1e6)
                if not fixed_scale:
                    # Hyper-scale S | σ²ⱼ ~ Gamma (BayesA/B); BayesT keeps the
                    # reference's fixed unscaled t prior.
                    inv_sum = _psum(jnp.sum(jnp.where(valid > 0, 1.0 / s2, 0.0)))
                    S_scale = jax.random.gamma(k_hyper, p_real * df_b / 2.0 + 1.1) / (
                        0.5 * inv_sum + 1.1 / S_b0
                    )
        else:
            # Common slab variance (BayesC / BRR).
            k_a, k_b2 = jax.random.split(k_s2)
            ssb = _psum(jnp.sum(jnp.where(active > 0, b * b, 0.0)))
            nb = _psum(jnp.sum(active))
            s2_common = (ssb + S_b0 * df_b) / _chi2(k_a, df_b + nb)
            s2_common = jnp.clip(s2_common, 1e-10, 1e6)
            s2 = _vary(jnp.full((p_pad,), s2_common))
        if pinned:
            s2 = _vary(jnp.full((p_pad,), hyper["fix_b"]))

        # 5) Inclusion probability π (BayesB/C).
        if has_indicator:
            n_in = _psum(jnp.sum(incl))
            a = pi_in0 * pi_counts + n_in
            bcount = (1.0 - pi_in0) * pi_counts + (p_real - n_in)
            g1 = jax.random.gamma(k_pi1, a)
            g2 = jax.random.gamma(k_pi2, bcount)
            pi_in = jnp.clip(g1 / (g1 + g2), 1e-4, 1.0 - 1e-4)

        # 6) Posterior accumulation after burn-in.
        w = jnp.where(it >= n_burnin, 1.0, 0.0)
        acc_b = acc_b + w * b
        acc_mu = acc_mu + w * mu
        acc_n = acc_n + w
        # Per-sweep scalar traces for mixing diagnostics: σ²ₑ plus an
        # 8-marker effect probe (ESS/s of effects is the honest "better
        # mixing" measurement — sweeps/s alone can hide a slow-mixing
        # kernel). Tiny: 9 floats per sweep.
        b_probe = jax.lax.dynamic_slice(b, (0,), (min(8, p_pad),))
        return (b, r, s2, sig_e2, mu, pi_in, S_scale, key, acc_b, acc_mu, acc_n, z, gam), (sig_e2, b_probe)

    if response_id == 1:
        # Latent liabilities start at the standardized category codes with
        # jitterless spread; interior thresholds at equally spaced normals.
        z0 = (y - jnp.mean(y)) / jnp.maximum(jnp.std(y), 1e-6)
        gam0 = jnp.linspace(0.0, 1.0, max(n_cats - 1, 1)).astype(jnp.float32)
        mu0 = jnp.float32(0.0)
        r0 = z0 - mu0
        sig0 = jnp.float32(1.0)
    elif masked:
        z0 = y
        gam0 = jnp.zeros((max(n_cats - 1, 1),), jnp.float32)
        mu0 = jnp.sum(y * row_mask) / n_eff
        r0 = (y - mu0) * row_mask
        sig0 = jnp.sum(r0 * r0) / n_eff * 0.5
    else:
        z0 = y
        gam0 = jnp.zeros((max(n_cats - 1, 1),), jnp.float32)
        mu0 = jnp.mean(y)
        r0 = y - mu0
        sig0 = jnp.var(y) * 0.5
    if pinned:
        sig0 = hyper["fix_e"]
    s2_init = hyper["fix_b"] if pinned else S_b0 / jnp.maximum(df_b - 2.0, 0.5)
    # Scalar/replicated inits are additionally marked varying over the
    # AMBIENT axes only (no-op when there are none): under a fold-sharded
    # shard_map even π and the posterior accumulators become device-varying
    # after one sweep, while under the marker-sharded sampler they stay
    # replicated (psum-derived) and must NOT be marked.
    state0 = (
        _vary(jnp.zeros(p_pad)),  # b
        _vary_amb(r0),  # r
        _vary(jnp.full((p_pad,), s2_init)),  # s2
        _vary_amb(sig0 * jnp.ones(())),  # sig_e2
        _vary_amb(mu0 * jnp.ones(())),  # mu
        _vary_amb(pi_in0 * jnp.ones(())),  # pi
        _vary_amb(jnp.where(is_bl, hyper["lam2_0"], S_b0)),  # S_scale / λ²
        key,
        _vary(jnp.zeros(p_pad)),
        _vary_amb(jnp.zeros(())),
        _vary_amb(jnp.zeros(())),
        _vary_amb(z0),
        _vary_amb(gam0),
    )
    # Segmented execution: `state_in` resumes a chain mid-run and `iters`
    # carries the GLOBAL iteration indices (burn-in accounting stays right);
    # `return_state` hands the full carry back for the next segment or for a
    # checkpoint file. One long scan and N chained short scans produce the
    # bit-identical chain (the RNG key is part of the carry).
    if state_in is not None:
        state0 = state_in
    if iters is None:
        iters = jnp.arange(n_iter)
    state, traces = jax.lax.scan(sweep, state0, iters)
    acc_b, acc_mu, acc_n = state[8], state[9], state[10]
    safe_n = jnp.maximum(acc_n, 1e-12)
    b_mean = acc_b / safe_n
    # Undo the centering reparametrization: y = mu_c + (X - mu_cols) b
    #                                         = (mu_c - mu_cols . b) + X b.
    mu_out = acc_mu / safe_n - _psum(jnp.dot(mu_cols, b_mean))
    if return_state:
        return mu_out, b_mean, traces, state
    return mu_out, b_mean, traces


def gibbs_regression(
    X,
    y,
    model: str = "BayesA",
    n_iter: int = None,
    n_burnin: int = None,
    seed: int = 42,
    block_size: int = None,
    n_chains: int = 1,
    r2: float = 0.5,
    response_type: str = "gaussian",
    chunk_size: int = None,
    checkpoint_path: str = None,
    fix_sigma_e2: Optional[float] = None,
    fix_sigma_b2: Optional[float] = None,
    indicator_update: str = None,
) -> Tuple[float, np.ndarray, dict]:
    """Run the blocked Gibbs sampler; returns (mu_hat, b_hat, diagnostics).

    `indicator_update` ("auto" default via GBMConfig) selects the indicator
    within-block update: "pallas" = the grouped 2^K-pattern collapsed draw
    with each block's group loop as one Pallas kernel launch
    (ops/pallas_gibbs.py; CUDA GPUs only), "grouped" = the same exact update
    as an XLA scan, "scalar" = the one-marker-at-a-time scan (the
    equivalence oracle). All target the identical posterior; "auto"
    resolves to "pallas" on a GPU for the indicator models when the hoisted
    pattern tables fit, and to "grouped" elsewhere.

    `fix_sigma_e2`/`fix_sigma_b2` (both required together) pin the residual
    and marker variances, making the marker-effect posterior exactly Gaussian
    — the conjugate-oracle mode used by tests/test_parity_oracles.py to check
    the sampler against the closed-form posterior mean.

    `n_chains > 1` runs independent chains (vmapped — data-parallel across the
    batch dimension, or across devices under shard_map) and averages posterior
    means. `response_type="ordinal"` runs Albert-Chib probit augmentation on
    integer category codes (the reference's BGLR passthrough, src/bayes.jl);
    b_hat is then on the latent liability scale.

    `chunk_size` runs the chain in segments of that many sweeps (identical
    chain statistics: the RNG key rides in the carried state), and
    `checkpoint_path` adds crash-resume between segments (single-chain runs).
    """
    if model not in _MODEL_IDS:
        raise ValueError(f"unknown Bayesian model {model!r}; choose from {BAYESIAN_MODELS}")
    if response_type not in ("gaussian", "ordinal"):
        raise ValueError(f"unknown response_type {response_type!r}")
    from ..utils.config import get_config

    cfg = get_config()
    # MCMC defaults flow from GBMConfig (reference defaults n_iter=1500,
    # n_burnin=500, src/linear.jl:446-447); override via GBM_MCMC_* env vars.
    n_iter = cfg.mcmc_n_iter if n_iter is None else n_iter
    n_burnin = cfg.mcmc_n_burnin if n_burnin is None else n_burnin
    block_size = cfg.mcmc_block_size if block_size is None else block_size
    indicator_update = cfg.mcmc_indicator_update if indicator_update is None else indicator_update
    if indicator_update not in ("auto", "grouped", "pallas", "scalar"):
        raise ValueError(f"unknown indicator_update {indicator_update!r}")
    indicator = model in _INDICATOR_MODELS
    if indicator_update in ("auto", "grouped", "pallas") and (indicator or model == "BL"):
        # BL rides the grouped machinery degenerated to the single all-ones
        # pattern (K-marker joint draws; no kernel variant for this shape).
        group_size = int(cfg.mcmc_group_size)
    else:
        group_size = 0
    # A panel already living on device stays there: np.asarray on a 4 GB
    # jax array would round-trip it through the host. Host panels keep the
    # original numpy path byte-for-byte.
    x_on_device = isinstance(X, jax.Array)
    if not x_on_device:
        X = np.asarray(X, dtype=np.float32)
    response_id, n_cats = 0, 0
    if response_type == "ordinal":
        codes, y = np.unique(np.asarray(y), return_inverse=True)
        n_cats = len(codes)
        if n_cats < 2:
            raise ValueError("ordinal response needs >= 2 categories")
        response_id = 1
    y = np.asarray(y, dtype=np.float32)
    n, p = X.shape
    bs = int(min(block_size, max(8, p)))
    if group_size > 1:
        group_size = min(group_size, bs)
        bs = ((bs + group_size - 1) // group_size) * group_size  # bs | K groups
    p_pad = ((p + bs - 1) // bs) * bs
    if indicator_update == "pallas" and not indicator:
        group_size = 0  # the kernel is the indicator models' draw
    pallas_groups = _block_kernel_on(indicator_update, indicator, group_size, p_pad)
    if x_on_device:
        # Alias, don't copy, when no padding is needed: at 10k x 100k the
        # panel is 4.1 GB and a gratuitous pad-by-zero copy is the
        # difference between fitting HBM and RESOURCE_EXHAUSTED.
        Xf = X if X.dtype == jnp.float32 else X.astype(jnp.float32)
        Xp = Xf if p_pad == p else jnp.pad(Xf, ((0, 0), (0, p_pad - p)))
        # Same ddof=0 column-variance sum as the host path's np.var.
        ms_x = float(
            jax.jit(lambda A: jnp.sum(jnp.var(A.astype(jnp.float32), axis=0)))(X)
        )
    else:
        # Repeated chains on the same host panel (the standard pattern:
        # parameter sweeps, model comparisons) skip the panel upload.
        # Single-slot, fingerprint-keyed (utils/devcache.py); the cached
        # value is the PADDED device panel.
        fp = (host_fingerprint(X), p_pad)
        Xp = _PANEL_CACHE.get(fp)
        if Xp is None:
            Xh = np.zeros((n, p_pad), dtype=np.float32)
            Xh[:, :p] = X
            Xp = _PANEL_CACHE.put(fp, jnp.asarray(Xh))
        ms_x = float(np.sum(np.var(X, axis=0)))
    valid = np.zeros(p_pad, dtype=np.float32)
    valid[:p] = 1.0

    var_y = 1.0 if response_id == 1 else float(np.var(y, ddof=1))
    ms_x = max(ms_x, 1e-8)
    df_b, df_e = 5.0, 5.0
    pi_in = 0.5 if indicator else 1.0
    S_b0 = var_y * r2 / ms_x * (df_b + 2.0) / pi_in
    # π prior counts: BGLR's informative Beta (counts=10) for BayesB/C; the
    # reference's Turing spec (src/bayes.jl:851-852) uses π ~ Uniform(0,1) =
    # Beta(1,1) for the Lπ/Tπ variants.
    pi_counts = 10.0 if model in ("BayesB", "BayesC") else 2.0
    if model in ("BayesT", "BayesTPi"):
        # Fixed unscaled t prior TDist(1.0) (reference src/bayes.jl:752, :853):
        # df=1 (Cauchy), scale 1, no hyper-scale update.
        df_b, S_b0 = 1.0, 1.0
    S_e0 = var_y * (1.0 - r2) * (df_e + 2.0)
    pinned = fix_sigma_e2 is not None or fix_sigma_b2 is not None
    if pinned and (fix_sigma_e2 is None or fix_sigma_b2 is None):
        raise ValueError("fix_sigma_e2 and fix_sigma_b2 must be set together")
    hyper = {
        "df_b": jnp.float32(df_b),
        "S_b0": jnp.float32(S_b0),
        "df_e": jnp.float32(df_e),
        "S_e0": jnp.float32(S_e0),
        "pi_in": jnp.float32(pi_in),
        "pi_counts": jnp.float32(pi_counts),
        "lam2_0": jnp.float32(2.0 * (1.0 - r2) / r2 * ms_x / max(p, 1)),
    }
    if pinned:
        hyper["fix_e"] = jnp.float32(fix_sigma_e2)
        hyper["fix_b"] = jnp.float32(fix_sigma_b2)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_chains)
    run = partial(
        _gibbs_chain,
        jnp.asarray(Xp),
        jnp.asarray(y),
        jnp.asarray(valid),
        hyper=hyper,
        model_id=_MODEL_IDS[model],
        n_iter=int(n_iter),
        n_burnin=int(n_burnin),
        block_size=bs,
        n_blocks=p_pad // bs,
        response_id=response_id,
        n_cats=n_cats,
        pinned=pinned,
        group_size=group_size,
        pallas_groups=pallas_groups,
    )
    if n_chains == 1:
        if chunk_size is not None and chunk_size < n_iter:
            state = None
            done = 0
            traces = []
            if checkpoint_path is not None:
                from ..utils.checkpoint import load_state as _load

                snap = _load(checkpoint_path)
                if snap is not None:
                    done = int(snap.pop("__done__"))
                    state = tuple(
                        jnp.asarray(snap[f"s{i}"]) for i in range(len(snap))
                    )
            mu_hat = b_hat = None
            b_traces = []
            while done < n_iter:
                seg = int(min(chunk_size, n_iter - done))
                iters = jnp.arange(done, done + seg)
                mu_hat, b_hat, tr, state = run(
                    keys[0], iters=iters, state_in=state, return_state=True
                )
                done += seg
                traces.append(np.asarray(tr[0], dtype=np.float64))
                b_traces.append(np.asarray(tr[1], dtype=np.float64))
                if checkpoint_path is not None:
                    from ..utils.checkpoint import save_state as _save

                    snap = {f"s{i}": np.asarray(v) for i, v in enumerate(state)}
                    snap["__done__"] = np.asarray(done)
                    _save(checkpoint_path, snap)
            sig_trace = np.concatenate(traces)
            b_trace = np.concatenate(b_traces, axis=0)
        else:
            mu_hat, b_hat, (sig_trace, b_trace) = run(keys[0])
        mu_hat = float(mu_hat)
        b_hat = np.asarray(b_hat[:p], dtype=np.float64)
    else:
        mus, bs_, (sig_trace, b_trace) = jax.vmap(run)(keys)
        mu_hat = float(jnp.mean(mus))
        b_hat = np.asarray(jnp.mean(bs_, axis=0)[:p], dtype=np.float64)
    from ..utils.diagnostics import ess, mcmc_diagnostics

    traces = np.atleast_2d(np.asarray(sig_trace, dtype=np.float64))  # (m, T)
    post = traces[:, n_burnin:] if traces.shape[1] > n_burnin else traces
    diag = {"sigma_e2_trace": traces[0]}
    diag.update(mcmc_diagnostics(post, name="sigma_e2"))
    # Effect-probe mixing: mean ESS over the 8 traced marker effects
    # ((m, T, 8) from vmapped chains, (T, 8) otherwise) — the denominator of
    # the bench's ESS/s line, measuring mixing per wall-clock rather than
    # raw sweeps/s.
    bt = np.asarray(b_trace, dtype=np.float64)
    if bt.ndim == 2:
        bt = bt[None]
    bt_post = bt[:, n_burnin:, :] if bt.shape[1] > n_burnin else bt
    diag["ess_effects_mean"] = float(
        np.mean([ess(bt_post[:, :, j]) for j in range(bt_post.shape[2])])
    )
    return mu_hat, b_hat, diag


def gibbs_cv_folds(
    X,
    y,
    fold_masks,
    model: str = "BayesC",
    n_iter: int = None,
    n_burnin: int = None,
    seed: int = 42,
    block_size: int = None,
    r2: float = 0.5,
    fix_sigma_e2: Optional[float] = None,
    fix_sigma_b2: Optional[float] = None,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fold-batched Bayesian CV: F independent chains, one per {0,1} training
    row mask, vmapped into ONE XLA program — on one device, or with the fold
    axis partitioned over `mesh`'s first axis (each device vmaps its local
    folds; X/y ride along replicated, zero cross-device traffic during the
    sweep).

    Each chain is the EXACT Gibbs sampler on its fold's training subset —
    masked rows of the centered panel are zero (they contribute nothing to
    Xᵀr, the block Grams, or the residual), and the entry count n is
    replaced by n_eff = Σmask in the intercept draw, the residual χ² degrees
    of freedom, and the inits. This replaces per-fold executor jobs with one
    batched program (cv/batched.py dispatches the Bayesian zoo through it);
    the reference refits its sampler per fold in a Julia thread, each fit a
    fresh Rscript+BGLR subprocess (src/cross_validation.jl:159-185,
    src/bayes.jl:92-93).

    Hyperparameters (BGLR R2-based scalings) are computed once from the full
    panel rather than per fold — folds see ~ (1-1/k) of the data, so the
    weakly-informative prior scales differ negligibly. Gaussian responses
    only. The indicator draw follows `mcmc_indicator_update` as in
    `gibbs_regression`: on a GPU "auto" runs the Pallas block kernel, one
    kernel program per fold. Returns (mu_hat (F,), b_hat (F, p))."""
    from ..utils.config import get_config

    if model not in _MODEL_IDS:
        raise ValueError(f"unknown Bayesian model {model!r}; choose from {BAYESIAN_MODELS}")
    cfg = get_config()
    n_iter = cfg.mcmc_n_iter if n_iter is None else n_iter
    n_burnin = cfg.mcmc_n_burnin if n_burnin is None else n_burnin
    block_size = cfg.mcmc_block_size if block_size is None else block_size
    X = np.asarray(X, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    masks = np.asarray(fold_masks, dtype=np.float32)
    if masks.ndim != 2 or masks.shape[1] != X.shape[0]:
        raise ValueError(f"fold_masks must be (F, n={X.shape[0]}); got {masks.shape}")
    if np.any(masks.sum(axis=1) < 2):
        raise ValueError("every fold needs >= 2 training rows")
    n, p = X.shape
    bs = int(min(block_size, max(8, p)))
    group_size = int(cfg.mcmc_group_size)
    indicator = model in _INDICATOR_MODELS
    mode = cfg.mcmc_indicator_update
    if mode == "pallas" and not indicator:
        mode = "scalar"  # as in gibbs_regression: the kernel is the indicator draw
    if (indicator or model == "BL") and mode != "scalar" and group_size > 1:
        group_size = min(group_size, bs)
        bs = ((bs + group_size - 1) // group_size) * group_size
    else:
        group_size = 0
    p_pad = ((p + bs - 1) // bs) * bs
    F = masks.shape[0]
    # One decision for both dispatch paths (F is the global fold count), so
    # the mesh and single-device chains make the same draws.
    pallas_groups = _block_kernel_on(mode, indicator, group_size, p_pad, batch=F)
    # Same single-slot padded-panel cache as gibbs_regression: the Bayesian
    # CV zoo runs several models back-to-back on one panel, and only the
    # first pays the upload.
    fp = (host_fingerprint(X), p_pad)
    Xp = _PANEL_CACHE.get(fp)
    if Xp is None:
        Xh = np.zeros((n, p_pad), dtype=np.float32)
        Xh[:, :p] = X
        Xp = _PANEL_CACHE.put(fp, jnp.asarray(Xh))
    valid = np.zeros(p_pad, dtype=np.float32)
    valid[:p] = 1.0

    var_y = float(np.var(y, ddof=1))
    ms_x = max(float(np.sum(np.var(X, axis=0))), 1e-8)
    df_b, df_e = 5.0, 5.0
    pi_in = 0.5 if indicator else 1.0
    S_b0 = var_y * r2 / ms_x * (df_b + 2.0) / pi_in
    if model in ("BayesT", "BayesTPi"):
        df_b, S_b0 = 1.0, 1.0
    pinned = fix_sigma_e2 is not None or fix_sigma_b2 is not None
    if pinned and (fix_sigma_e2 is None or fix_sigma_b2 is None):
        raise ValueError("fix_sigma_e2 and fix_sigma_b2 must be set together")
    hyper = {
        "df_b": jnp.float32(df_b),
        "S_b0": jnp.float32(S_b0),
        "df_e": jnp.float32(df_e),
        "S_e0": jnp.float32(var_y * (1.0 - r2) * (df_e + 2.0)),
        "pi_in": jnp.float32(pi_in),
        "pi_counts": jnp.float32(10.0 if model in ("BayesB", "BayesC") else 2.0),
        "lam2_0": jnp.float32(2.0 * (1.0 - r2) / r2 * ms_x / max(p, 1)),
    }
    if pinned:
        hyper["fix_e"] = jnp.float32(fix_sigma_e2)
        hyper["fix_b"] = jnp.float32(fix_sigma_b2)
    keys = jax.random.split(jax.random.PRNGKey(seed), masks.shape[0])
    run = partial(
        _gibbs_chain,
        hyper=hyper,
        model_id=_MODEL_IDS[model],
        n_iter=int(n_iter),
        n_burnin=int(n_burnin),
        block_size=bs,
        n_blocks=p_pad // bs,
        pinned=pinned,
        group_size=group_size,
        pallas_groups=pallas_groups,
    )

    def fold_batch(keys_b, masks_b, vary_axes=()):
        # batch_hint gates the sweep-hoisted group tables on TOTAL resident
        # memory. Both dispatch paths gate on the global F (the mesh path
        # holds only Fp//D ≤ F chains per device, so F is conservative there)
        # so the hoist decision — hence the exact arithmetic order of the
        # draws — is identical between mesh and single-device dispatch,
        # keeping the mesh-identity guarantee independent of problem size.
        return jax.vmap(
            lambda key, mask: run(
                jnp.asarray(Xp), jnp.asarray(y), jnp.asarray(valid), key,
                row_mask=mask, vary_axes=vary_axes, batch_hint=int(F),
            )
        )(keys_b, masks_b)[:2]
    # Shard folds over the LARGEST mesh axis: the canonical ('dp','mp') mesh
    # often has dp=1, and sharding over a size-1 axis would silently run every
    # fold replicated on every device (ties break to the first axis in mesh
    # order).
    if mesh is not None and int(np.prod(list(mesh.shape.values()))) > 1:
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        axis = max(mesh.shape, key=lambda a: mesh.shape[a])
        D = mesh.shape[axis]
        Fp = ((F + D - 1) // D) * D
        if Fp != F:  # pad with all-training dummy folds; results discarded.
            # Folds 0..F-1 MUST keep the keys the single-device path would
            # give them (same posterior either way, but the mesh dispatch
            # must not silently change the draws) — append fresh keys for the
            # dummies instead of re-splitting to Fp.
            masks = np.concatenate([masks, np.ones((Fp - F, n), np.float32)])
            pad_keys = jax.random.split(
                jax.random.fold_in(jax.random.PRNGKey(seed), 0x70AD), Fp - F
            )
            keys = jnp.concatenate([keys, pad_keys])
        mus, bs_ = shard_map(
            partial(fold_batch, vary_axes=(axis,)), mesh=mesh,
            in_specs=(P(axis), P(axis)),
            out_specs=(P(axis), P(axis)),
        )(keys, jnp.asarray(masks))
        mus, bs_ = mus[:F], bs_[:F]
    else:
        mus, bs_ = fold_batch(keys, jnp.asarray(masks))
    return (
        np.asarray(mus, dtype=np.float64),
        np.asarray(bs_, dtype=np.float64)[:, :p],
    )


def bglr(
    G: np.ndarray,
    y: np.ndarray,
    model: str = "BayesA",
    response_type: str = "gaussian",
    n_iter: int = None,
    n_burnin: int = None,
    seed: int = 42,
    verbose: bool = False,
) -> np.ndarray:
    """Low-level sampler entry point, name/shape-compatible with the
    reference's `bglr` (src/bayes.jl:28-105): takes a marker matrix G and
    response y, returns b_hat = [mu; marker effects].

    The reference writes temp TSVs and shells out to `Rscript`+BGLR here;
    this implementation runs the native blocked Gibbs sampler as one XLA
    program on-device — no subprocess, no files.
    """
    mu_hat, b_marker, _ = gibbs_regression(
        np.asarray(G, dtype=np.float64), np.asarray(y, dtype=np.float64),
        model=model, n_iter=n_iter, n_burnin=n_burnin, seed=seed,
        response_type=response_type,
    )
    return np.concatenate([[mu_hat], b_marker])


def bayesian(
    bglr_model: str,
    genomes: Genomes,
    phenomes: Phenomes,
    idx_entries: Optional[Sequence[int]] = None,
    idx_loci_alleles: Optional[Sequence[int]] = None,
    idx_trait: int = 0,
    response_type: str = "gaussian",
    n_burnin: int = None,
    n_iter: int = None,
    seed: int = 42,
    n_chains: int = 1,
    verbose: bool = False,
) -> Fit:
    """Fit a Bayesian-alphabet model (reference `bayesian`, src/bayes.jl:161-228).

    The reference shells out to R/BGLR here; we run the native sampler.
    `response_type="ordinal"` runs the native Albert-Chib probit sampler
    (predictions are latent liabilities).
    """
    X, y, entries, populations, loci_alleles = extractxyetc(
        genomes, phenomes, idx_entries=idx_entries, idx_loci_alleles=idx_loci_alleles,
        idx_trait=idx_trait, add_intercept=True,
    )
    G = X[:, 1:]
    mu_hat, b_marker, _ = gibbs_regression(
        G, y, model=bglr_model, n_iter=n_iter, n_burnin=n_burnin, seed=seed, n_chains=n_chains,
        response_type=response_type,
    )
    b_hat = np.concatenate([[mu_hat], b_marker])
    y_pred = X @ b_hat
    fit = Fit(
        model=bglr_model,
        b_hat=b_hat,
        b_hat_labels=np.concatenate([np.asarray(["intercept"], dtype=object), loci_alleles]),
        trait=str(phenomes.traits[idx_trait]),
        entries=entries,
        populations=populations,
        y_true=y,
        y_pred=y_pred,
        metrics=metrics(y, y_pred),
    )
    if not fit.checkdims():
        raise RuntimeError(f"error fitting {bglr_model}")
    return fit


def _alphabet(model_key: str, public_name: str):
    def f(
        genomes: Genomes,
        phenomes: Phenomes,
        idx_entries=None,
        idx_loci_alleles=None,
        idx_trait: int = 0,
        n_iter: int = None,
        n_burnin: int = None,
        seed: int = 42,
        n_chains: int = 1,
        verbose: bool = False,
    ) -> Fit:
        fit = bayesian(
            model_key,
            genomes=genomes,
            phenomes=phenomes,
            idx_entries=idx_entries,
            idx_loci_alleles=idx_loci_alleles,
            idx_trait=idx_trait,
            n_iter=n_iter,
            n_burnin=n_burnin,
            seed=seed,
            n_chains=n_chains,
            verbose=verbose,
        )
        fit.model = public_name
        return fit

    f.__name__ = public_name
    f.__qualname__ = public_name
    f.__doc__ = (
        f"Fit {model_key} via the native blocked Gibbs sampler "
        f"(reference wrapper at src/linear.jl:440-626)."
    )
    return f


bayesa = _alphabet("BayesA", "bayesa")
bayesb = _alphabet("BayesB", "bayesb")
bayesc = _alphabet("BayesC", "bayesc")
bayesian_ridge = _alphabet("BRR", "bayesian_ridge")
bayesian_lasso = _alphabet("BL", "bayesian_lasso")
# The reference documents (as commented-out Turing models, src/bayes.jl:
# 510-855) a wider prior taxonomy: Laplace and t priors each with an optional
# point mass at zero. Implemented natively here.
bayesian_lasso_pi = _alphabet("BLPi", "bayesian_lasso_pi")
bayest = _alphabet("BayesT", "bayest")
bayestpi = _alphabet("BayesTPi", "bayestpi")
