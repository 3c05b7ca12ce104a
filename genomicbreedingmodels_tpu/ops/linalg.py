"""Core linear-algebra ops for the model zoo (XLA replacements for the
reference's native backends).

- `lstsq_minnorm`: replaces LAPACK `X \\ y` (reference src/linear.jl:85). For
  wide panels (p >> n) it solves the dual n x n system, so cost is O(n²p + n³)
  instead of a QR on the full matrix.
- `ridge_cv_path`: replaces Fortran glmnet with alpha=0 (reference
  src/linear.jl:193-221). Per CV fold one n x n eigendecomposition of the
  masked Gram matrix; the entire 100-point λ path is then a single batched
  matmul — no iterative solver at all.
- `lasso_cv_path`: replaces glmnet coordinate descent with alpha=1 (reference
  src/linear.jl:333-360). Pathwise FISTA where ALL λ values and ALL folds are
  advanced simultaneously as one (fold, λ) batch of GEMMs — the iteration
  count is static so XLA compiles a single fused loop of GEMMs.

λ selection mirrors the reference's behavior: candidates sorted by CV mean
loss, first one whose coefficient variance exceeds 1e-10 wins (reference
src/linear.jl:212-221, :352-360). Divergence: the reference's ridge variant
indexes an *unsorted* intercept path with sorted indices (a bug at
src/linear.jl:214-219); we compute the intercept consistently with the chosen
β instead.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "affine_predict",
    "lstsq_minnorm",
    "ridge_cv_path",
    "lasso_cv_path",
    "make_lambda_grid",
    "make_fold_masks",
]

Array = jnp.ndarray


@jax.jit
def _affine_predict(G: Array, idx_e: Array, idx_l: Array, b0: Array, b: Array) -> Array:
    sub = G[idx_e][:, idx_l].astype(jnp.float32)
    return b0 + jnp.dot(sub, b.astype(jnp.float32), preferred_element_type=jnp.float32)


def affine_predict(G, idx_e, idx_l, b0: float, b) -> np.ndarray:
    """ŷ = b0 + G[idx_e, idx_l] @ b as one device GEMV."""
    out = _affine_predict(
        jnp.asarray(G, dtype=jnp.float32),
        jnp.asarray(idx_e),
        jnp.asarray(idx_l),
        jnp.float32(b0),
        jnp.asarray(b),
    )
    return np.asarray(out, dtype=np.float64)


# ---------------------------------------------------------------------------
# OLS (min-norm least squares via the dual system)
# ---------------------------------------------------------------------------


@jax.jit
def _lstsq_dual(X: Array, y: Array) -> Array:
    # b = Xᵀ (X Xᵀ)⁺ y  — the minimum-norm solution for wide X.
    K = jnp.dot(X, X.T, preferred_element_type=jnp.float32)
    s, U = jnp.linalg.eigh(K)
    tol = jnp.maximum(s[-1], 0.0) * K.shape[0] * jnp.finfo(jnp.float32).eps
    inv_s = jnp.where(s > tol, 1.0 / s, 0.0)
    alpha = U @ (inv_s * (U.T @ y))
    return jnp.dot(X.T, alpha, preferred_element_type=jnp.float32)


@jax.jit
def _lstsq_primal(X: Array, y: Array) -> Array:
    return jnp.linalg.lstsq(X, y)[0]


def lstsq_minnorm(X, y) -> np.ndarray:
    """Min-norm least-squares solution (replaces `X \\ y`, src/linear.jl:85).

    Note: for underdetermined systems Julia's `\\` returns a pivoted-QR basic
    solution; both interpolate the training data identically, so fitted values
    and all downstream metrics agree. We return the min-norm solution, which
    is the natural SVD/eigh formulation on an accelerator.
    """
    X = jnp.asarray(X, dtype=jnp.float32)
    y = jnp.asarray(y, dtype=jnp.float32)
    n, p = X.shape
    if p > n:
        b = _lstsq_dual(X, y)
    else:
        b = _lstsq_primal(X, y)
    return np.asarray(b, dtype=np.float64)


# ---------------------------------------------------------------------------
# Shared λ-path utilities
# ---------------------------------------------------------------------------


def make_lambda_grid(X, y, n_lambda: int = 100, lambda_min_ratio: float = 0.01, alpha: float = 1.0) -> np.ndarray:
    """glmnet-style log-spaced λ grid.

    λ_max = max_j |⟨x_j - x̄_j, y - ȳ⟩| / (n * max(alpha, 1e-3)); for ridge
    (alpha=0) glmnet uses the same 1e-3 floor.
    """
    n = X.shape[0]
    # ⟨x_j - x̄_j, y - ȳ⟩ = x_jᵀ(y - ȳ) since Σ(y - ȳ) = 0: no centered panel
    # copy needed — one GEMV (on device when X already lives there).
    if isinstance(X, jnp.ndarray):
        yc = jnp.asarray(y, X.dtype) - jnp.mean(jnp.asarray(y, X.dtype))
        lam_max = float(jnp.max(jnp.abs(jnp.dot(yc, X, preferred_element_type=jnp.float32))))
    else:
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        yc = y - y.mean()
        lam_max = float(np.max(np.abs(yc @ X)))
    lam_max = max(lam_max / (n * max(alpha, 1e-3)), 1e-12)
    return np.logspace(np.log10(lam_max), np.log10(lam_max * lambda_min_ratio), n_lambda)


def make_fold_masks(n: int, n_folds: int, seed: int = 42) -> np.ndarray:
    """(k, n) boolean masks; mask[f, i] True when row i is in TRAINING for fold f."""
    rng = np.random.default_rng(seed)
    fold_id = rng.permutation(n) % n_folds
    return np.stack([fold_id != f for f in range(n_folds)]).astype(np.float32)


# ---------------------------------------------------------------------------
# Ridge: masked dual solves, whole λ path per fold in one batched matmul
# ---------------------------------------------------------------------------


@jax.jit
def _gram_and_stats(X: Array):
    """Raw Gram + column sums: the one O(n²p) pass shared by all CV folds.

    bf16 operands on the panel syrk schedule (ops/grm.py) — the same
    precision policy as the GRM hot path. Masked/centered per-fold Grams derive from
    the raw Gram in O(n²): with m = fold-training column means and
    M = diag(w),
      (M (X - 1 mᵀ)) (M (X - 1 mᵀ))ᵀ = M (G - X m 1ᵀ - 1 mᵀ Xᵀ + (m·m) 11ᵀ) M.
    """
    from .grm import gram_panel

    G = gram_panel(X.astype(jnp.bfloat16), center=False)
    return G, X


@jax.jit
def _ridge_fold_losses_fromgram(G: Array, X: Array, y: Array, w: Array, lambdas: Array):
    """Validation squared-error sums for one fold across all λ, derived from
    the shared raw Gram (no per-fold O(n²p) GEMM).

    w is the {0,1} training mask. Centering uses training-row means (glmnet
    fits an unpenalized intercept). The masked Gram is eigendecomposed once;
    every λ shares the basis.
    """
    n_tr = jnp.sum(w)
    mean_y = jnp.sum(w * y) / n_tr
    mean_x = jnp.sum(w[:, None] * X, axis=0) / n_tr  # O(np), cheap vs O(n²p)
    Xm = jnp.dot(X, mean_x, preferred_element_type=jnp.float32)  # (n,)
    mm = jnp.dot(mean_x, mean_x)
    Gc = G - Xm[:, None] - Xm[None, :] + mm  # centered Gram Z Zᵀ
    yc = y - mean_y
    K = Gc * w[:, None] * w[None, :]
    s, U = jnp.linalg.eigh(K)
    s = jnp.maximum(s, 0.0)
    Ut_wy = U.T @ (w * yc)
    # gamma[:, l] = U diag(1/(s + n_tr*λ_l)) Uᵀ (w yc)
    denom = s[:, None] + n_tr * lambdas[None, :]
    gamma = U @ (Ut_wy[:, None] / denom)  # (n, L)
    # ŷ = mean_y + Z Zᵀ diag(w) gamma = Gc (w ⊙ gamma)
    preds = mean_y + Gc @ (w[:, None] * gamma)  # (n, L)
    val = 1.0 - w
    err = (y[:, None] - preds) ** 2 * val[:, None]
    return jnp.sum(err, axis=0), jnp.sum(val)


_ridge_folds_batch = jax.jit(
    jax.vmap(_ridge_fold_losses_fromgram, in_axes=(None, None, None, 0, None))
)


@jax.jit
def _ridge_full_eigh(X: Array, y: Array):
    """Full-data centered-Gram eigendecomposition, shared across all λ."""
    from .grm import gram_panel

    mean_y = jnp.mean(y)
    mean_x = jnp.mean(X, axis=0)
    Z = X - mean_x[None, :]
    yc = y - mean_y
    K = gram_panel(X.astype(jnp.bfloat16))  # centered raw-Gram (P G P)
    s, U = jnp.linalg.eigh(K)
    return jnp.maximum(s, 0.0), U, U.T @ yc, Z, mean_x, mean_y


@jax.jit
def _ridge_beta_from_eigh(s, U, Ut_yc, Z, mean_x, mean_y, lam: Array) -> Tuple[Array, Array]:
    """Ridge coefficients at one λ from the cached eigenbasis (O(n² + np))."""
    n = Z.shape[0]
    gamma = U @ (Ut_yc / (s + n * lam))
    beta = jnp.dot(Z.T, gamma, preferred_element_type=jnp.float32)
    b0 = mean_y - jnp.dot(mean_x, beta)
    return b0, beta


def ridge_cv_path(
    X,
    y,
    n_lambda: int = None,
    lambda_min_ratio: float = None,
    n_folds: int = None,
    seed: int = 42,
) -> Tuple[float, np.ndarray, dict]:
    """k-fold CV over a ridge λ path; glmnetcv-equivalent selection.

    Path defaults (n_lambda=100, lambda_min_ratio=0.01, n_folds=10 — the
    glmnet values the reference passes, src/linear.jl:193-203) come from
    GBMConfig and are overridable via GBM_N_LAMBDA / GBM_LAMBDA_MIN_RATIO /
    GBM_PATH_CV_FOLDS env vars. Returns (b0, beta, info) where info carries
    the λ grid, CV mean losses and the chosen index.
    """
    from ..utils.config import get_config

    cfg = get_config()
    n_lambda = cfg.n_lambda if n_lambda is None else n_lambda
    lambda_min_ratio = cfg.lambda_min_ratio if lambda_min_ratio is None else lambda_min_ratio
    n_folds = cfg.path_cv_folds if n_folds is None else n_folds
    X = jnp.asarray(X, dtype=jnp.float32)
    y = jnp.asarray(y, dtype=jnp.float32)
    n = X.shape[0]
    n_folds = int(min(n_folds, n))
    lambdas = jnp.asarray(make_lambda_grid(X, y, n_lambda, lambda_min_ratio, alpha=0.0), dtype=jnp.float32)
    masks = make_fold_masks(n, n_folds, seed)
    # One O(n²p) Gram + ONE batched device call for all folds × all λ.
    G, Xj = _gram_and_stats(X)
    se, nv = _ridge_folds_batch(G, Xj, y, jnp.asarray(masks), lambdas)
    meanloss = np.asarray(jnp.sum(se, axis=0), dtype=np.float64) / max(float(jnp.sum(nv)), 1.0)
    order = np.argsort(meanloss, kind="stable")
    b0, beta = 0.0, np.zeros(X.shape[1])
    chosen = int(order[0])
    eig = _ridge_full_eigh(X, y)
    for i in order:
        b0_i, beta_i = _ridge_beta_from_eigh(*eig, jnp.float32(float(lambdas[i])))
        beta_np = np.asarray(beta_i, dtype=np.float64)
        if np.var(beta_np, ddof=1) > 1e-10 or i == order[-1]:
            b0, beta, chosen = float(b0_i), beta_np, int(i)
            break
    info = {"lambdas": np.asarray(lambdas, dtype=np.float64), "meanloss": meanloss, "chosen": chosen}
    return b0, beta, info


# ---------------------------------------------------------------------------
# LASSO: batched pathwise FISTA over (fold, λ)
# ---------------------------------------------------------------------------


def _soft_threshold(x: Array, t: Array) -> Array:
    return jnp.sign(x) * jnp.maximum(jnp.abs(x) - t, 0.0)


@partial(jax.jit, static_argnames=("n_iter",))
def _lasso_fista_batch(Z: Array, yc: Array, w: Array, lambdas: Array, step: Array, n_iter: int) -> Array:
    """FISTA for (1/2n)‖M(yc - Z b)‖² + λ‖b‖₁, all λ in one batch.

    Z: (n, p) centered design; yc: (n,) centered response; w: (n,) row mask
    (all-ones for the full-data path). Returns B: (p, L). The two GEMMs per
    iteration run on bf16 operands with f32 accumulation (tensor-core rate; the
    iterate/soft-threshold state stays f32, so this is standard
    mixed-precision proximal gradient).
    """
    n_tr = jnp.sum(w)
    L = lambdas.shape[0]
    p = Z.shape[1]
    Zw32 = w[:, None] * Z
    Zw16 = Zw32.astype(jnp.bfloat16)
    ywc = w * yc

    def _body(Zw_lo, cast):
        def body(_, carry):
            B, V, tk = carry
            R = jnp.dot(Zw_lo, cast(V), preferred_element_type=jnp.float32) - ywc[:, None]
            grad = jnp.dot(Zw_lo.T, cast(R), preferred_element_type=jnp.float32) / n_tr
            B_new = _soft_threshold(V - step * grad, step * lambdas[None, :])
            tk_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * tk**2))
            V_new = B_new + ((tk - 1.0) / tk_new) * (B_new - B)
            return B_new, V_new, tk_new

        return body

    # Init derived from the (possibly vmap-batched) design so the fori_loop
    # carry is batched from iteration 0 (carry-type mismatch under vmap).
    B0 = jnp.zeros((p, L), dtype=jnp.float32) + 0.0 * Zw32[0, :, None]
    n_bulk = max(n_iter - max(20, n_iter // 8), 0)
    # Bulk iterations on bf16 operands, then an f32 polish leg (momentum
    # restarted) so the final iterates satisfy the KKT conditions to f32
    # precision rather than stalling at the bf16 gradient noise floor.
    B, _, _ = jax.lax.fori_loop(
        0, n_bulk, _body(Zw16, lambda a: a.astype(jnp.bfloat16)), (B0, B0, jnp.float32(1.0))
    )
    B, _, _ = jax.lax.fori_loop(
        0, n_iter - n_bulk, _body(Zw32, lambda a: a), (B, B, jnp.float32(1.0))
    )
    return B


@jax.jit
def _power_iter_lmax(Z: Array) -> Array:
    """Largest eigenvalue of ZᵀZ via 30 power iterations on the n x n Gram."""
    K = jnp.dot(Z, Z.T, preferred_element_type=jnp.float32)
    # Init derived from K (not a fresh constant) so the fori_loop carry is
    # already batched when this runs under vmap (batched-K carry mismatch).
    v = (K[:, 0] * 0.0 + 1.0) / jnp.sqrt(jnp.float32(K.shape[0]))

    def body(_, v):
        v = K @ v
        return v / jnp.maximum(jnp.linalg.norm(v), 1e-30)

    v = jax.lax.fori_loop(0, 30, body, v)
    return jnp.dot(v, K @ v)


@jax.jit
def _sis_scores(X: Array, y: Array, w: Array) -> Array:
    """|Z_wᵀ (w yc)| marginal scores for sure-independence screening: one
    GEMV over the full panel."""
    n_tr = jnp.sum(w)
    mean_y = jnp.sum(w * y) / n_tr
    ywc = w * (y - mean_y)
    # ⟨x_j - x̄_j, w yc⟩ = x_jᵀ(w yc) - x̄_j Σ(w yc); Σ(w yc) = 0 by centering.
    return jnp.abs(jnp.dot(ywc, X, preferred_element_type=jnp.float32))


def lasso_cv_path(
    X,
    y,
    n_lambda: int = None,
    lambda_min_ratio: float = None,
    n_folds: int = None,
    seed: int = 42,
    n_iter: int = 400,
    screen_factor: int = 8,
) -> Tuple[float, np.ndarray, dict]:
    """k-fold CV over a LASSO λ path, batched FISTA; glmnetcv-style selection.

    For ultra-wide panels (p > screen_factor · n) each fold first applies
    sure-independence screening (top screen_factor·n markers by marginal
    |Zᵀy| — one GEMV) and runs the path on the screened design: a LASSO
    solution has at most n_tr nonzero coefficients, so the screened set is a
    superset of the active set in all but adversarial LD structures, and the
    dense-FISTA work scales with n instead of p. Set screen_factor=0 to
    disable. Path defaults come from GBMConfig (see ridge_cv_path).
    """
    from ..utils.config import get_config

    cfg = get_config()
    n_lambda = cfg.n_lambda if n_lambda is None else n_lambda
    lambda_min_ratio = cfg.lambda_min_ratio if lambda_min_ratio is None else lambda_min_ratio
    n_folds = cfg.path_cv_folds if n_folds is None else n_folds
    X = jnp.asarray(X, dtype=jnp.float32)
    y = jnp.asarray(y, dtype=jnp.float32)
    n, p = X.shape
    n_folds = int(min(n_folds, n))
    lambdas_np = make_lambda_grid(X, y, n_lambda, lambda_min_ratio, alpha=1.0)
    lambdas = jnp.asarray(lambdas_np, dtype=jnp.float32)
    masks = make_fold_masks(n, n_folds, seed)
    k_screen = p if screen_factor <= 0 else int(min(p, max(1024, screen_factor * n)))
    screened = k_screen < p

    def _fold_path(w):
        n_tr = jnp.sum(w)
        if screened:
            _, idx = jax.lax.top_k(_sis_scores(X, y, w), k_screen)
            Xk = jnp.take(X, idx, axis=1)
        else:
            idx = None
            Xk = X
        mean_y = jnp.sum(w * y) / n_tr
        mean_x = jnp.sum(w[:, None] * Xk, axis=0) / n_tr
        Z = Xk - mean_x[None, :]
        yc = y - mean_y
        step = jnp.float32(1.0) / jnp.maximum(_power_iter_lmax(w[:, None] * Z) / n_tr, 1e-12)
        B = _lasso_fista_batch(Z, yc, w, lambdas, step, n_iter)
        return B, Z, yc, mean_x, mean_y, idx

    sums = np.zeros(n_lambda, dtype=np.float64)
    counts = 0.0
    for f in range(n_folds):
        w = jnp.asarray(masks[f])
        B, Z, yc, _, mean_y, _ = _fold_path(w)
        preds = mean_y + jnp.dot(Z, B, preferred_element_type=jnp.float32)
        val = 1.0 - w
        err = (y[:, None] - preds) ** 2 * val[:, None]
        sums += np.asarray(jnp.sum(err, axis=0), dtype=np.float64)
        counts += float(jnp.sum(val))
    meanloss = sums / max(counts, 1.0)

    # Full-data path at all λ (single batched FISTA), then reference-style pick.
    ones = jnp.ones((n,), dtype=jnp.float32)
    B_full, _, _, mean_x, mean_y, idx_full = _fold_path(ones)
    B_np = np.asarray(B_full, dtype=np.float64)
    order = np.argsort(meanloss, kind="stable")
    # Degenerate fallback: if every λ on the path yields var(β)≤1e-10 the loop below
    # never fires; take the best-CV-loss λ (order[0]), not the worst. The reference
    # (src/linear.jl:352-360) would leave its Fit at the last loop index in this
    # corner — an accident of its loop structure, not a semantic choice; best-loss
    # is the defensible behavior and is only reachable on all-degenerate paths.
    chosen = int(order[0])
    for i in order:
        if np.var(B_np[:, i], ddof=1) > 1e-10:
            chosen = int(i)
            break
    beta_k = B_np[:, chosen]
    if screened:
        beta = np.zeros(p)
        beta[np.asarray(idx_full)] = beta_k
    else:
        beta = beta_k
    b0 = float(mean_y) - float(np.asarray(mean_x, dtype=np.float64) @ beta_k)
    info = {"lambdas": lambdas_np, "meanloss": meanloss, "chosen": chosen,
            "screened_to": k_screen if screened else p}
    return b0, beta, info
