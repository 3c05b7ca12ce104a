"""Blocked Cholesky + blocked triangular solves for the GBLUP hot path.

XLA's native `jnp.linalg.cholesky` + `cho_solve` run the two triangular
solves as sequential trsv recurrences, which expose little parallelism. This
module restructures both so the flops live in big GEMMs:

- `blocked_cholesky`: left-looking panel factorization. Panel j's update is
  two GEMMs against all previous panels ((n-lo) x lo x b), the diagonal block
  factors with the native kernel at b x b (cheap), and the sub-diagonal panel
  is formed as `Aij @ inv(Ljj)ᵀ` (one more GEMM; the b x b triangular inverse
  is one small trsm).
- `blocked_cho_solve`: forward/backward substitution one panel at a time —
  nb small (b x b) GEMVs plus rank-b updates instead of 2n scalar-recurrence
  steps.
- `gblup_solve_lower`: the fused GBLUP solve used by bench.py: consumes a
  LOWER-TRIANGLE-ONLY matrix (the upper triangle is never read — diagonal
  blocks are symmetrized internally), so Gram builders can skip the cosmetic
  mirror pass entirely (see ops/grm.py:gram_dosage_lower).

Replaces the reference's LAPACK solve under `X \\ y` / mixed-model solves
(reference src/linear.jl:85) on the device path. Whether it beats cuSOLVER
through `jnp.linalg.cholesky` on the GPU is not measured yet.
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "blocked_cholesky",
    "blocked_cho_solve",
    "gblup_solve_lower",
]


def _sym_lower(B: jnp.ndarray) -> jnp.ndarray:
    """Mirror the lower triangle of a small square block onto the upper."""
    lo = jnp.tril(B)
    return lo + jnp.tril(B, -1).T


def _chol_panels(A: jnp.ndarray, nb: int) -> Tuple[List[jnp.ndarray], List[jnp.ndarray]]:
    """Left-looking blocked Cholesky. Returns (column panels of L, inverse
    diagonal blocks). Only the lower triangle of A is read."""
    n = A.shape[0]
    b = -(-n // nb)
    cols: List[jnp.ndarray] = []
    invs: List[jnp.ndarray] = []
    lo = 0
    while lo < n:
        hi = min(lo + b, n)
        w = hi - lo
        Ajj = _sym_lower(A[lo:hi, lo:hi])
        Aij = A[hi:, lo:hi]
        for j, Lp in enumerate(cols):
            Ljp = Lp[lo:hi]
            Ajj = Ajj - jnp.dot(Ljp, Ljp.T, preferred_element_type=A.dtype)
            if hi < n:
                Aij = Aij - jnp.dot(Lp[hi:], Ljp.T, preferred_element_type=A.dtype)
        Ljj = jnp.linalg.cholesky(Ajj)
        inv_Ljj = jax.scipy.linalg.solve_triangular(
            Ljj, jnp.eye(w, dtype=A.dtype), lower=True
        )
        if hi < n:
            Lij = jnp.dot(Aij, inv_Ljj.T, preferred_element_type=A.dtype)
            panel = jnp.concatenate([jnp.zeros((lo, w), A.dtype), Ljj, Lij], axis=0)
        else:
            panel = jnp.concatenate([jnp.zeros((lo, w), A.dtype), Ljj], axis=0)
        cols.append(panel)
        invs.append(inv_Ljj)
        lo = hi
    return cols, invs


def _solve_panels(
    cols: List[jnp.ndarray], invs: List[jnp.ndarray], y: jnp.ndarray
) -> jnp.ndarray:
    """Solve L Lᵀ x = y from the panel representation."""
    n = y.shape[0]
    bounds = []
    lo = 0
    for inv in invs:
        hi = lo + inv.shape[0]
        bounds.append((lo, hi))
        lo = hi
    # forward: L z = y
    rhs = y
    zs = []
    for (lo, hi), panel, inv in zip(bounds, cols, invs):
        zj = inv @ rhs[lo:hi]
        zs.append(zj)
        if hi < n:
            rhs = rhs.at[hi:].add(-(panel[hi:] @ zj))
    z = jnp.concatenate(zs)
    # backward: Lᵀ x = z; row block r needs columns j > r of Lᵀ, i.e. the
    # below-diagonal rows of panel r against already-solved x_j.
    xs: List[jnp.ndarray] = [None] * len(bounds)  # type: ignore[list-item]
    for r in reversed(range(len(bounds))):
        lo_r, hi_r = bounds[r]
        acc = z[lo_r:hi_r]
        for j in range(r + 1, len(bounds)):
            lo_j, hi_j = bounds[j]
            acc = acc - cols[r][lo_j:hi_j].T @ xs[j]
        xs[r] = invs[r].T @ acc
    return jnp.concatenate(xs)


@partial(jax.jit, static_argnames=("nb",))
def blocked_cholesky(A: jnp.ndarray, nb: int = 16) -> jnp.ndarray:
    """Lower Cholesky factor of (the lower triangle of) a PSD matrix.

    Equivalent to `jnp.linalg.cholesky` but restructured into ~nb panel
    GEMMs; only A's lower triangle is read.

    Conditioning caveat: the substitution phases apply explicit inverses of
    the diagonal blocks by GEMM instead of triangular solves,
    which loses accuracy on ill-conditioned A — roughly a factor of
    κ(block)² vs κ(block) in the local error term. Intended for
    well-conditioned mixed-model systems like K + λI with λ well above the
    noise floor; for κ(A) ≳ 1e6 prefer `jax.scipy.linalg.cho_solve`.
    """
    cols, _ = _chol_panels(A, int(nb))
    return jnp.concatenate(cols, axis=1)


@partial(jax.jit, static_argnames=("nb",))
def blocked_cho_solve(A: jnp.ndarray, y: jnp.ndarray, nb: int = 16) -> jnp.ndarray:
    """Solve A x = y for PSD A (lower triangle read) via blocked Cholesky.

    Shares `blocked_cholesky`'s conditioning caveat: diagonal-block inverses
    are applied by GEMM, so accuracy degrades on ill-conditioned A (use
    `cho_solve` beyond κ ≈ 1e6). Ideal for K + λI mixed-model systems."""
    cols, invs = _chol_panels(A, int(nb))
    return _solve_panels(cols, invs, y)


@partial(jax.jit, static_argnames=("nb",))
def gblup_solve_lower(
    K_lower: jnp.ndarray, y: jnp.ndarray, lam: jnp.ndarray, nb: int = 16
) -> jnp.ndarray:
    """GEBV from a lower-triangle-only centered Gram: solves
    (K + lam I) alpha = (y - mean(y)) and returns K alpha + mean(y)
    (= yc - lam*alpha + mean — no n x n matvec needed)."""
    n = K_lower.shape[0]
    yc = y - jnp.mean(y)
    A = K_lower + lam * jnp.eye(n, dtype=K_lower.dtype)
    alpha = blocked_cho_solve(A, yc, nb=nb)
    return yc - lam * alpha + jnp.mean(y)
