"""Device Gram-matrix ops (GRM hot path).

The (n x p) @ (p x n) Gram product is the single biggest dense-compute item in
the GWAS/GBLUP stack (reference hot spot: GRM build at src/gwas.jl:117-126,
O(n²p)). Three single-device schedules live here, all pure XLA, all exploiting
symmetry so only ~half the FLOPs are executed:

- `gram_panel` (default): right-looking column-panel syrk — panel j is one
  tall ((n - j·b) x b x p) GEMM, so every GEMM has a large M dimension.
- `gram_recursive`: 2x2 recursion, off-diagonal block of each level is one
  big GEMM.
- `gram_triangular`: square row-block tiles, kept for comparison and small
  shapes.

Centering is NEVER done by materializing X - 1μᵀ (a bf16 subtract quantizes
the panel; the copy costs two panel-size HBM passes). Because column-centering
X is the projection P = I - 11ᵀ/n applied on the left, the centered Gram is
K = P (X Xᵀ) P — plain double-centering of the RAW Gram (subtract row/col
means, add back the grand mean): an O(n²) epilogue in f32, no extra panel
traffic, and far more accurate than a bf16 subtract.

The multi-device column-sharded build (psum across devices) lives in
parallel.sharded.

**Dosage panels (the fast path).** Real SNP panels at ploidy k hold allele
frequencies on the exact grid {0, 1/k, ..., 1} (diploid: {0, 0.5, 1}). Encoded
as int8 dosages d = k·x, the raw Gram D Dᵀ accumulates in int32 — EXACTLY
(int32 overflows only past p ≈ 2³¹/k², i.e. >5·10⁸ diploid markers), with a
quarter of the f32 operand bytes. `gram_dosage` runs the same panel-syrk
schedule on int8 operands with zero quantization error (cf. PLINK's 2-bit
genotype codec — here the codec IS the matmul operand). `encode_dosage` validates the grid;
`gram_auto` picks dosage/bf16 automatically.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "center_gram",
    "center_gram_lower",
    "encode_dosage",
    "gram_auto",
    "gram_centered",
    "gram_centered_blocked",
    "gram_centered_device",
    "gram_dosage",
    "gram_dosage_snp_major",
    "gram_dosage_lower",
    "gram_panel",
    "gram_recursive",
    "gram_triangular",
]


def center_gram(G: jnp.ndarray) -> jnp.ndarray:
    """Double-center a raw Gram matrix G = X Xᵀ into the centered Gram
    (X - 1μᵀ)(X - 1μᵀ)ᵀ = P G P, P = I - 11ᵀ/n.

    Exact algebra (no approximation), O(n²), runs entirely in f32 on the
    accumulated Gram — the bf16 panel operands are never perturbed. The
    result is re-symmetrized by mirroring the lower triangle; note that
    under --xla_allow_excess_precision XLA may still rematerialize the
    transposed branch with different FMA contraction, so symmetry is exact
    to a few ulps rather than bitwise. Downstream eigh/Cholesky consumers
    read a single triangle, so this is harmless.
    """
    rm = jnp.mean(G, axis=1)
    gm = jnp.mean(rm)
    H = G - (rm[:, None] + rm[None, :] - gm)
    return jnp.tril(H) + jnp.tril(H, -1).T


@partial(jax.jit, static_argnames=("center",))
def _gram_full(X: jnp.ndarray, center: bool = True) -> jnp.ndarray:
    G = jnp.dot(X, X.T, preferred_element_type=jnp.float32)
    return center_gram(G) if center else G


def gram_centered(X: np.ndarray, block_cols: int = 262_144) -> np.ndarray:
    """(X - colmean) @ (X - colmean)ᵀ, streamed over column blocks (host API).

    Keeps at most `n x block_cols` panel floats resident; each block's raw
    Gram is one panel-schedule device call accumulated into the n x n output,
    and double-centering is applied once at the end (the raw Gram is additive
    over column blocks; the centering projection is not, so it must not be
    applied per block).
    """
    X = np.asarray(X)
    n, p = X.shape
    if p <= block_cols:
        return np.asarray(gram_panel(jnp.asarray(X)))
    out = np.zeros((n, n), dtype=np.float32)
    for start in range(0, p, block_cols):
        blk = jnp.asarray(X[:, start : start + block_cols])
        out += np.asarray(gram_panel(blk, center=False))
    return np.asarray(center_gram(jnp.asarray(out)))


def gram_centered_blocked(X: np.ndarray, block_cols: int = 262_144) -> np.ndarray:
    return gram_centered(X, block_cols=block_cols)


@partial(jax.jit, static_argnames=("center", "nb"))
def _gram_panel(X: jnp.ndarray, center: bool, nb: int) -> jnp.ndarray:
    n = X.shape[0]
    b = -(-n // nb)
    cols = []
    for j in range(nb):
        lo = j * b
        hi = min(lo + b, n)
        if lo >= n:
            break
        panel = jnp.dot(X[lo:], X[lo:hi].T, preferred_element_type=jnp.float32)
        cols.append(jnp.pad(panel, ((lo, 0), (0, 0))))
    L = jnp.tril(jnp.concatenate(cols, axis=1))
    G = L + jnp.tril(L, -1).T
    return center_gram(G) if center else G


def gram_panel(X, center: bool = True, nb: int | None = None) -> jnp.ndarray:
    """Centered Gram via the column-panel syrk schedule (pure XLA; default).

    Panel j is one ((n - j·b) x b x p) GEMM covering the diagonal block and
    everything below it; the strict upper triangle is filled by transpose.
    Executed-FLOP fraction (nb+1)/(2nb) of the full GEMM, and every GEMM has
    a large M dimension.
    """
    X = jnp.asarray(X)
    n = X.shape[0]
    if nb is None:
        nb = max(1, min(16, n // 512))
    if nb <= 1:
        return _gram_full(X, center=center)
    return _gram_panel(X, bool(center), int(nb))


def encode_dosage(X, ploidy: int = 2, tol: float = 1e-6):
    """Encode an allele-frequency panel on the grid {0, 1/k, ..., 1} as int8
    dosages d = k·x. Returns None when any value is off-grid (> `tol` from the
    nearest multiple of 1/ploidy), i.e. the panel is continuous/imputed and
    must take the bf16 path.

    Host-side (numpy) on purpose: encoding happens once per panel, and the
    int8 copy is 4x smaller than the f32 panel it replaces.
    """
    if ploidy < 1 or ploidy > 127:
        return None
    X = np.asarray(X)
    D = X * float(ploidy)
    Dr = np.rint(D)
    if not bool(np.all(np.abs(D - Dr) <= tol * ploidy)):
        return None
    if Dr.min() < 0 or Dr.max() > ploidy:
        return None
    return Dr.astype(np.int8)


def _gram_panel_int8_lower(D: jnp.ndarray, nb: int) -> jnp.ndarray:
    """Lower triangle of the raw int8 Gram (int32); upper triangle is zero."""
    n = D.shape[0]
    b = -(-n // nb)
    cols = []
    for j in range(nb):
        lo = j * b
        hi = min(lo + b, n)
        if lo >= n:
            break
        panel = jnp.dot(D[lo:], D[lo:hi].T, preferred_element_type=jnp.int32)
        cols.append(jnp.pad(panel, ((lo, 0), (0, 0))))
    return jnp.tril(jnp.concatenate(cols, axis=1))


@partial(jax.jit, static_argnames=("nb",))
def _gram_panel_int8(D: jnp.ndarray, nb: int) -> jnp.ndarray:
    L = _gram_panel_int8_lower(D, nb)
    return L + jnp.tril(L, -1).T


@partial(jax.jit, static_argnames=("center", "nb", "ploidy"))
def _gram_dosage(D: jnp.ndarray, ploidy: int, center: bool, nb: int) -> jnp.ndarray:
    Gi = _gram_panel_int8(D, nb)
    G = Gi.astype(jnp.float32) / jnp.float32(ploidy * ploidy)
    return center_gram(G) if center else G


def gram_dosage(D, ploidy: int = 2, center: bool = True, nb: int | None = None) -> jnp.ndarray:
    """Centered Gram of a dosage-coded panel: EXACT int8 syrk.

    `D` is int8 dosages in {0, ..., ploidy} (use `encode_dosage` to produce it
    from an allele-frequency panel). The raw Gram accumulates in int32 —
    bit-exact, no rounding — then scales by 1/ploidy² and double-centers in
    f32. Runs the same column-panel schedule as `gram_panel`. Exactness
    bound: p·ploidy² < 2³¹.
    """
    D = jnp.asarray(D)
    if D.dtype != jnp.int8:
        raise TypeError(f"gram_dosage wants int8 dosages, got {D.dtype}")
    n = D.shape[0]
    if nb is None:
        nb = max(1, min(16, n // 512))
    return _gram_dosage(D, int(ploidy), bool(center), int(nb))


@partial(jax.jit, static_argnames=("center", "nb", "ploidy"))
def _gram_dosage_T(F: jnp.ndarray, ploidy: int, center: bool, nb: int) -> jnp.ndarray:
    return _gram_dosage(F.T, ploidy, center, nb)


def gram_dosage_snp_major(
    F, ploidy: int = 2, center: bool = True, nb: int | None = None
) -> jnp.ndarray:
    """`gram_dosage` for an SNP-major (p, n) int8 dosage shard.

    PLINK .bed payloads are SNP-major; decoding them without a host
    transpose (native/src/gbmio.cpp:gbmio_bed_decode_i8 with
    out_snp_major=1) is ~2x faster on a 2-core host, and the device
    transposes the int8 shard inside this jitted program. Same exact int32
    Gram as `gram_dosage`.
    """
    F = jnp.asarray(F)
    if F.dtype != jnp.int8:
        raise TypeError(f"gram_dosage_snp_major wants int8 dosages, got {F.dtype}")
    n = F.shape[1]
    if nb is None:
        nb = max(1, min(16, n // 512))
    return _gram_dosage_T(F, int(ploidy), bool(center), int(nb))


def center_gram_lower(L: jnp.ndarray) -> jnp.ndarray:
    """Double-center a LOWER-TRIANGLE-ONLY raw Gram (upper triangle zero).

    Same projection as `center_gram` but without ever materializing the
    symmetric matrix: the full row means are recovered from the triangle as
    rowsum + colsum - diag. Only the lower triangle of the result is
    meaningful (the upper holds -(rm_i + rm_j - gm)); feed it to consumers
    that read a single triangle (ops/chol.py:gblup_solve_lower). Skipping
    the mirror pass saves two n x n HBM passes on the GBLUP hot path.

    PRECONDITION: the strict upper triangle of `L` must be zero — passing a
    full symmetric Gram silently double-counts the off-diagonal mass in the
    recovered row means. Checked eagerly (outside jit) below; inside jit the
    producer (`_gram_panel_int8_lower` et al.) guarantees it.
    """
    if not isinstance(L, jax.core.Tracer):
        bad = jnp.max(jnp.abs(jnp.triu(L, k=1)))
        if float(bad) != 0.0:
            raise ValueError(
                "center_gram_lower got a matrix with nonzero strict upper "
                f"triangle (max |upper| = {float(bad):.3e}); pass the lower "
                "triangle only, or use center_gram for symmetric input"
            )
    n = L.shape[0]
    rs = jnp.sum(L, axis=1)
    cs = jnp.sum(L, axis=0)
    rm = (rs + cs - jnp.diagonal(L)) / n
    gm = jnp.mean(rm)
    return L - (rm[:, None] + rm[None, :] - gm)


@partial(jax.jit, static_argnames=("nb", "ploidy"))
def _gram_dosage_lower(D: jnp.ndarray, ploidy: int, nb: int) -> jnp.ndarray:
    Gi = _gram_panel_int8_lower(D, nb)
    return center_gram_lower(Gi.astype(jnp.float32) / jnp.float32(ploidy * ploidy))


def gram_dosage_lower(D, ploidy: int = 2, nb: int | None = None) -> jnp.ndarray:
    """Centered Gram of an int8 dosage panel, LOWER TRIANGLE ONLY.

    Same exact int8 syrk as `gram_dosage` but the symmetric mirror is never
    built — for consumers that read a single triangle (blocked Cholesky /
    eigh); it skips the two n x n passes of the mirror.
    """
    D = jnp.asarray(D)
    if D.dtype != jnp.int8:
        raise TypeError(f"gram_dosage_lower wants int8 dosages, got {D.dtype}")
    n = D.shape[0]
    if nb is None:
        nb = max(1, min(16, n // 512))
    return _gram_dosage_lower(D, int(ploidy), int(nb))


def gram_auto(X, ploidy: int = 2, center: bool = True) -> jnp.ndarray:
    """Centered Gram with automatic path selection: exact int8 dosage syrk
    when the panel sits on the {0, 1/ploidy, ..., 1} grid (real genotype
    calls), bf16 panel syrk otherwise (continuous/imputed frequencies).
    """
    if isinstance(X, np.ndarray):
        D = encode_dosage(X, ploidy=ploidy)
        if D is not None:
            return gram_dosage(D, ploidy=ploidy, center=center)
    elif isinstance(X, jnp.ndarray) and X.dtype == jnp.int8:
        return gram_dosage(X, ploidy=ploidy, center=center)
    return gram_panel(jnp.asarray(X), center=center)


def _assemble_recursive(z, d):
    """Symmetric Z Zᵀ by 2x2 recursion: the off-diagonal block of each level
    is one big GEMM, the diagonal blocks recurse.
    Executed-FLOP fraction after d levels: 1/2 + 2^-d/2."""
    if d == 0:
        return jnp.dot(z, z.T, preferred_element_type=jnp.float32)
    m = z.shape[0] // 2
    A, B = z[:m], z[m:]
    off = jnp.dot(B, A.T, preferred_element_type=jnp.float32)
    top = jnp.concatenate([_assemble_recursive(A, d - 1), off.T], axis=1)
    bot = jnp.concatenate([off, _assemble_recursive(B, d - 1)], axis=1)
    return jnp.concatenate([top, bot], axis=0)


@partial(jax.jit, static_argnames=("center", "depth"))
def _gram_recursive(X: jnp.ndarray, center: bool, depth: int) -> jnp.ndarray:
    G = _assemble_recursive(X, depth)
    return center_gram(G) if center else G


def gram_recursive(X, center: bool = True, depth: int | None = None) -> jnp.ndarray:
    """Centered Gram via recursive symmetric blocking (pure XLA).

    Default depth keeps leaf diagonal blocks >= 512 rows.
    """
    X = jnp.asarray(X)
    n = X.shape[0]
    if depth is None:
        depth = 0
        while n >> (depth + 1) >= 512 and depth < 4:
            depth += 1
    if depth == 0:
        return _gram_full(X, center=center)
    return _gram_recursive(X, bool(center), int(depth))


@partial(jax.jit, static_argnames=("center", "nb"))
def _gram_triangular(X: jnp.ndarray, center: bool, nb: int) -> jnp.ndarray:
    n = X.shape[0]
    b = -(-n // nb)
    pad = nb * b - n
    Z = jnp.pad(X, ((0, pad), (0, 0))) if pad else X
    tiles = {}
    for i in range(nb):
        Zi = jax.lax.dynamic_slice_in_dim(Z, i * b, b, 0)
        for j in range(i + 1):
            Zj = jax.lax.dynamic_slice_in_dim(Z, j * b, b, 0)
            tiles[(i, j)] = jnp.dot(Zi, Zj.T, preferred_element_type=jnp.float32)
    rows = [
        jnp.concatenate(
            [tiles[(i, j)] if j <= i else tiles[(j, i)].T for j in range(nb)], axis=1
        )
        for i in range(nb)
    ]
    G = jnp.concatenate(rows, axis=0)
    if pad:
        G = G[:n, :n]
    return center_gram(G) if center else G


def gram_triangular(X, center: bool = True, nb: int | None = None) -> jnp.ndarray:
    """Centered Gram via a triangular schedule of square row-block GEMMs.

    Kept for comparison and small shapes. nb is capped so blocks never
    shrink below ~1024 rows.
    """
    X = jnp.asarray(X)
    n = X.shape[0]
    if nb is None:
        nb = max(2, min(8, n // 1024))
    if n < 2048 or nb < 2:
        return _gram_full(X, center=center)
    return _gram_triangular(X, center, int(nb))


def gram_centered_device(X) -> jnp.ndarray:
    """Device-resident centered Gram: returns a jnp (n, n) f32 array.

    Runs the column-panel XLA schedule (`gram_panel`). Input may be any float
    dtype; centering accuracy does not depend on the input dtype (see
    `center_gram`).
    """
    return gram_panel(jnp.asarray(X))
