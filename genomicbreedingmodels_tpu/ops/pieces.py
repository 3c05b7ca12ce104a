"""Trapezoid-piece Gram: lower-triangle-only streaming GRM + CG GBLUP for
panels whose square Gram does not fit device memory.

At the north-star scale (n = 50k) the square f32 Gram is 10 GB and a
Cholesky needs a second 10 GB buffer; beyond that n neither fits one card.
This module stores the Gram as nb BLOCK-COLUMN TRAPEZOID PIECES (piece j =
rows lo_j.., cols lo_j..hi_j of the lower triangle; ~5.4 GB at n=50k), so:

- each marker shard's update is one int8 syrk per piece with EXACT int32
  accumulation (panel products < 2³¹ for p·ploidy² < 2³¹), and donation
  aliases the piece buffers (pure elementwise add — no defensive copy);
- the piece width defaults to 4096, a power-of-two GEMM N dimension;
- double-centering recovers full row means from the triangle as
  rowsum + colsum − diag (ops/grm.py:center_gram_lower, piecewise);
- the mixed-model solve is matrix-free CG whose matvec applies each piece
  and its mirror (K = L + Lᵀ − diag L) — no second n × n buffer ever.

Used by bench.py's north-star section and by `streaming.gblup_from_bed`'s
big-n path (disk .bed shards instead of on-device RNG shards).

Reference context: the reference builds its GRM dense in RAM via Julia
OpenBLAS (src/gwas.jl:117-126) and has no out-of-core story at all.
"""

from __future__ import annotations

from functools import partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "make_bounds",
    "zero_pieces",
    "accumulate_dosage_shard",
    "accumulate_bed_payload",
    "unpack_bed_payload",
    "center_scale_pieces",
    "cg_solve_pieces",
    "gblup_from_pieces",
]

Bounds = Tuple[Tuple[int, int], ...]


def make_bounds(n: int, b: int = 4096) -> Bounds:
    """Row-block boundaries for n rows in width-b panels (last one ragged).

    b = 4096 keeps the syrk's N dimension a power of two."""
    bounds = []
    lo = 0
    while lo < n:
        bounds.append((lo, min(lo + b, n)))
        lo = min(lo + b, n)
    return tuple(bounds)


def zero_pieces(n: int, bounds: Bounds, dtype=jnp.int32) -> List[jnp.ndarray]:
    """Freshly zeroed trapezoid pieces (int32 for the exact dosage path)."""
    return [jnp.zeros((n - lo, hi - lo), dtype) for lo, hi in bounds]


def _accumulate(pieces, F, bounds: Bounds, snp_major: bool):
    D = F.T if snp_major else F  # (n, cols)
    out = []
    for (lo, hi), piece in zip(bounds, pieces):
        panel = jnp.dot(D[lo:], D[lo:hi].T, preferred_element_type=jnp.int32)
        out.append(piece + panel)
    return out


@partial(jax.jit, donate_argnums=(0,), static_argnames=("bounds", "snp_major"))
def accumulate_dosage_shard(
    pieces: List[jnp.ndarray], F: jnp.ndarray, *, bounds: Bounds, snp_major: bool = True
) -> List[jnp.ndarray]:
    """pieces += lower-trapezoid syrk of one int8 dosage shard.

    F: (cols, n) int8 snp-major (the .bed native order — pass
    snp_major=False for an (n, cols) shard). All panel products accumulate
    in int32: bit-exact for p_total · ploidy² < 2³¹.
    """
    return _accumulate(pieces, F, bounds, snp_major)


def unpack_bed_payload(payload: jnp.ndarray, n: int):
    """Device-side PLINK 2-bit unpack: (cols, ceil(n/4)) uint8 → ((cols, n)
    int8 dosages with missing mapped to 0, missing-call count).

    Host→device traffic bounds disk-streamed panels (one byte carries FOUR
    genotypes — shipping decoded int8 dosages costs 4x the bytes). The
    unpack itself is three elementwise ops: shift, mask, gather.

    .bed code → dosage: 0b00→0 (hom A1), 0b10→1 (het), 0b11→2 (hom A2);
    0b01 (missing) maps to dosage 0 and is COUNTED — callers that need exact
    Grams must check the returned count (an imputed zero would poison the
    int32 syrk silently otherwise).
    """
    cols = payload.shape[0]
    shifts = jnp.array([0, 2, 4, 6], dtype=jnp.uint8)
    codes = (payload[:, :, None] >> shifts[None, None, :]) & jnp.uint8(3)
    codes = codes.reshape(cols, -1)[:, :n]
    lut = jnp.array([0, 0, 1, 2], dtype=jnp.int8)
    n_missing = jnp.sum((codes == 1).astype(jnp.int32))
    return lut[codes], n_missing


@partial(jax.jit, donate_argnums=(0,), static_argnames=("bounds", "n"))
def accumulate_bed_payload(
    pieces: List[jnp.ndarray], payload: jnp.ndarray, miss: jnp.ndarray,
    *, bounds: Bounds, n: int
):
    """pieces += trapezoid syrk of one PACKED .bed shard, unpacked on device.

    Fuses `unpack_bed_payload` with `accumulate_dosage_shard` in one program:
    the packed bytes are the only host→device transfer (4 genotypes/byte),
    the int8 dosage shard exists only in HBM, and the syrk accumulates in
    exact int32. `miss` is a running missing-call counter (checked once by
    the caller after the last shard). Replaces the reference's in-RAM dense
    GRM build (src/gwas.jl:117-126) for out-of-core panels.
    """
    D, nm = unpack_bed_payload(payload, n)
    return _accumulate(pieces, D, bounds, True), miss + nm


@partial(jax.jit, donate_argnums=(0,), static_argnames=("bounds",))
def center_scale_pieces(
    pieces: List[jnp.ndarray], ploidy_sq: jnp.ndarray, *, bounds: Bounds
) -> List[jnp.ndarray]:
    """Scale raw int32 pieces by 1/ploidy² and double-center, in f32.

    The diagonal block of each piece is masked to its lower half first (the
    panel GEMM computed the full block), and the centering correction is
    masked to the lower trapezoid so the strict upper half STAYS exactly
    zero (the CG matvec multiplies the full piece buffer).
    """
    n = pieces[0].shape[0]
    pieces = [
        jnp.concatenate([jnp.tril(piece[: hi - lo]), piece[hi - lo:]], axis=0)
        .astype(jnp.float32) / ploidy_sq
        for (lo, hi), piece in zip(bounds, pieces)
    ]
    rs = jnp.zeros(n, jnp.float32)
    cs = jnp.zeros(n, jnp.float32)
    dg = jnp.zeros(n, jnp.float32)
    for (lo, hi), piece in zip(bounds, pieces):
        rs = rs.at[lo:].add(jnp.sum(piece, axis=1))
        cs = cs.at[lo:hi].add(jnp.sum(piece, axis=0))
        dg = dg.at[lo:hi].set(jnp.diagonal(piece[: hi - lo]))
    rm = (rs + cs - dg) / n
    gm = jnp.mean(rm)
    out = []
    for (lo, hi), piece in zip(bounds, pieces):
        corr = rm[lo:, None] + rm[None, lo:hi] - gm
        w = hi - lo
        mask = jnp.concatenate(
            [jnp.tril(jnp.ones((w, w), jnp.float32)),
             jnp.ones((n - hi, w), jnp.float32)],
            axis=0,
        )
        out.append(piece - corr * mask)
    return out


@partial(jax.jit, static_argnames=("bounds", "iters"))
def cg_solve_pieces(
    pieces: List[jnp.ndarray],
    y: jnp.ndarray,
    lam_rel: jnp.ndarray,
    *,
    bounds: Bounds,
    iters: int = 30,
):
    """GBLUP by CG straight from centered lower-trapezoid pieces.

    Solves (K + λI) α = y_c with K = L + Lᵀ − diag L applied piecewise
    (each piece contributes its block-column of L and, transposed, its
    block-row of Lᵀ; the double-counted diagonal is removed) and
    λ = lam_rel · mean(diag K). Returns (gebv, resid_norm): the GEBV uses
    K α = y_c − λ α, so the final n × n matvec is algebraically free.
    """
    yc = y - jnp.mean(y)
    n = y.shape[0]
    dg = jnp.concatenate(
        [jnp.diagonal(piece[: hi - lo]) for (lo, hi), piece in zip(bounds, pieces)]
    )
    lam = lam_rel * jnp.sum(dg) / n

    def mv(v):
        out = lam * v - dg * v
        for (lo, hi), piece in zip(bounds, pieces):
            out = out.at[lo:].add(piece @ v[lo:hi])
            out = out.at[lo:hi].add(piece.T @ v[lo:])
        return out

    def loop_body(i, st):
        x, r, pvec, rs = st
        Ap = mv(pvec)
        # Breakdown guards: once converged (rs -> 0) the iteration becomes a
        # no-op instead of 0/0 (matters when iters > n on small panels).
        alpha = rs / jnp.maximum(pvec @ Ap, 1e-30)
        x = x + alpha * pvec
        r = r - alpha * Ap
        rs_new = r @ r
        pvec = r + (rs_new / jnp.maximum(rs, 1e-30)) * pvec
        return (x, r, pvec, rs_new)

    x, r, _, _ = jax.lax.fori_loop(
        0, iters, loop_body, (jnp.zeros_like(yc), yc, yc, yc @ yc)
    )
    return yc - lam * x + jnp.mean(y), jnp.sqrt(r @ r)


def gblup_from_pieces(pieces, y, bounds: Bounds, ploidy: int = 2,
                      lam_rel: float = 1e-3, iters: int = 30):
    """Convenience: center raw int32 pieces, then CG-solve. Consumes
    `pieces` (donated). Returns (gebv, resid_norm)."""
    pieces = center_scale_pieces(
        pieces, jnp.float32(ploidy * ploidy), bounds=bounds
    )
    return cg_solve_pieces(
        pieces, jnp.asarray(y, jnp.float32), jnp.float32(lam_rel),
        bounds=bounds, iters=iters,
    )
