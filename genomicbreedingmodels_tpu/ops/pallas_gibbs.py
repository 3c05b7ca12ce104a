"""Pallas kernel (Triton route) for the grouped BayesB/C indicator block update.

Within one marker block the grouped sampler (models/bayesian.py) visits the
G = bs/K marker groups in order, and group g's draw depends on what the
groups before it just drew, through the running correction
w = u − Σ_h d_h C_rows_h. Everything else the draw needs is constant over a
sweep: the per-(group, pattern) masked inverse Cholesky factors W̃ and the
residual-free pattern log-weights are built for every group at once by XLA
(`build_group_tables`), in parallel over the whole card. What is left is the
sequential loop. As an XLA scan each group step is several small fused
kernels, so a block costs G × (several launches); this kernel runs the whole
loop of one block in ONE launch (one program on one SM), carrying w in
registers. Per group g:

    v   = (w_g + C_gg b_g) / σ²ₑ                   (K)
    Z   = W̃_g v                                    (2^K, K), one row per pattern
    m*  = argmax(score0_g + ½‖Z‖²)                 exact Gumbel-max pattern draw
    b'  = W̃_{g,m*}ᵀ (Z_{m*} + η_g)                 joint K-dim effect draw
    w  −= (b' − b_g) C_rows_g                      rank-K correction, length bs

score0 = const + Gumbel noise; the random numbers are drawn outside the
kernel, as for the XLA path. `grouped_block_reference` is that XLA path: the
same update law as a `lax.scan`, kept beside the kernel as its plain
reference and as the sampler's path off the GPU.

Triton tensors need power-of-two shapes, so K pads to KP = next_pow2(K) and
the block width to BSP = next_pow2(bs); padded coordinates load as zero and
are never stored. 2^K is already a power of two. The per-group pattern
tensor is 2^K × KP × KP floats in registers, which bounds K at 8.

Exactness: identical update law to the XLA scan (each group's pair (γ_g, b_g)
is drawn from its exact full conditional given everything outside the
group), so the same stationary distribution as the one-marker-at-a-time
scalar oracle. Tested against a from-scratch f64 oracle in
tests/test_pallas_kernels.py (interpret mode).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "MAX_GROUP_SIZE",
    "build_group_tables",
    "group_patterns",
    "grouped_block_reference",
    "grouped_block_update",
    "kernel_dims",
]

# 2^K patterns × KP × KP floats live in registers per group step.
MAX_GROUP_SIZE = 8


def kernel_dims(K: int, bs: int) -> tuple[int, int]:
    """(KP, BSP): the power-of-two widths the kernel pads K and bs to.

    Raises ValueError for shapes the kernel does not take: K outside
    [1, MAX_GROUP_SIZE] or a block width that is not a whole number of
    groups."""
    if not 1 <= K <= MAX_GROUP_SIZE:
        raise ValueError(
            f"grouped_block_update takes group sizes 1..{MAX_GROUP_SIZE}; got K={K}"
        )
    if bs % K:
        raise ValueError(f"block width {bs} is not a multiple of the group size {K}")
    return _next_pow2(K), _next_pow2(bs)


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def group_patterns(K: int, n_pat: int | None = None) -> jnp.ndarray:
    """(n_pat, K) 0/1 inclusion patterns; bit k of pattern m is γ_mk.

    n_pat = 2^K for the indicator models; n_pat = 1 gives BL's single
    all-ones pattern."""
    if n_pat == 1:
        return jnp.ones((1, K), jnp.float32)
    m = np.arange(1 << K)
    return jnp.asarray(((m[:, None] >> np.arange(K)[None, :]) & 1).astype(np.float32))


def build_group_tables(C, s2, valid, sig_e2, pi_in, patterns):
    """(W̃, const) for every (block, group, pattern), batched.

    C: (B, bs, bs) block Grams; s2, valid: (B·bs,); patterns: (P, K).
    W̃ (B, G, P, K, K) is the pattern-masked L⁻¹ of the pattern precision
    P(γ) = (C_gg ⊙ γγᵀ)/σ²ₑ + diag(γ/s² + (1−γ)) — identity at excluded
    coords (no fill-in across the decoupled index sets), then rows/cols
    zeroed there. const (B, G, P) is the v-independent part of the pattern
    log-weight: prior inclusion terms − ½Σ_γ log s² − ½log|P| − the padding
    penalty. With Z = W̃v the pattern score is const + ½‖Z‖² (= const +
    ½vᵀP⁻¹v on the included set) and the selected pattern's joint draw is
    b = W̃ᵀ(Z + η) = P⁻¹v + L⁻ᵀη.
    """
    n_blocks, bs, _ = C.shape
    K = patterns.shape[1]
    gpb = bs // K
    C5 = C.reshape(n_blocks, gpb, K, gpb, K)
    C_gg = jnp.einsum("bgkgl->bgkl", C5)  # per-group diagonal blocks
    s2g = s2.reshape(n_blocks, gpb, K)
    valg = valid.reshape(n_blocks, gpb, K)
    M = patterns[None, None] * valg[:, :, None, :]  # (B, g, P, K)
    diag_vals = jnp.where(M > 0, 1.0 / jnp.maximum(s2g[:, :, None, :], 1e-12), 1.0)
    Pm = (C_gg / sig_e2)[:, :, None] * M[..., :, None] * M[..., None, :] + (
        jnp.eye(K) * diag_vals[..., None]
    )
    # Unrolled batched Cholesky (static K): elementwise tensor ops, no
    # per-column loop.
    row_mask = jnp.tril(jnp.ones((K, K), jnp.float32))
    acc = Pm
    half_logdet = jnp.zeros(Pm.shape[:-2])
    cols = []
    for j in range(K):
        dj = jnp.maximum(acc[..., j, j], 1e-30)
        half_logdet = half_logdet + 0.5 * jnp.log(dj)
        col = acc[..., :, j] * jax.lax.rsqrt(dj)[..., None]
        col = col * row_mask[:, j]
        acc = acc - col[..., :, None] * col[..., None, :]
        cols.append(col)
    L = jnp.stack(cols, axis=-1)  # (B, g, P, K, K) lower
    # W = L⁻¹ by row-wise forward substitution (K unrolled steps).
    rows = []
    for i in range(K):
        accr = jnp.zeros((K,)).at[i].set(1.0)
        for j in range(i):
            accr = accr - L[..., i, j, None] * rows[j]
        rows.append(accr / L[..., i, i, None])
    W = jnp.stack(rows, axis=-2)  # (B, g, P, K, K) = L⁻¹
    # Excluded rows of L⁻¹ are exactly e_k, so zeroing rows+cols at excluded
    # coords makes Z = W̃v and b = W̃ᵀ(Z+η) ignore/zero them.
    W = W * M[..., :, None] * M[..., None, :]
    log_pi = jnp.log(pi_in)
    # pi=1 (BL's single-pattern case) would give -inf * 0 = NaN
    log_1mpi = jnp.log1p(-jnp.minimum(pi_in, 1.0 - 1e-7))
    const = (
        jnp.sum(M, -1) * log_pi
        + jnp.sum(valg[:, :, None, :] * (1.0 - patterns)[None, None], -1) * log_1mpi
        - 0.5 * jnp.sum(jnp.where(M > 0, jnp.log(s2g)[:, :, None, :], 0.0), -1)
        - half_logdet
        - 1e30 * jnp.sum(patterns[None, None] * (1.0 - valg[:, :, None, :]), -1)
    )
    return W, const


def grouped_block_reference(Cb, u, b_blk, val_blk, normals, W, score0, sig_e2,
                            patterns, vary=lambda v: v):
    """The grouped block update as an XLA scan over the G groups.

    Cb (bs, bs) block Gram; u (bs,) X_bᵀr at block start; b_blk, val_blk,
    normals (bs,); W (G, P, K, K) and score0 (G, P) = const + Gumbel noise
    from `build_group_tables`; patterns (P, K). `vary` marks fresh carries
    device-varying under shard_map. Returns (delta, b_new, incl (bool)),
    each (bs,).
    """
    bs = Cb.shape[0]
    K = W.shape[-1]

    def group_step(carry, g):
        # Carry w = u − cdelta: one slice per step; w updates by the d·C_rows
        # rank-K correction.
        w, delta, b_blk = carry
        r0 = g * K
        Cb_rows = jax.lax.dynamic_slice(Cb, (r0, 0), (K, bs))
        C_gg = jax.lax.dynamic_slice(Cb_rows, (0, r0), (K, K))
        u_cur = jax.lax.dynamic_slice(w, (r0,), (K,))
        b_cur = jax.lax.dynamic_slice(b_blk, (r0,), (K,))
        val_g = jax.lax.dynamic_slice(val_blk, (r0,), (K,))
        v = (u_cur + C_gg @ b_cur) / sig_e2
        Wg = W[g]
        Z = jnp.einsum("pkl,l->pk", Wg, v)  # L⁻¹v per pattern
        m_star = jnp.argmax(score0[g] + 0.5 * jnp.sum(Z * Z, axis=-1))
        gam = patterns[m_star] * val_g
        eta = jax.lax.dynamic_slice(normals, (r0,), (K,))
        b_new = (Z[m_star] + eta) @ Wg[m_star]  # = W̃ᵀ(Z+η); 0 at excluded
        d = b_new - b_cur
        w = w - jnp.dot(d, Cb_rows, preferred_element_type=jnp.float32)
        delta = jax.lax.dynamic_update_slice(delta, d, (r0,))
        b_blk = jax.lax.dynamic_update_slice(b_blk, b_new, (r0,))
        return (w, delta, b_blk), gam > 0

    init = (vary(u), vary(jnp.zeros(bs)), b_blk)
    (_, delta, b_new), incl = jax.lax.scan(
        group_step, init, jnp.arange(W.shape[0]), unroll=4
    )
    return delta, b_new, incl.reshape(bs)


def _kernel(inv_ref, s0_ref, W_ref, Cb_ref, u_ref, b_ref, val_ref, eta_ref,
            d_ref, bnew_ref, incl_ref, *, K: int, KP: int, G: int, bs: int,
            BSP: int, NP: int):
    from jax.experimental.pallas import triton as plgpu

    kk = jnp.arange(KP)
    kmask = kk < K
    cols = jnp.arange(BSP)
    cmask = cols < bs
    pp = jnp.arange(NP)
    kk2 = kmask[:, None] & kmask[None, :]
    kk3 = jnp.broadcast_to(kk2[None], (NP, KP, KP))
    inv_sig = jnp.sum(plgpu.load(inv_ref.at[jnp.arange(1)]))
    w0 = plgpu.load(u_ref.at[cols], mask=cmask, other=0.0)

    def group_step(g, w):
        rows = g * K + kk
        C_gg = plgpu.load(Cb_ref.at[rows[:, None], rows[None, :]], mask=kk2, other=0.0)
        b_g = plgpu.load(b_ref.at[rows], mask=kmask, other=0.0)
        val_g = plgpu.load(val_ref.at[rows], mask=kmask, other=0.0)
        eta_g = plgpu.load(eta_ref.at[rows], mask=kmask, other=0.0)
        # w_g: the group's K entries of the register-resident correction.
        w_g = jnp.sum(jnp.where(cols[None, :] == rows[:, None], w[None, :], 0.0), axis=1)
        v = (w_g + jnp.sum(C_gg * b_g[None, :], axis=1)) * inv_sig
        Wg = plgpu.load(
            W_ref.at[g, pp[:, None, None], kk[None, :, None], kk[None, None, :]],
            mask=kk3, other=0.0,
        )  # (NP, KP, KP)
        Z = jnp.sum(Wg * v[None, None, :], axis=2)  # (NP, KP)
        score = plgpu.load(s0_ref.at[g, pp]) + 0.5 * jnp.sum(Z * Z, axis=1)
        m_star = jnp.argmax(score).astype(jnp.int32)
        sel = pp == m_star
        z_sel = jnp.sum(jnp.where(sel[:, None], Z, 0.0), axis=0)  # (KP,)
        W_sel = jnp.sum(jnp.where(sel[:, None, None], Wg, 0.0), axis=0)  # (KP, KP)
        b_new = jnp.sum((z_sel + eta_g)[:, None] * W_sel, axis=0)
        d = b_new - b_g
        gam = (((m_star >> kk) & 1) > 0) & (val_g > 0)
        C_rows = plgpu.load(
            Cb_ref.at[rows[:, None], cols[None, :]],
            mask=kmask[:, None] & cmask[None, :], other=0.0,
        )  # (KP, BSP)
        w = w - jnp.sum(d[:, None] * C_rows, axis=0)
        plgpu.store(d_ref.at[rows], d, mask=kmask)
        plgpu.store(bnew_ref.at[rows], b_new, mask=kmask)
        plgpu.store(incl_ref.at[rows], gam.astype(jnp.float32), mask=kmask)
        return w

    jax.lax.fori_loop(0, G, group_step, w0)


@partial(jax.jit, static_argnames=("interpret",))
def grouped_block_update(Cb, u, b_blk, val_blk, normals, W, score0, sig_e2,
                         interpret: bool = False):
    """One grouped BayesB/C block update as a single Pallas (Triton) launch.

    Same arguments and results as `grouped_block_reference` (the patterns
    are the bits of the pattern index, so they are not passed). Under `vmap`
    (CV-fold chains) Pallas adds a leading grid axis: one program per chain,
    still one launch. The kernel compiles only for a CUDA GPU;
    `interpret=True` runs it through the Pallas interpreter, which is how
    the CPU tests reach it.
    """
    import jax.experimental.pallas as pl
    from jax.experimental.pallas import triton as plgpu

    from ..utils.backend import platform

    bs = Cb.shape[0]
    G, NP, K, _ = W.shape
    if G * K != bs or NP != 1 << K:
        raise ValueError(
            f"tables of shape {W.shape} do not match a block of width {bs} "
            "with 2^K patterns per group"
        )
    KP, BSP = kernel_dims(K, bs)
    if not interpret and platform() != "gpu":
        raise ValueError(
            "grouped_block_update compiles only for a CUDA GPU; the default "
            f"device is {platform()!r} (interpret=True runs the interpreter)"
        )
    f32 = jnp.float32
    args = (
        (1.0 / jnp.asarray(sig_e2, f32)).reshape(1),
        score0.astype(f32),
        W.astype(f32),
        Cb.astype(f32),
        u.astype(f32),
        b_blk.astype(f32),
        val_blk.astype(f32),
        normals.astype(f32),
    )
    # Under shard_map the results vary over the mesh axes their inputs do.
    vma = frozenset().union(*(jax.typeof(a).vma for a in args))
    shp = jax.ShapeDtypeStruct((bs,), f32, vma=vma)
    kern = partial(_kernel, K=K, KP=KP, G=G, bs=bs, BSP=BSP, NP=NP)
    d, b_new, incl = pl.pallas_call(
        kern,
        out_shape=(shp, shp, shp),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="gibbs_grouped_block",
    )(*args)
    return d, b_new, incl > 0
