"""Multi-device sharded compute paths: GRM, RR-BLUP/GBLUP training step.

Design (BASELINE.json north star): the n x p SNP matrix is column-sharded
(markers) across devices; Gram partial products G_d = Z_d Z_dᵀ are formed
locally on each device and summed with `psum` across devices; the n x n
mixed-model solve is replicated (it is tiny relative to the Gram work); marker
effects come back column-sharded with one local GEMM per device. The 'dp'
axis batches independent problems (traits / CV folds / MCMC chains).

All functions are shard_map'ed over an explicit Mesh so they run identically
on several GPUs and on the 8-device virtual CPU mesh used in tests.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

__all__ = ["sharded_grm", "sharded_ridge_step", "gblup_train_step", "multitrait_gblup_step", "sharded_gibbs_regression", "sharded_gblup_cg", "sharded_gwasreml", "sharded_gwasols", "sharded_gwaslmm"]


def _local_centered(Xl: jnp.ndarray) -> jnp.ndarray:
    # Columns live wholly on one device, so centering is local.
    return Xl - jnp.mean(Xl, axis=0, keepdims=True)


def sharded_grm(X, mesh: Mesh, ploidy: int = 2) -> jnp.ndarray:
    """GRM numerator (centered Gram matrix) with marker sharding + psum.

    X: (n, p) sharded P(None, 'mp'). Returns replicated (n, n).
    int8 input is treated as a dosage panel in {0..ploidy} (allele frequency
    x ploidy — see ops/grm.py:gram_dosage): local Grams accumulate EXACTLY in
    int32, the psum moves the same n x n f32 payload, and the result is
    rescaled by 1/ploidy².
    """
    # Module-level jitted entry (mesh static, ploidy traced): repeat calls
    # hit the compile cache — a fresh jax.jit(shard_map(...)) closure per
    # call would re-trace and recompile the whole program every time.
    return _sharded_grm_jit(
        jnp.asarray(X), jnp.float32(ploidy * ploidy), mesh,
        jnp.asarray(X).dtype == jnp.int8,
    )


@partial(jax.jit, static_argnames=("mesh", "is_dosage"))
def _sharded_grm_jit(X, ploidy_sq, mesh: Mesh, is_dosage: bool):
    def kernel(Xl, ploidy_sq):
        # Raw local Gram (operands stay in the input dtype; int8 dosage
        # panels accumulate exactly in int32), summed over marker shards via
        # psum, then double-centered once: K = P (Σ_d X_d X_dᵀ) P. Same
        # algebra as the single-device path
        # (ops/grm.py:center_gram) — no centered panel copy, no f32 upcast of
        # the shard.
        from ..ops.grm import center_gram

        if is_dosage:
            Gl = jnp.dot(Xl, Xl.T, preferred_element_type=jnp.int32)
            Gl = Gl.astype(jnp.float32) / ploidy_sq
        else:
            Gl = jnp.dot(Xl, Xl.T, preferred_element_type=jnp.float32)
        return center_gram(jax.lax.psum(Gl, axis_name="mp"))

    fn = shard_map(
        kernel, mesh=mesh, in_specs=(P(None, "mp"), P()), out_specs=P()
    )
    return fn(X, ploidy_sq)


def sharded_ridge_step(X, y, lam: float, mesh: Mesh) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One RR-BLUP training step over the mesh.

    Returns (b0 replicated, beta column-sharded over 'mp'). The dual system
    (K + nλI)γ = y_c is replicated; each device recovers its marker block with
    β_d = Z_dᵀ γ.
    """

    return _sharded_ridge_jit(X, jnp.asarray(y, jnp.float32), jnp.float32(lam), mesh)


@partial(jax.jit, static_argnames=("mesh",))
def _sharded_ridge_jit(X, y, lam, mesh: Mesh):
    def kernel(Xl, y, lam):
        n = y.shape[0]
        Zl = _local_centered(Xl.astype(jnp.float32))
        yc = y - jnp.mean(y)
        K = jax.lax.psum(jnp.dot(Zl, Zl.T, preferred_element_type=jnp.float32), "mp")
        gamma = jnp.linalg.solve(K + n * lam * jnp.eye(n, dtype=K.dtype), yc)
        beta_l = jnp.dot(Zl.T, gamma, preferred_element_type=jnp.float32)
        mean_xl = jnp.mean(Xl, axis=0)
        b0 = jnp.mean(y) - jax.lax.psum(jnp.dot(mean_xl, beta_l), "mp")
        return b0, beta_l

    fn = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(None, "mp"), P(), P()),
        out_specs=(P(), P("mp")),
    )
    return fn(X, y, lam)


def gblup_train_step(X, y, lam: float, mesh: Mesh) -> jnp.ndarray:
    """Full GBLUP step: sharded GRM + replicated mixed-model solve + GEBV.

    GEBV = K (K/ p̄ + λI)⁻¹ y_c + ȳ with K the centered Gram (up to the GRM
    denominator, which cancels in the λ re-parameterization).
    """

    return _gblup_train_jit(X, jnp.asarray(y, jnp.float32), jnp.float32(lam), mesh)


@partial(jax.jit, static_argnames=("mesh",))
def _gblup_train_jit(X, y, lam, mesh: Mesh):
    def kernel(Xl, y, lam):
        n = y.shape[0]
        Zl = _local_centered(Xl.astype(jnp.float32))
        K = jax.lax.psum(jnp.dot(Zl, Zl.T, preferred_element_type=jnp.float32), "mp")
        p_total = jax.lax.psum(jnp.asarray(Xl.shape[1], jnp.float32), "mp")
        Kn = K / p_total
        yc = y - jnp.mean(y)
        alpha = jnp.linalg.solve(Kn + lam * jnp.eye(n, dtype=Kn.dtype), yc)
        gebv = Kn @ alpha + jnp.mean(y)
        return gebv

    fn = shard_map(
        kernel, mesh=mesh, in_specs=(P(None, "mp"), P(), P()), out_specs=P()
    )
    return fn(X, y, lam)


def multitrait_gblup_step(X, Y, lam: float, mesh: Mesh) -> jnp.ndarray:
    """Multi-trait GBLUP over the full ('dp', 'mp') mesh.

    X: (n, p) column-sharded over 'mp' (replicated over 'dp').
    Y: (t, n) trait-batch row-sharded over 'dp'.
    Each dp slice solves its traits against the shared (psum'd) GRM: this is
    the dryrun-validated multi-device training step (dp x mp = data-parallel
    traits x marker-parallel Gram).
    """

    return _multitrait_gblup_jit(X, jnp.asarray(Y, jnp.float32), jnp.float32(lam), mesh)


@partial(jax.jit, static_argnames=("mesh",))
def _multitrait_gblup_jit(X, Y, lam, mesh: Mesh):
    def kernel(Xl, Yl, lam):
        n = Yl.shape[1]
        Zl = _local_centered(Xl.astype(jnp.float32))
        K = jax.lax.psum(jnp.dot(Zl, Zl.T, preferred_element_type=jnp.float32), "mp")
        p_total = jax.lax.psum(jnp.asarray(Xl.shape[1], jnp.float32), "mp")
        Kn = K / p_total
        A = Kn + lam * jnp.eye(n, dtype=Kn.dtype)
        Yc = Yl - jnp.mean(Yl, axis=1, keepdims=True)
        alpha = jnp.linalg.solve(A, Yc.T)  # (n, t_local)
        gebv = (Kn @ alpha).T + jnp.mean(Yl, axis=1, keepdims=True)
        return gebv

    fn = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(None, "mp"), P("dp", None), P()),
        out_specs=P("dp", None),
    )
    return fn(X, Y, lam)


def sharded_gibbs_regression(
    X,
    y,
    mesh: Mesh,
    axis: str = "mp",
    model: str = "BayesC",
    n_iter: int = 1_500,
    n_burnin: int = 500,
    seed: int = 42,
    block_size: int = 64,
    r2: float = 0.5,
    device_schedule: str = "auto",
    chunk_size: int = None,
    indicator_update: str = None,
    checkpoint_path: str = None,
) -> Tuple[float, np.ndarray]:
    """Marker-sharded Bayesian-alphabet Gibbs across the mesh `axis`.

    Each device owns a contiguous marker shard; within-device block updates
    are the exact sequential conditionals, concurrent blocks across devices
    condition on the round-start residual (block-Jacobi), and the replicated
    residual is kept in sync with one psum of the length-n delta per block
    round — the communication pattern BASELINE.json's multi-host north star
    prescribes (markers over devices, effects psum'd). Exact single-device
    semantics at D=1. Returns (mu_hat, b_hat[p]).

    `device_schedule`: "sequential" (default via "auto" — exact Gauss-Seidel
    turns across devices, matches the single-device chain on any panel) or
    "concurrent" (block-Jacobi rounds: every device updates simultaneously
    against the round-start residual). Concurrent is faster per sweep but is
    an approximation that degrades when markers are correlated ACROSS device
    shards — fine on weak-LD panels (tracks single-device effects to
    cor > 0.97 on iid markers), unsafe on strong-LD founder-cross panels
    (and always divergent for BL, whose sig_e2-proportional shrinkage
    amplifies the Jacobi noise). Interleaving loci across shards reduces the
    cross-shard correlation if you need concurrent throughput.

    `checkpoint_path` enables crash-resume between chunked segments, same
    snapshot format as the single-device sampler (models/bayesian.py): the
    sharded carry is gathered to host numpy after each segment and re-sharded
    on resume (in_specs do the placement), so a chain killed mid-run restarts
    from the last completed segment bit-identically (the RNG key rides in the
    carry). Chunking is forced on when a checkpoint path is given.
    """
    from ..models.bayesian import _MODEL_IDS, _gibbs_chain, BAYESIAN_MODELS

    if model not in _MODEL_IDS:
        raise ValueError(f"unknown Bayesian model {model!r}; choose from {BAYESIAN_MODELS}")
    from ..utils.config import get_config

    cfg = get_config()
    indicator_update = (
        cfg.mcmc_indicator_update if indicator_update is None else indicator_update
    )
    if indicator_update in ("auto", "pallas"):
        # Under shard_map the XLA grouped scan is used (the Pallas kernel is
        # single-device; per-shard kernels inside shard_map are future work).
        indicator_update = "grouped"
    group_size = (
        int(cfg.mcmc_group_size)
        if indicator_update == "grouped" and model in ("BayesB", "BayesC")
        else 0
    )
    X = np.asarray(X, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    n, p = X.shape
    D = mesh.shape[axis]
    bs = int(min(block_size, max(8, p // max(D, 1))))
    if group_size > 1:
        group_size = min(group_size, bs)
        bs = ((bs + group_size - 1) // group_size) * group_size
    # Pad p so every device gets the same whole number of blocks.
    per_dev = ((p + D * bs - 1) // (D * bs)) * bs
    p_pad = per_dev * D
    Xp = np.zeros((n, p_pad), dtype=np.float32)
    Xp[:, :p] = X
    valid = np.zeros(p_pad, dtype=np.float32)
    valid[:p] = 1.0

    var_y = float(np.var(y, ddof=1))
    ms_x = max(float(np.sum(np.var(X, axis=0))), 1e-8)
    df_b, df_e = 5.0, 5.0
    pi_in = 0.5 if model in ("BayesB", "BayesC") else 1.0
    hyper = {
        "df_b": jnp.float32(df_b),
        "S_b0": jnp.float32(var_y * r2 / ms_x * (df_b + 2.0) / pi_in),
        "df_e": jnp.float32(df_e),
        "S_e0": jnp.float32(var_y * (1.0 - r2) * (df_e + 2.0)),
        "pi_in": jnp.float32(pi_in),
        "pi_counts": jnp.float32(10.0),
        "lam2_0": jnp.float32(2.0 * (1.0 - r2) / r2 * ms_x / max(p, 1)),
    }
    key = jax.random.PRNGKey(seed)

    if device_schedule == "auto":
        device_schedule = "sequential"
    if device_schedule not in ("concurrent", "sequential"):
        raise ValueError(f"unknown device_schedule {device_schedule!r}")
    seq_rounds = D if device_schedule == "sequential" else 1
    if chunk_size is None and checkpoint_path is not None:
        chunk_size = max(25, n_iter // 4)  # resume needs segment boundaries
    # State sharding over the chain carry: marker-axis arrays are sharded,
    # scalars/residual/latent replicated (matches _gibbs_chain's state0).
    state_specs = (
        P(axis), P(), P(axis), P(), P(), P(), P(), P(), P(axis), P(), P(), P(), P(),
    )

    statics = dict(
        mesh=mesh, axis=axis, model_id=_MODEL_IDS[model], n_iter=int(n_iter),
        n_burnin=int(n_burnin), bs=bs, n_blocks=per_dev // bs,
        seq_rounds=seq_rounds, state_specs=state_specs, group_size=group_size,
    )
    Xj, yj, vj = jnp.asarray(Xp), jnp.asarray(y), jnp.asarray(valid)
    state = None
    done = 0
    if checkpoint_path is not None:
        from ..utils.checkpoint import load_state as _load

        snap = _load(checkpoint_path)
        if snap is not None:
            done = int(snap.pop("__done__"))
            state = tuple(jnp.asarray(snap[f"s{i}"]) for i in range(len(snap)))

    def _save_snap(state, done):
        from ..utils.checkpoint import save_state as _save

        snap = {f"s{i}": np.asarray(v) for i, v in enumerate(state)}
        snap["__done__"] = np.asarray(done)
        _save(checkpoint_path, snap)

    mu_hat = b_hat = None
    if state is None:
        seg0 = int(min(chunk_size or n_iter, n_iter))
        mu_hat, b_hat, state = _sharded_gibbs_first(
            Xj, yj, vj, key, hyper, jnp.arange(seg0), **statics
        )
        done = seg0
        if checkpoint_path is not None:
            _save_snap(state, done)
    while done < n_iter:
        seg = int(min(chunk_size or n_iter, n_iter - done))
        mu_hat, b_hat, state = _sharded_gibbs_next(
            Xj, yj, vj, key, hyper, state, jnp.arange(done, done + seg), **statics
        )
        done += seg
        if checkpoint_path is not None:
            _save_snap(state, done)
    if mu_hat is None:
        # Resumed from an already-complete checkpoint: recover the posterior
        # means straight from the carried accumulators (indices 8/9/10 of the
        # chain state — see models/bayesian.py:_gibbs_chain's carry layout).
        acc_b = np.asarray(state[8], dtype=np.float64)
        acc_mu = float(np.asarray(state[9]))
        acc_n = max(float(np.asarray(state[10])), 1e-12)
        b_mean = acc_b / acc_n
        mu_cols = Xp.mean(axis=0).astype(np.float64)
        return float(acc_mu / acc_n - mu_cols @ b_mean), b_mean[:p]
    return float(mu_hat), np.asarray(b_hat, dtype=np.float64)[:p]


_GIBBS_STATICS = (
    "mesh", "axis", "model_id", "n_iter", "n_burnin", "bs", "n_blocks",
    "seq_rounds", "state_specs", "group_size",
)


@partial(jax.jit, static_argnames=_GIBBS_STATICS)
def _sharded_gibbs_first(X, y, valid, key, hyper, iters, *, mesh, axis, model_id,
                         n_iter, n_burnin, bs, n_blocks, seq_rounds, state_specs,
                         group_size):
    from ..models.bayesian import _gibbs_chain

    def kernel(Xl, y, validl, key, hyper, iters):
        mu_hat, b_hat, _, state = _gibbs_chain(
            Xl, y, validl, key, hyper, model_id=model_id, n_iter=n_iter,
            n_burnin=n_burnin, block_size=bs, n_blocks=n_blocks,
            axis_name=axis, seq_rounds=seq_rounds, iters=iters,
            return_state=True, group_size=group_size,
        )
        return mu_hat, b_hat, state

    fn = shard_map(
        kernel, mesh=mesh,
        in_specs=(P(None, axis), P(), P(axis), P(), {k: P() for k in hyper}, P()),
        out_specs=(P(), P(axis), state_specs),
    )
    return fn(X, y, valid, key, hyper, iters)


@partial(jax.jit, static_argnames=_GIBBS_STATICS)
def _sharded_gibbs_next(X, y, valid, key, hyper, state, iters, *, mesh, axis,
                        model_id, n_iter, n_burnin, bs, n_blocks, seq_rounds,
                        state_specs, group_size):
    from ..models.bayesian import _gibbs_chain

    def kernel(Xl, y, validl, key, hyper, state, iters):
        mu_hat, b_hat, _, state = _gibbs_chain(
            Xl, y, validl, key, hyper, model_id=model_id, n_iter=n_iter,
            n_burnin=n_burnin, block_size=bs, n_blocks=n_blocks,
            axis_name=axis, seq_rounds=seq_rounds, iters=iters,
            state_in=state, return_state=True, group_size=group_size,
        )
        return mu_hat, b_hat, state

    fn = shard_map(
        kernel, mesh=mesh,
        in_specs=(P(None, axis), P(), P(axis), P(), {k: P() for k in hyper},
                  state_specs, P()),
        out_specs=(P(), P(axis), state_specs),
    )
    return fn(X, y, valid, key, hyper, state, iters)


def sharded_gblup_cg(
    X,
    y,
    lam: float,
    mesh: Mesh,
    axis: str = "mp",
    n_iter: int = 200,
    tol: float = 1e-6,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Matrix-free GBLUP solve at panel scale: (K + λI) α = y_c with
    K = Z Zᵀ / p applied as two GEMVs through the marker-sharded panel —
    the n x n GRM is NEVER materialized, so memory is O(n·p/D) per device
    (the 100k-entry north-star config where K alone would be 40 GB).

    Conjugate gradients with replicated scalars; each iteration costs one
    local (n x p_l) GEMV pair + one psum of an n-vector.
    Returns (alpha, gebv) replicated.
    """
    X = np.asarray(X, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    n, p = X.shape
    D = mesh.shape[axis]
    p_pad = ((p + D - 1) // D) * D
    Xp = np.zeros((n, p_pad), dtype=np.float32)
    Xp[:, :p] = X

    return _sharded_gblup_cg_jit(
        jnp.asarray(Xp), jnp.asarray(y), jnp.float32(p), jnp.float32(lam),
        jnp.float32(tol), jnp.int32(n_iter), mesh, axis,
    )


@partial(jax.jit, static_argnames=("mesh", "axis"))
def _sharded_gblup_cg_jit(Xp, y, p_total, lam_f, tol, n_iter, mesh: Mesh, axis: str):
    def kernel(Xl, y, p_total, lam_f, tol, n_iter):
        Zl = _local_centered(Xl.astype(jnp.float32))
        yc = y - jnp.mean(y)

        def matvec(v):
            u = jnp.dot(Zl.T, v, preferred_element_type=jnp.float32)
            Kv = jax.lax.psum(
                jnp.dot(Zl, u, preferred_element_type=jnp.float32), axis
            ) / p_total
            return Kv + lam_f * v

        def body(state):
            alpha, r, pvec, rs, it = state
            Ap = matvec(pvec)
            a = rs / jnp.maximum(jnp.dot(pvec, Ap), 1e-30)
            alpha = alpha + a * pvec
            r = r - a * Ap
            rs_new = jnp.dot(r, r)
            pvec = r + (rs_new / jnp.maximum(rs, 1e-30)) * pvec
            return alpha, r, pvec, rs_new, it + 1

        def cond(state):
            _, _, _, rs, it = state
            return jnp.logical_and(it < n_iter, rs > tol * tol)

        alpha0 = jnp.zeros_like(yc)
        state = (alpha0, yc, yc, jnp.dot(yc, yc), jnp.int32(0))
        alpha, *_ = jax.lax.while_loop(cond, body, state)
        gebv = matvec(alpha) - lam_f * alpha + jnp.mean(y)
        return alpha, gebv

    fn = shard_map(
        kernel, mesh=mesh,
        in_specs=(P(None, axis), P(), P(), P(), P(), P()),
        out_specs=(P(), P()),
    )
    return fn(Xp, y, p_total, lam_f, tol, n_iter)


# ---------------------------------------------------------------------------
# Mesh-sharded GWAS scans (BASELINE config 4; reference hot loop
# src/gwas.jl:584 threads over markers — here the marker axis shards over
# 'mp' and each device scans its own block after ONE replicated eigh).
# ---------------------------------------------------------------------------


def _pad_markers(G: np.ndarray, D: int) -> Tuple[np.ndarray, int]:
    n, p = G.shape
    p_pad = ((p + D - 1) // D) * D
    if p_pad == p:
        return np.asarray(G, dtype=np.float32), p
    Gp = np.zeros((n, p_pad), dtype=np.float32)
    Gp[:, :p] = G
    return Gp, p


def sharded_gwasreml(
    G,
    y,
    K,
    mesh: Mesh,
    axis: str = "mp",
    n_grid: int = None,
    n_newton: int = None,
) -> np.ndarray:
    """Marker-sharded per-marker 2-VC REML scan (models/gwas.py:_reml_scan).

    The GRM eigendecomposition runs ONCE replicated; the rotation Gt = Uᵀ G
    is a local GEMM per device on its marker shard; the vmapped grid+Newton
    scan is embarrassingly marker-parallel, so D devices scan D× the
    markers/s with zero collectives after the eigh. Inputs are the
    standardized prep outputs (G, y, K) of `gwasprep`/`_prep_device`;
    returns the z-statistics (p,). Exactly matches the single-device
    `gwasreml` scan (tests/test_parallel.py)."""
    from ..utils.config import get_config

    cfg = get_config()
    n_grid = cfg.reml_grid if n_grid is None else n_grid
    n_newton = cfg.reml_newton if n_newton is None else n_newton
    D = mesh.shape[axis]
    Gp, p = _pad_markers(np.asarray(G, np.float32), D)
    z = _sharded_gwasreml_jit(
        jnp.asarray(Gp), jnp.asarray(y, jnp.float32), jnp.asarray(K, jnp.float32),
        mesh, axis, int(n_grid), int(n_newton),
    )
    return np.asarray(z, dtype=np.float64)[:p]


@partial(jax.jit, static_argnames=("mesh", "axis", "n_grid", "n_newton"))
def _sharded_gwasreml_jit(Gp, y, K, mesh: Mesh, axis: str, n_grid: int, n_newton: int):
    from ..models.gwas import _eigh_device, _reml_scan

    s, U = _eigh_device(K)  # replicated: one eigh, all devices share it
    yt = U.T @ y
    ones_t = U.T @ jnp.ones(y.shape[0], jnp.float32)

    def kernel(Gl, U, yt, ones_t, s):
        Gtl = jnp.dot(U.T, Gl, preferred_element_type=jnp.float32)  # local GEMM
        Xt_all = jnp.stack(
            [jnp.broadcast_to(ones_t[:, None], Gtl.shape), Gtl], axis=-1
        ).transpose(1, 0, 2)  # (p_local, n, 2)
        z, _ = _reml_scan(yt, Xt_all, s, n_grid=n_grid, n_newton=n_newton)
        return z

    fn = shard_map(
        kernel, mesh=mesh,
        in_specs=(P(None, axis), P(), P(), P(), P()),
        out_specs=P(axis),
    )
    return fn(Gp, U, yt, ones_t, s)


def sharded_gwasols(G, y, K, mesh: Mesh, axis: str = "mp") -> np.ndarray:
    """Marker-sharded GWAS-OLS t-scan (models/gwas.py:_gwasols_scan): the PC1
    covariate is computed replicated (50 power-iteration matvecs), then each
    device runs the closed-form Schur-complement scan on its marker shard."""
    D = mesh.shape[axis]
    Gp, p = _pad_markers(np.asarray(G, np.float32), D)
    t = _sharded_gwasols_jit(
        jnp.asarray(Gp), jnp.asarray(y, jnp.float32), jnp.asarray(K, jnp.float32),
        mesh, axis,
    )
    return np.asarray(t, dtype=np.float64)[:p]


@partial(jax.jit, static_argnames=("mesh", "axis"))
def _sharded_gwasols_jit(Gp, y, K, mesh: Mesh, axis: str):
    from ..models.gwas import _grm_pc1_device, _gwasols_scan

    pc1 = _grm_pc1_device(K)

    def kernel(Gl, y, pc1):
        return _gwasols_scan(Gl, y, pc1)

    fn = shard_map(
        kernel, mesh=mesh, in_specs=(P(None, axis), P(), P()), out_specs=P(axis)
    )
    return fn(Gp, y, pc1)


def sharded_gwaslmm(G, y, K, mesh: Mesh, axis: str = "mp") -> np.ndarray:
    """Marker-sharded EMMAX scan (models/gwas.py:gwaslmm): null-model REML
    (one replicated 2-VC solve) then the per-marker GLS z-scan sharded over
    the marker axis."""
    D = mesh.shape[axis]
    Gp, p = _pad_markers(np.asarray(G, np.float32), D)
    z = _sharded_gwaslmm_jit(
        jnp.asarray(Gp), jnp.asarray(y, jnp.float32), jnp.asarray(K, jnp.float32),
        mesh, axis,
    )
    return np.asarray(z, dtype=np.float64)[:p]


@partial(jax.jit, static_argnames=("mesh", "axis"))
def _sharded_gwaslmm_jit(Gp, y, K, mesh: Mesh, axis: str):
    from ..models.gwas import _eigh_device, _gls_scan, _grm_pc1_device, _reml_scan

    n = y.shape[0]
    pc1 = _grm_pc1_device(K)
    s, U = _eigh_device(K)
    yt = U.T @ y
    F = jnp.stack([jnp.ones(n, jnp.float32), pc1], axis=1)
    Ft = U.T @ F
    # Null-model fit pins the 16x16 fallback grid deliberately (single
    # design, accuracy over speed — see models/gwas.py:gwaslmm).
    _, theta = _reml_scan(yt, Ft[None, :, :], s)
    inv_d = 1.0 / (theta[0, 1] * s + theta[0, 0])

    def kernel(Gl, U, Ft, yt, inv_d):
        Gtl = jnp.dot(U.T, Gl, preferred_element_type=jnp.float32)
        return _gls_scan(Gtl, Ft, yt, inv_d)

    fn = shard_map(
        kernel, mesh=mesh,
        in_specs=(P(None, axis), P(), P(), P(), P()),
        out_specs=P(axis),
    )
    return fn(Gp, U, Ft, yt, inv_d)
