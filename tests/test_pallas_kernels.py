"""Grouped BayesB/C block kernel (ops/pallas_gibbs.py): the Pallas kernel in
interpret mode against a from-scratch f64 oracle and against the XLA scan,
plus the wrapper's shape rule. The compiled kernel runs on the card
(`gpu` marker here; chip_smoke.py phase 2 at the real block width)."""

import numpy as np
import pytest


def _block_case(K, bs, n=40, seed=0):
    """A block with a few invalid (padding) markers and its sweep tables."""
    import jax.numpy as jnp

    from genomicbreedingmodels_tpu.ops.pallas_gibbs import build_group_tables, group_patterns

    rng = np.random.default_rng(seed)
    G = bs // K
    X = rng.normal(size=(n, bs)).astype(np.float32)
    Cb = (X.T @ X).astype(np.float32)
    u = rng.normal(size=bs).astype(np.float32) * 3
    b = (rng.normal(size=bs) * (rng.random(bs) < 0.3)).astype(np.float32)
    s2 = np.full(bs, 0.4, np.float32)
    val = np.ones(bs, np.float32)
    val[-3:] = 0.0
    eta = rng.normal(size=bs).astype(np.float32)
    gum = -np.log(-np.log(rng.random((G, 1 << K)).astype(np.float32) + 1e-12))
    sig_e2, pi_in = np.float32(0.8), np.float32(0.3)
    W, const = build_group_tables(
        jnp.asarray(Cb)[None], jnp.asarray(s2), jnp.asarray(val),
        jnp.float32(sig_e2), jnp.float32(pi_in), group_patterns(K),
    )
    args = (jnp.asarray(Cb), jnp.asarray(u), jnp.asarray(b), jnp.asarray(val),
            jnp.asarray(eta), W[0], const[0] + jnp.asarray(gum), jnp.float32(sig_e2))
    raw = dict(Cb=Cb, u=u, b=b, s2=s2, val=val, eta=eta, gum=gum, sig_e2=sig_e2, pi_in=pi_in)
    return args, raw


def _f64_oracle(K, raw):
    """The partially-collapsed grouped update law, one group at a time in f64:
    score all 2^K patterns by the collapsed likelihood, Gumbel-max, joint
    K-dim draw, rank-K correction."""
    Cb64, u64 = raw["Cb"].astype(np.float64), raw["u"].astype(np.float64)
    b_ref = raw["b"].astype(np.float64).copy()
    val, s2, eta, gum = raw["val"], raw["s2"], raw["eta"], raw["gum"]
    sig_e2, pi_in = raw["sig_e2"], raw["pi_in"]
    bs = len(u64)
    patterns = ((np.arange(1 << K)[:, None] >> np.arange(K)[None, :]) & 1).astype(np.float64)
    cdelta = np.zeros(bs)
    d_ref = np.zeros(bs)
    incl_ref = np.zeros(bs)
    for g in range(bs // K):
        r0 = g * K
        C_gg = Cb64[r0:r0 + K, r0:r0 + K]
        v = (u64[r0:r0 + K] - cdelta[r0:r0 + K] + C_gg @ b_ref[r0:r0 + K]) / sig_e2
        val_g, s2_g = val[r0:r0 + K].astype(np.float64), s2[r0:r0 + K].astype(np.float64)
        logws = np.zeros(1 << K)
        cand = []
        for m in range(1 << K):
            Mg = patterns[m] * val_g
            P = (C_gg / sig_e2) * np.outer(Mg, Mg) + np.diag(np.where(Mg > 0, 1 / s2_g, 1.0))
            L = np.linalg.cholesky(P)
            w = np.linalg.solve(L, np.where(Mg > 0, v, 0.0))
            logws[m] = (
                Mg.sum() * np.log(pi_in)
                + (val_g * (1 - patterns[m])).sum() * np.log1p(-pi_in)
                - 0.5 * np.sum(np.where(Mg > 0, np.log(s2_g), 0.0))
                - np.sum(np.log(np.diag(L))) + 0.5 * w @ w
                - 1e30 * np.sum(patterns[m] * (1 - val_g))
            )
            cand.append((L, w, Mg))
        L, w, Mg = cand[np.argmax(logws + gum[g])]
        b_new = np.where(Mg > 0, np.linalg.solve(L.T, w + eta[r0:r0 + K]), 0.0)
        dd = b_new - b_ref[r0:r0 + K]
        cdelta += dd @ Cb64[r0:r0 + K, :]
        d_ref[r0:r0 + K] = dd
        b_ref[r0:r0 + K] = b_new
        incl_ref[r0:r0 + K] = Mg > 0
    return d_ref, b_ref, incl_ref


@pytest.mark.parametrize("K", [4, 6, 8])
def test_grouped_block_update_matches_f64_oracle(K):
    """Kernel (interpret mode) vs a from-scratch f64 numpy implementation of
    the same update law: identical pattern selections and draws to f32
    rounding, invalid markers pinned to zero. K=6 pads to KP=8 inside the
    kernel; bs=48 pads to BSP=64."""
    from genomicbreedingmodels_tpu.ops.pallas_gibbs import grouped_block_update

    bs = 8 * K
    args, raw = _block_case(K, bs)
    d, bn, incl = (np.asarray(a) for a in grouped_block_update(*args, interpret=True))
    assert np.all(bn[-3:] == 0)
    d_ref, b_ref, incl_ref = _f64_oracle(K, raw)
    np.testing.assert_allclose(d, d_ref, atol=5e-6)
    np.testing.assert_allclose(bn, b_ref, atol=5e-6)
    assert np.all(incl_ref == incl)


@pytest.mark.parametrize("K,bs", [(6, 96), (5, 40)])
def test_grouped_block_update_matches_xla_scan(K, bs):
    """The kernel and the sampler's XLA scan (grouped_block_reference) take
    the same inputs and make the same draws — what the sampler swaps
    between on the GPU and elsewhere."""
    from genomicbreedingmodels_tpu.ops.pallas_gibbs import (
        group_patterns,
        grouped_block_reference,
        grouped_block_update,
    )

    args, _ = _block_case(K, bs, seed=3)
    dk, bk, ik = (np.asarray(a) for a in grouped_block_update(*args, interpret=True))
    dr, br, ir = (np.asarray(a) for a in grouped_block_reference(*args, group_patterns(K)))
    assert ik.dtype == ir.dtype == np.bool_
    np.testing.assert_array_equal(ik, ir)
    np.testing.assert_allclose(bk, br, atol=2e-6)
    np.testing.assert_allclose(dk, dr, atol=2e-6)


def test_grouped_block_update_rejects_sub_lane_K_on_hardware():
    """The wrapper's shape rule: Triton needs power-of-two tensor widths, so
    K (including the K < 8 the old lane rule refused) pads to the next power
    of two and the block width likewise; K beyond the register budget and
    blocks that are not whole groups are refused with a ValueError."""
    import jax.numpy as jnp

    from genomicbreedingmodels_tpu.ops.pallas_gibbs import (
        MAX_GROUP_SIZE,
        grouped_block_update,
        kernel_dims,
    )

    assert kernel_dims(6, 600) == (8, 1024)
    assert kernel_dims(4, 256) == (4, 256)
    assert kernel_dims(3, 24) == (4, 32)
    assert kernel_dims(1, 5) == (1, 8)
    with pytest.raises(ValueError, match="group sizes"):
        kernel_dims(MAX_GROUP_SIZE + 1, 9 * (MAX_GROUP_SIZE + 1))
    with pytest.raises(ValueError, match="multiple of the group size"):
        kernel_dims(6, 100)
    # Tables that do not match the block are refused before any lowering.
    K, bs = 4, 16
    W = jnp.zeros((bs // K, 1 << K, K, K))
    with pytest.raises(ValueError, match="do not match"):
        grouped_block_update(
            jnp.eye(bs + K), jnp.zeros(bs + K), jnp.zeros(bs + K), jnp.ones(bs + K),
            jnp.zeros(bs + K), W, jnp.zeros((bs // K, 1 << K)), jnp.float32(1.0),
            interpret=True,
        )


def test_grouped_block_update_refuses_cpu_without_interpret():
    """Only a test asks for the interpreter: a compiled call on the CPU is a
    ValueError, never a silent interpret-mode fallback."""
    from genomicbreedingmodels_tpu.ops.pallas_gibbs import grouped_block_update

    args, _ = _block_case(4, 16)
    with pytest.raises(ValueError, match="CUDA GPU"):
        grouped_block_update(*args)


@pytest.mark.gpu
def test_grouped_block_update_compiled_matches_xla_scan():
    """The Triton-compiled kernel on the card against the XLA scan."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU (chip_smoke.py phase 2 runs this on the card)")
    from genomicbreedingmodels_tpu.ops.pallas_gibbs import (
        group_patterns,
        grouped_block_reference,
        grouped_block_update,
    )

    args, _ = _block_case(6, 600, n=200, seed=5)
    _, bk, ik = (np.asarray(a) for a in grouped_block_update(*args))
    _, br, ir = (np.asarray(a) for a in grouped_block_reference(*args, group_patterns(6)))
    np.testing.assert_array_equal(ik, ir)
    np.testing.assert_allclose(bk, br, atol=1e-5)


def _fold_batch(F=3, K=6, bs=48):
    """F blocks (one per CV fold) stacked on a leading axis."""
    import jax.numpy as jnp

    cases = [_block_case(K, bs, seed=10 + f)[0] for f in range(F)]
    return tuple(jnp.stack(parts) for parts in zip(*cases))


def test_grouped_block_update_vmapped_over_folds_matches_xla_scan():
    """vmapped over CV-fold chains the kernel takes a leading grid axis, one
    program per fold; each fold's draws are the XLA scan's for that fold."""
    import jax

    from genomicbreedingmodels_tpu.ops.pallas_gibbs import (
        group_patterns,
        grouped_block_reference,
        grouped_block_update,
    )

    bargs = _fold_batch()
    dk, bk, ik = jax.vmap(lambda *a: grouped_block_update(*a, interpret=True))(*bargs)
    for f in range(bargs[0].shape[0]):
        dr, br, ir = grouped_block_reference(*(a[f] for a in bargs), group_patterns(6))
        np.testing.assert_array_equal(np.asarray(ik[f]), np.asarray(ir))
        np.testing.assert_allclose(np.asarray(bk[f]), np.asarray(br), atol=2e-6)
        np.testing.assert_allclose(np.asarray(dk[f]), np.asarray(dr), atol=2e-6)


def test_grouped_block_update_vmapped_lowers_to_one_triton_launch(monkeypatch):
    """For a CUDA target the vmapped kernel lowers to ONE Triton call whose
    grid has one program per fold (lowering needs no card)."""
    import jax

    from genomicbreedingmodels_tpu.ops.pallas_gibbs import grouped_block_update
    from genomicbreedingmodels_tpu.utils import backend

    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    bargs = _fold_batch(F=5)
    text = (
        jax.jit(jax.vmap(grouped_block_update)).trace(*bargs)
        .lower(lowering_platforms=("cuda",)).as_text()
    )
    calls = [ln for ln in text.splitlines() if "xla.gpu.triton" in ln]
    assert len(calls) == 1
    assert "grid_x = 5 " in calls[0] and "grid_y = 1 " in calls[0]
