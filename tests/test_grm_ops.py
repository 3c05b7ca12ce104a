"""Triangular-blocked XLA GRM (ops/grm.py) vs dense reference."""

import numpy as np
import pytest


@pytest.mark.parametrize("n,nb", [(64, 4), (100, 3), (128, 8), (257, 4)])
def test_gram_triangular_matches_dense(n, nb):
    from genomicbreedingmodels_tpu.ops.grm import gram_triangular

    rng = np.random.default_rng(1)
    X = rng.random((n, 37)).astype(np.float32)
    K = np.asarray(gram_triangular(X, nb=nb))
    Z = X - X.mean(axis=0, keepdims=True)
    Kd = Z @ Z.T
    assert K.shape == (n, n)
    assert np.abs(K - Kd).max() < 1e-4


def test_gram_triangular_uncentered_and_default_nb():
    from genomicbreedingmodels_tpu.ops.grm import gram_triangular

    rng = np.random.default_rng(2)
    X = rng.random((96, 17)).astype(np.float32)
    K = np.asarray(gram_triangular(X, center=False))
    assert np.abs(K - X @ X.T).max() < 1e-4


def test_gram_centered_device_default_matches_dense():
    from genomicbreedingmodels_tpu.ops.grm import gram_centered_device

    rng = np.random.default_rng(3)
    X = rng.random((50, 20)).astype(np.float32)
    K = np.asarray(gram_centered_device(X))
    Z = X - X.mean(axis=0, keepdims=True)
    assert np.abs(K - Z @ Z.T).max() < 1e-4


@pytest.mark.parametrize("n,nb2", [(64, 4), (100, 3), (257, 4), (2048, None)])
def test_gram_panel_matches_dense(n, nb2):
    from genomicbreedingmodels_tpu.ops.grm import gram_panel

    rng = np.random.default_rng(6)
    X = rng.random((n, 41)).astype(np.float32)
    K = np.asarray(gram_panel(X, nb=nb2))
    Z = X - X.mean(axis=0, keepdims=True)
    Kd = Z @ Z.T
    assert K.shape == (n, n)
    assert np.abs(K - Kd).max() < 1e-3
    Kraw = np.asarray(gram_panel(X, center=False, nb=nb2))
    assert np.abs(Kraw - X @ X.T).max() < 1e-3


@pytest.mark.parametrize("n,depth", [(64, 2), (100, 3), (257, 2), (2048, None)])
def test_gram_recursive_matches_dense(n, depth):
    from genomicbreedingmodels_tpu.ops.grm import gram_recursive

    rng = np.random.default_rng(4)
    X = rng.random((n, 41)).astype(np.float32)
    K = np.asarray(gram_recursive(X, depth=depth))
    Z = X - X.mean(axis=0, keepdims=True)
    Kd = Z @ Z.T
    assert K.shape == (n, n)
    assert np.abs(K - Kd).max() < 1e-3
    Kraw = np.asarray(gram_recursive(X, center=False, depth=depth))
    assert np.abs(Kraw - X @ X.T).max() < 1e-3


def test_gram_recursive_algebraic_centering_beats_bf16_centering():
    """The rank-1 correction runs in f32 while operands stay bf16 — it must
    be substantially closer to the f64 dense reference than the naive
    bf16-subtract path."""
    import jax.numpy as jnp

    from genomicbreedingmodels_tpu.ops.grm import gram_recursive

    rng = np.random.default_rng(5)
    X64 = rng.random((128, 2048))
    Xb = jnp.asarray(X64, dtype=jnp.bfloat16)
    X64 = np.asarray(Xb, dtype=np.float64)  # what the device actually sees
    Z = X64 - X64.mean(axis=0, keepdims=True)
    K64 = Z @ Z.T
    K_alg = np.asarray(gram_recursive(Xb, depth=2), dtype=np.float64)
    mean_bf = np.asarray(jnp.asarray(X64.mean(axis=0), jnp.bfloat16), np.float64)
    Zb = np.asarray(jnp.asarray(X64 - mean_bf, jnp.bfloat16), np.float64)
    K_bf16 = Zb @ Zb.T
    den = np.abs(K64).max()
    err_alg = np.abs(K_alg - K64).max() / den
    err_bf16 = np.abs(K_bf16 - K64).max() / den
    assert err_alg < err_bf16 / 5
    assert err_alg < 1e-4


def test_encode_dosage_grid_detection():
    from genomicbreedingmodels_tpu.ops.grm import encode_dosage

    rng = np.random.default_rng(7)
    X = rng.integers(0, 3, size=(40, 23)).astype(np.float64) / 2.0
    D = encode_dosage(X, ploidy=2)
    assert D is not None and D.dtype == np.int8
    assert np.array_equal(D, (X * 2).astype(np.int8))
    # Off-grid (continuous) panel must be rejected.
    assert encode_dosage(rng.random((10, 5)), ploidy=2) is None
    # Tetraploid grid works at its own ploidy, fails at 2.
    X4 = rng.integers(0, 5, size=(12, 9)).astype(np.float64) / 4.0
    assert encode_dosage(X4, ploidy=4) is not None
    assert encode_dosage(X4, ploidy=2) is None


@pytest.mark.parametrize("n,ploidy", [(64, 2), (100, 4), (257, 2)])
def test_gram_dosage_exact(n, ploidy):
    """int8 dosage Gram is EXACT: equals the f64 dense centered Gram to f32
    rounding of the O(n²) centering epilogue only."""
    from genomicbreedingmodels_tpu.ops.grm import encode_dosage, gram_dosage

    rng = np.random.default_rng(8)
    X = rng.integers(0, ploidy + 1, size=(n, 53)).astype(np.float64) / ploidy
    D = encode_dosage(X, ploidy=ploidy)
    K = np.asarray(gram_dosage(D, ploidy=ploidy), dtype=np.float64)
    Z = X - X.mean(axis=0, keepdims=True)
    K64 = Z @ Z.T
    assert np.abs(K - K64).max() < 1e-5
    Kraw = np.asarray(gram_dosage(D, ploidy=ploidy, center=False), dtype=np.float64)
    assert np.abs(Kraw - X @ X.T).max() < 1e-6


def test_gram_auto_dispatch():
    from genomicbreedingmodels_tpu.ops.grm import gram_auto

    rng = np.random.default_rng(9)
    Xd = rng.integers(0, 3, size=(32, 17)).astype(np.float64) / 2.0
    Zd = Xd - Xd.mean(axis=0, keepdims=True)
    assert np.abs(np.asarray(gram_auto(Xd)) - Zd @ Zd.T).max() < 1e-5
    Xc = rng.random((32, 17)).astype(np.float32)
    Zc = Xc - Xc.mean(axis=0, keepdims=True)
    assert np.abs(np.asarray(gram_auto(Xc)) - Zc @ Zc.T).max() < 1e-3


def test_grm_simple_uses_exact_dosage_path():
    """grm_simple on a called-genotype panel routes through the int8 path and
    matches the f64 VanRaden GRM essentially exactly."""
    from genomicbreedingmodels_tpu.core.grm import grm_simple
    from genomicbreedingmodels_tpu.core.structs import Genomes

    rng = np.random.default_rng(10)
    n, p = 24, 31
    X = rng.integers(0, 3, size=(n, p)).astype(np.float64) / 2.0
    g = Genomes(
        entries=np.asarray([f"e{i}" for i in range(n)], dtype=object),
        populations=np.asarray(["pop"] * n, dtype=object),
        loci_alleles=np.asarray([f"l{j}" for j in range(p)], dtype=object),
        allele_frequencies=X,
    )
    K = grm_simple(g).genomic_relationship_matrix
    mu = X.mean(axis=0)
    Z = X - mu
    denom = 2.0 * float(np.sum(mu * (1 - mu)))
    assert np.abs(K - (Z @ Z.T) / denom).max() < 1e-6


@pytest.mark.parametrize("n,p", [(64, 512), (100, 300), (129, 257)])
def test_gram_dosage_matches_int64_oracle(n, p):
    """The exact int8 syrk at ragged shapes (n not a multiple of the panel
    count) against an int64 numpy Gram, double-centered in f64."""
    from genomicbreedingmodels_tpu.ops.grm import gram_dosage

    rng = np.random.default_rng(1)
    D = rng.integers(0, 3, size=(n, p)).astype(np.int8)
    G = D.astype(np.int64) @ D.astype(np.int64).T
    raw = np.asarray(gram_dosage(D, ploidy=2, center=False, nb=3))
    np.testing.assert_array_equal(raw * 4, G.astype(np.float64))
    K = G / 4.0
    rm = K.mean(axis=1)
    Kc = K - rm[:, None] - rm[None, :] + rm.mean()
    assert np.abs(np.asarray(gram_dosage(D, ploidy=2)) - Kc).max() < 1e-3 * np.abs(Kc).max()


@pytest.mark.parametrize("n,p,nb", [(64, 512, 4), (100, 300, 3), (131, 77, 5)])
def test_gram_dosage_lower_matches_int64_oracle(n, p, nb):
    """Lower-triangle-only centered Gram: the lower triangle equals the
    centered int64 oracle; the int32 panel triangle is bit-exact."""
    from genomicbreedingmodels_tpu.ops.grm import _gram_panel_int8_lower, gram_dosage_lower

    rng = np.random.default_rng(2)
    D = rng.integers(0, 3, size=(n, p)).astype(np.int8)
    G = D.astype(np.int64) @ D.astype(np.int64).T
    np.testing.assert_array_equal(np.asarray(_gram_panel_int8_lower(D, nb)), np.tril(G))
    K = G / 4.0
    rm = K.mean(axis=1)
    Kc = K - rm[:, None] - rm[None, :] + rm.mean()
    L = np.asarray(gram_dosage_lower(D, ploidy=2, nb=nb))
    lo = np.tril_indices(n)
    assert np.abs(L[lo] - Kc[lo]).max() < 1e-3 * np.abs(Kc).max()
