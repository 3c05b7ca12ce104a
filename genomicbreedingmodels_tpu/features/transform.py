"""Epistasis feature engineering (reference src/transformation.jl).

- `transform1` (reference :130-238): the reference fits a 1-locus OLS *per
  column* in a Python... Julia loop. Here the per-feature effect is the
  closed-form simple-regression slope β = Σ(t-t̄)(y-ȳ)/Σ(t-t̄)², computed for
  every transformed column in one batched device pass (blocked over columns).
- `transform2` (reference :319-468): the l² ordered-pair scan runs as blocked
  outer-product batches on device with a running top-k merge, so memory stays
  O(n · block · l) regardless of l².
- `epistasisfeatures` (reference :540-668): n_reps rounds over the unary +
  binary transformation sets, appending deduplicated features.
- `reconstitutefeatures` (reference :730-778): the reference re-evaluates
  feature-name strings with per-entry string substitution + eval. Here the
  names are parsed ONCE into expression trees and evaluated vectorized over
  entries (same serialization format, no eval).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core.structs import Genomes, Phenomes
from ..prediction import extractxyetc
from ..utils.devcache import SingleSlotCache, host_fingerprint
from .endofunctions import BINARY_DEFAULTS, FUNCTION_REGISTRY, UNARY_DEFAULTS, registry_name

# Padded device panel of the most recent transform2 GEMM scan.
_T2_PANEL_CACHE = SingleSlotCache()

__all__ = [
    "transform1",
    "transform2",
    "epistasisfeatures",
    "reconstitutefeatures",
    "parse_feature_name",
]

_EPS = np.finfo(np.float64).eps


def _slopes(T: np.ndarray, y: np.ndarray, var_threshold: float) -> np.ndarray:
    """Simple-regression slopes of y on each column of T (batched, device)."""

    @jax.jit
    def _k(T, y):
        Tm = T - jnp.mean(T, axis=0, keepdims=True)
        ym = y - jnp.mean(y)
        ss = jnp.sum(Tm * Tm, axis=0)
        beta = jnp.dot(Tm.T, ym, preferred_element_type=jnp.float32) / jnp.maximum(ss, 1e-30)
        return beta, ss / jnp.maximum(T.shape[0] - 1, 1)

    beta, var = _k(jnp.asarray(T, jnp.float32), jnp.asarray(y, jnp.float32))
    beta = np.asarray(beta, dtype=np.float64)
    beta[np.asarray(var) < var_threshold] = 0.0
    return beta


def _snap(T: np.ndarray, eps: float) -> np.ndarray:
    T = T.copy()
    T[np.abs(T) < eps] = 0.0
    T[np.abs(T - 1.0) < eps] = 1.0
    return T


def _input_var_mask(X: np.ndarray, threshold: float) -> np.ndarray:
    return np.var(X, axis=0, ddof=1) >= threshold


def transform1(
    f: Callable,
    genomes: Genomes,
    phenomes: Phenomes,
    idx_trait: int = 0,
    idx_entries: Optional[Sequence[int]] = None,
    idx_loci_alleles: Optional[Sequence[int]] = None,
    n_new_features_per_transformation: int = 1_000,
    eps: float = _EPS,
    use_abs: bool = False,
    var_threshold: float = 0.01,
    verbose: bool = False,
) -> Genomes:
    """Apply a unary transform to every locus, rank by single-locus effect
    (reference src/transformation.jl:130-238). Skip criterion: INPUT column
    variance < var_threshold, as in the reference (:181)."""
    X, y, entries, populations, loci_alleles = extractxyetc(
        genomes, phenomes, idx_entries=idx_entries, idx_loci_alleles=idx_loci_alleles,
        idx_trait=idx_trait, add_intercept=False,
    )
    X = X + eps
    if use_abs:
        X = np.abs(X)
    try:
        T = np.asarray(f(X), dtype=np.float64)
    except Exception as err:
        raise ValueError(
            f"cannot transform allele frequencies with {registry_name(f)!r}: {err}; "
            "the function must accept a single array argument"
        ) from err
    beta = _slopes(T, y, var_threshold=0.0)
    beta[~_input_var_mask(X, var_threshold)] = 0.0
    order = np.argsort(-np.abs(beta), kind="stable")[:n_new_features_per_transformation]
    keep = order[np.abs(beta[order]) > eps]
    Tk = _snap(T[:, keep], eps)
    fname = registry_name(f)
    names = np.asarray([f"{fname}({loc})" for loc in loci_alleles[keep]], dtype=object)
    out = Genomes(
        entries=entries, populations=populations, loci_alleles=names, allele_frequencies=Tk
    )
    if not out.checkdims():
        raise RuntimeError(f"error transforming loci with {fname!r}")
    return out


def _beta_mask_topk(beta, okb, okall, row0, commutative: bool, k: int):
    """Zero masked/lower-triangle slopes, then take the block's top-k |slope|
    on device: only k (value, flat-index) pairs are returned to the host.

    EXACT two-stage top-k: per-row top-min(k, l) over the last axis first,
    then one flat top-k over the bi·k survivors. The block's true top-k is a
    subset of the per-row top-k union, so this equals the flat top-k over
    all bi·l slopes — but XLA's TopK lowers to a sort, and sorting the full
    block costs far more than the three GEMMs that produce it.
    """
    bi, l = beta.shape
    beta = jnp.where(okb[:, None] & okall[None, :], beta, 0.0)
    if commutative:
        rows = row0 + jnp.arange(bi)
        beta = jnp.where(jnp.arange(l)[None, :] < rows[:, None], 0.0, beta)
    k_row = min(k, l)
    if bi * k_row < bi * l:
        vals_r, idx_r = jax.lax.top_k(jnp.abs(beta), k_row)  # (bi, k_row)
        flat_idx = (jnp.arange(bi, dtype=jnp.int32)[:, None] * l + idx_r).reshape(-1)
        cand = jnp.take_along_axis(beta, idx_r, axis=1).reshape(-1)
        _, sel = jax.lax.top_k(vals_r.reshape(-1), k)
        return cand[sel], flat_idx[sel]
    flat = beta.reshape(-1)
    _, idx = jax.lax.top_k(jnp.abs(flat), k)
    return flat[idx], idx


@partial(jax.jit, static_argnames=("f", "commutative", "k"))
def _generic_block_topk(Xblk, Xj, ymj, okb, okall, row0, f: Callable,
                        commutative: bool, k: int):
    """Arbitrary binary transform: materialize the block's (n, bi·l) pair
    tensor and run one batched slope pass. f is a static (hashable) arg so
    repeated calls with the same transform hit the jit cache."""
    n = Xj.shape[0]
    P = f(Xblk[:, :, None], Xj[:, None, :]).reshape(n, -1)
    Pm = P - jnp.mean(P, axis=0, keepdims=True)
    ss = jnp.sum(Pm * Pm, axis=0)
    beta = jnp.dot(Pm.T, ymj, preferred_element_type=jnp.float32) / jnp.maximum(ss, 1e-30)
    return _beta_mask_topk(beta.reshape(Xblk.shape[1], -1), okb, okall, row0, commutative, k)


def _pairs_topk_sharded(
    Xp, ymj, okp, mesh, axis: str, kern_name: str, commutative: bool,
    k: int, rows_per_chunk: int,
):
    """Mesh-sharded all-pairs slope scan: the pair-matrix BLOCK-ROW ranges
    are partitioned over the mesh axis (each device owns l_pad/D row loci,
    sees the full column panel replicated), every device runs the same
    GEMM-formula row-chunk scan with an ON-DEVICE running top-k, and only
    D·k (value, global-flat-index) pairs return to the host for the final
    merge — the same merge semantics as the single-device block loop.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    n, l_pad = Xp.shape
    D = mesh.shape[axis]
    lp = l_pad // D

    def kernel(Xl, Xfull, ym, okl, okfull):
        dev = jax.lax.axis_index(axis)
        tv, tr, tc = _chunk_topk_scan(
            Xl, Xfull, ym, okl, okfull, dev * lp,
            kern_name=kern_name, commutative=commutative, k=k,
            rows_per_chunk=rows_per_chunk, vary_axis=axis,
        )
        return tv[None], tr[None], tc[None]

    vals, rows, cols = shard_map(
        kernel, mesh=mesh,
        in_specs=(P(None, axis), P(), P(), P(axis), P()),
        out_specs=(P(axis), P(axis), P(axis)),
    )(Xp, Xp, ymj, okp, okp)
    return (
        np.asarray(vals).reshape(-1),
        np.asarray(rows, dtype=np.int64).reshape(-1),
        np.asarray(cols, dtype=np.int64).reshape(-1),
    )


def _chunk_topk_scan(
    Xl, Xfull, ym, okl, okfull, row_dev0, *, kern_name: str,
    commutative: bool, k: int, rows_per_chunk: int, vary_axis=None,
):
    """ONE device program for a row-range's whole pair scan: lax.scan over
    row chunks, each chunk scoring its (rc × l_pad) slopes by the GEMM
    formula and merging into an on-device running top-k. Only k (value,
    row, col) triples ever reach the host, instead of 2 readbacks per block
    for a host-side merge. Shared by the single-device path and
    the shard_map kernel (`vary_axis` marks the carry device-varying).
    Per-chunk top-k is the exact two-stage form (per-row, then merge):
    XLA lowers TopK to a sort, and sorting the flat chunk costs more than
    its GEMMs."""
    n = Xl.shape[0]
    l_pad = Xfull.shape[1]
    n_chunks = Xl.shape[1] // rows_per_chunk
    k_row = min(k, l_pad)

    def chunk_step(carry, c):
        tv, tr, tc = carry
        r0 = c * rows_per_chunk
        Xblk = jax.lax.dynamic_slice(Xl, (0, r0), (n, rows_per_chunk))
        okb = jax.lax.dynamic_slice(okl, (r0,), (rows_per_chunk,))
        row0 = row_dev0 + r0
        if kern_name == "mult":
            Nm = jnp.dot((Xblk * ym[:, None]).T, Xfull, preferred_element_type=jnp.float32)
            S1 = jnp.dot(Xblk.T, Xfull, preferred_element_type=jnp.float32)
            Q = jnp.dot((Xblk * Xblk).T, Xfull * Xfull, preferred_element_type=jnp.float32)
            den = Q - S1 * S1 / n
            beta = Nm / jnp.maximum(den, 1e-30)
        else:  # addnorm
            u = jnp.dot(Xfull.T, ym, preferred_element_type=jnp.float32)
            s = jnp.sum(Xfull, axis=0)
            q = jnp.sum(Xfull * Xfull, axis=0)
            ub = jax.lax.dynamic_slice(u, (row0,), (rows_per_chunk,))
            sb = jax.lax.dynamic_slice(s, (row0,), (rows_per_chunk,))
            qb = jax.lax.dynamic_slice(q, (row0,), (rows_per_chunk,))
            S1 = jnp.dot(Xblk.T, Xfull, preferred_element_type=jnp.float32)
            num = 0.5 * (ub[:, None] + u[None, :])
            st = 0.5 * (sb[:, None] + s[None, :])
            st2 = 0.25 * (qb[:, None] + 2.0 * S1 + q[None, :])
            den = st2 - st * st / n
            beta = num / jnp.maximum(den, 1e-30)
        beta = jnp.where(okb[:, None] & okfull[None, :], beta, 0.0)
        if commutative:
            rows = row0 + jnp.arange(rows_per_chunk)
            beta = jnp.where(jnp.arange(l_pad)[None, :] < rows[:, None], 0.0, beta)
        # Exact two-stage top-k of the chunk (row-wise, then across rows).
        vals_r, idx_r = jax.lax.top_k(jnp.abs(beta), k_row)  # (rc, k_row)
        cand = jnp.take_along_axis(beta, idx_r, axis=1)
        _, sel0 = jax.lax.top_k(vals_r.reshape(-1), min(k, rows_per_chunk * k_row))
        # Carry (row, col) as separate int32s: a flat l_pad² index would
        # overflow int32 beyond l≈46k and x64 is disabled under jit.
        grow = (row0 + sel0 // k_row).astype(jnp.int32)
        gcol = idx_r.reshape(-1)[sel0].astype(jnp.int32)
        cv = cand.reshape(-1)[sel0]
        pad = k - cv.shape[0]
        if pad > 0:
            cv = jnp.concatenate([cv, jnp.zeros((pad,), jnp.float32)])
            grow = jnp.concatenate([grow, jnp.zeros((pad,), jnp.int32)])
            gcol = jnp.concatenate([gcol, jnp.zeros((pad,), jnp.int32)])
        mv = jnp.concatenate([tv, cv])
        mr = jnp.concatenate([tr, grow])
        mc = jnp.concatenate([tc, gcol])
        _, sel = jax.lax.top_k(jnp.abs(mv), k)
        return (mv[sel], mr[sel], mc[sel]), None

    def _vary(v):
        if vary_axis is None:
            return v
        try:  # shard_map VMA typing: the carry becomes device-varying
            return jax.lax.pcast(v, (vary_axis,), to="varying")
        except ValueError:
            return v

    init = (
        _vary(jnp.zeros((k,), jnp.float32)),
        _vary(jnp.zeros((k,), jnp.int32)),
        _vary(jnp.zeros((k,), jnp.int32)),
    )
    (tv, tr, tc), _ = jax.lax.scan(chunk_step, init, jnp.arange(n_chunks))
    return tv, tr, tc


@partial(jax.jit, static_argnames=("kern_name", "commutative", "k", "rows_per_chunk"))
def _pairs_topk_single(Xp, ymj, okp, kern_name: str, commutative: bool,
                       k: int, rows_per_chunk: int):
    """Whole single-device pair scan as ONE program (see _chunk_topk_scan)."""
    return _chunk_topk_scan(
        Xp, Xp, ymj, okp, okp, 0,
        kern_name=kern_name, commutative=commutative, k=k,
        rows_per_chunk=rows_per_chunk,
    )


def transform2(
    f: Callable,
    genomes: Genomes,
    phenomes: Phenomes,
    idx_trait: int = 0,
    idx_entries: Optional[Sequence[int]] = None,
    idx_loci_alleles: Optional[Sequence[int]] = None,
    n_new_features_per_transformation: int = 1_000,
    eps: float = _EPS,
    use_abs: bool = False,
    var_threshold: float = 0.01,
    commutative: bool = False,
    block: int = 64,
    mesh=None,
    verbose: bool = False,
) -> Genomes:
    """Apply a binary transform to every ordered locus pair, rank effects
    (reference src/transformation.jl:319-468). With `mesh` (and a GEMM
    kernel transform — mult/addnorm), the pair-matrix block rows are
    sharded over the mesh's last axis with per-device on-device top-k and
    a host merge; other transforms fall back to the single-device loop."""
    X, y, entries, populations, loci_alleles = extractxyetc(
        genomes, phenomes, idx_entries=idx_entries, idx_loci_alleles=idx_loci_alleles,
        idx_trait=idx_trait, add_intercept=False,
    )
    X = X + eps
    if use_abs:
        X = np.abs(X)
    n, l = X.shape
    ok = _input_var_mask(X, var_threshold)
    k_cap = int(n_new_features_per_transformation)

    ym = y - y.mean()
    Xj = jnp.asarray(X, jnp.float32)
    ymj = jnp.asarray(ym, jnp.float32)
    okj = jnp.asarray(ok)
    fname_dispatch = registry_name(f)

    if fname_dispatch in ("mult", "addnorm"):
        # GEMM kernels: the WHOLE scan is one device program (single device
        # or mesh-sharded) with an on-device running top-k — a single host
        # readback of k triples instead of 2 per block.
        import math

        if mesh is not None:
            axis = list(mesh.shape.keys())[-1]
            D = mesh.shape[axis]
        else:
            D = 1
        rc = 128
        l_pad = int(math.ceil(l / (D * rc)) * D * rc)
        # Repeated scans on one panel (epistasisfeatures' n_reps rounds over
        # the SAME growing genomes run the scan per transformation; warm
        # benches) reuse the padded device panel: single-slot,
        # fingerprint-keyed (utils/devcache.py).
        fp = (host_fingerprint(X), l_pad, "t2")
        Xdev = _T2_PANEL_CACHE.get(fp)
        if Xdev is None:
            Xpad = np.zeros((n, l_pad), dtype=np.float32)
            Xpad[:, :l] = X
            Xdev = _T2_PANEL_CACHE.put(fp, jnp.asarray(Xpad))
        okpad = np.zeros(l_pad, dtype=bool)
        okpad[:l] = ok
        k = int(min(k_cap, rc * l_pad))
        if k < k_cap and l * l > k:
            # The running top-k carry holds rc*l_pad candidates; a request
            # beyond that would silently truncate, so say so (raising would
            # be hostile — the caller still gets the best k of all pairs).
            import warnings

            warnings.warn(
                f"transform2: n_new_features_per_transformation={k_cap} exceeds "
                f"the GEMM scan's running top-k capacity {k} (= {rc}*l_pad); "
                f"returning the top {k} pairs only",
                RuntimeWarning,
                stacklevel=2,
            )
        if mesh is not None:
            vals, ii_all, jj_all = _pairs_topk_sharded(
                Xdev, ymj, jnp.asarray(okpad), mesh, axis,
                fname_dispatch, commutative, k, rc,
            )
        else:
            tv, tr, tc = _pairs_topk_single(
                Xdev, ymj, jnp.asarray(okpad),
                fname_dispatch, commutative, k, rc,
            )
            vals = np.asarray(tv)
            ii_all = np.asarray(tr, dtype=np.int64)
            jj_all = np.asarray(tc, dtype=np.int64)
        real = (ii_all < l) & (jj_all < l)
        vals, ii_all, jj_all = vals[real], ii_all[real], jj_all[real]
        sel = np.argsort(-np.abs(vals), kind="stable")[:k_cap]
        top_idx = ii_all[sel] * np.int64(l) + jj_all[sel]
        top_beta = vals[sel].astype(np.float64)
        keep_mask = np.abs(top_beta) > eps
        sel_idx = np.sort(top_idx[keep_mask])
        return _materialize_pairs(
            f, X, sel_idx, l, eps, entries, populations, loci_alleles
        )

    # Generic (arbitrary f) path: running top-k merge across blocks (flat
    # index = i * l + j). Each block's candidate top-k is selected ON DEVICE
    # (lax.top_k) so only k (value, index) pairs cross the host link per
    # block instead of bi·l slopes.
    top_idx = np.zeros(0, dtype=np.int64)
    top_beta = np.zeros(0, dtype=np.float64)
    for start in range(0, l, block):
        bi = min(block, l - start)
        k = int(min(k_cap, bi * l))
        args = (Xj[:, start : start + bi], Xj, ymj, okj[start : start + bi], okj,
                jnp.int32(start))
        vals, idx = _generic_block_topk(f=f, *args, commutative=commutative, k=k)
        cand_idx = np.int64(start) * l + np.asarray(idx, dtype=np.int64)
        merged_idx = np.concatenate([top_idx, cand_idx])
        merged_beta = np.concatenate([top_beta, np.asarray(vals, dtype=np.float64)])
        sel = np.argsort(-np.abs(merged_beta), kind="stable")[: k_cap]
        top_idx, top_beta = merged_idx[sel], merged_beta[sel]

    keep_mask = np.abs(top_beta) > eps
    sel_idx = np.sort(top_idx[keep_mask])  # reference sorts selected flat indices (:429)
    return _materialize_pairs(f, X, sel_idx, l, eps, entries, populations, loci_alleles)


def _materialize_pairs(f, X, sel_idx, l, eps, entries, populations, loci_alleles) -> Genomes:
    ii = sel_idx // l
    jj = sel_idx % l
    T = np.asarray(f(X[:, ii], X[:, jj]), dtype=np.float64)
    T = _snap(T, eps)
    fname = registry_name(f)
    names = np.asarray(
        [f"{fname}({loci_alleles[a]},{loci_alleles[b]})" for a, b in zip(ii, jj)], dtype=object
    )
    out = Genomes(entries=entries, populations=populations, loci_alleles=names, allele_frequencies=T)
    if not out.checkdims():
        raise RuntimeError(f"error transforming locus pairs with {fname!r}")
    return out


def epistasisfeatures(
    genomes: Genomes,
    phenomes: Phenomes,
    idx_trait: int = 0,
    idx_entries: Optional[Sequence[int]] = None,
    idx_loci_alleles: Optional[Sequence[int]] = None,
    transformations1: Sequence[Callable] = UNARY_DEFAULTS,
    transformations2: Sequence[Callable] = BINARY_DEFAULTS,
    n_new_features_per_transformation: int = 1_000,
    n_reps: int = 3,
    verbose: bool = False,
) -> Genomes:
    """Grow a genomes struct with engineered epistasis features
    (reference src/transformation.jl:540-668)."""
    if not genomes.checkdims():
        raise ValueError("the Genomes struct is corrupted")
    if not phenomes.checkdims():
        raise ValueError("the Phenomes struct is corrupted")
    if not np.array_equal(genomes.entries, phenomes.entries):
        raise ValueError("genomes and phenomes must be merged to have consistent entries")
    g = genomes.slice(idx_entries=idx_entries, idx_loci_alleles=idx_loci_alleles)
    ph = phenomes.slice(
        idx_entries=idx_entries,
        idx_traits=[idx_trait],
    )
    for _rep in range(n_reps):
        for f in list(transformations1) + list(transformations2):
            unary = f in tuple(transformations1)
            tf = transform1 if unary else transform2
            new = tf(
                f, g, ph,
                idx_trait=0,
                n_new_features_per_transformation=n_new_features_per_transformation,
            )
            existing = set(g.loci_alleles.tolist())
            fresh = [i for i, nm in enumerate(new.loci_alleles.tolist()) if nm not in existing]
            if fresh:
                g = Genomes(
                    entries=g.entries,
                    populations=g.populations,
                    loci_alleles=np.concatenate([g.loci_alleles, new.loci_alleles[fresh]]),
                    allele_frequencies=np.concatenate(
                        [g.allele_frequencies, new.allele_frequencies[:, fresh]], axis=1
                    ),
                )
            lo = g.allele_frequencies.min()
            hi = g.allele_frequencies.max()
            if lo < 0.0 or hi > 1.0 + 1e-12:
                raise ValueError(
                    f"the function {registry_name(f)!r} generates values outside [0, 1] "
                    f"(observed range [{lo}, {hi}])"
                )
    if not g.checkdims():
        raise RuntimeError("error generating new features")
    return g


# ---------------------------------------------------------------------------
# Feature reconstitution: parse name strings -> expression trees -> vectorized
# ---------------------------------------------------------------------------


def parse_feature_name(name: str, known_funcs=FUNCTION_REGISTRY):
    """Parse 'f(a,g(b,c))' into ('f', [child...]); leaves are locus names."""
    name = name.strip()
    paren = name.find("(")
    if paren > 0 and name.endswith(")") and name[:paren] in known_funcs:
        fname = name[:paren]
        inner = name[paren + 1 : -1]
        args, depth, start = [], 0, 0
        for i, ch in enumerate(inner):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            elif ch == "," and depth == 0:
                args.append(inner[start:i])
                start = i + 1
        args.append(inner[start:])
        return (fname, [parse_feature_name(a, known_funcs) for a in args])
    return name  # leaf locus


def _eval_tree(tree, genomes: Genomes, cache: dict) -> np.ndarray:
    if isinstance(tree, str):
        idx = genomes.locus_indices([tree])[0]
        return genomes.allele_frequencies[:, idx]
    fname, children = tree
    key = repr(tree)
    if key in cache:
        return cache[key]
    f = FUNCTION_REGISTRY[fname]
    vals = [_eval_tree(c, genomes, cache) for c in children]
    # Reapply the ε shift the transforms applied to their inputs.
    vals = [v + _EPS for v in vals]
    # Snap to {0, 1} exactly as the stored column was at construction time
    # (transform1/2 snap before the column is reused by later rounds), so the
    # round-trip is bit-exact.
    out = _snap(np.asarray(f(*vals), dtype=np.float64), _EPS)
    cache[key] = out
    return out


def reconstitutefeatures(
    genomes: Genomes,
    feature_names: Sequence[str],
    verbose: bool = False,
) -> Genomes:
    """Re-materialize engineered features on a new genomes struct from their
    name strings (reference src/transformation.jl:730-778, minus the eval)."""
    if not genomes.checkdims():
        raise ValueError("the Genomes struct is corrupted")
    n = genomes.n
    cols = np.zeros((n, len(feature_names)))
    cache: dict = {}
    # Snapping happens inside _eval_tree (function outputs only): raw locus
    # columns pass through untouched, exactly as epistasisfeatures leaves them.
    for j, name in enumerate(feature_names):
        tree = parse_feature_name(str(name))
        cols[:, j] = _eval_tree(tree, genomes, cache)
    out = Genomes(
        entries=genomes.entries,
        populations=genomes.populations,
        loci_alleles=np.asarray(list(feature_names), dtype=object),
        allele_frequencies=cols,
    )
    if not out.checkdims():
        raise RuntimeError("error reconstituting features")
    return out
