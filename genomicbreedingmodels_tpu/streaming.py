"""Out-of-core streaming: disk → host → device pipelines for panels bigger
than HBM (or bigger than host RAM).

The reference holds the whole allele-frequency matrix in memory and has no
genotype file readers at all; production panels (100k × 1M+) do not fit.
Here a background thread decodes the next PLINK .bed marker shard while the
device computes on the current one, and the raw-Gram-is-additive identity
K = P (Σ_k X_k X_kᵀ) P (ops/grm.py:center_gram) lets the GRM accumulate
shard-by-shard with the centering applied exactly once at the end — the full
panel never exists anywhere.

Pipeline stages overlap naturally: disk read + 2-bit decode happen on the
prefetch thread, host→device transfer and the panel-syrk GEMMs are
dispatched asynchronously by JAX, so sustained throughput approaches
min(disk, decode, device) rather than their sum (cf. the streaming
HDD→accelerator design of arxiv 1302.4332).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Optional, Tuple, Union

import numpy as np

__all__ = [
    "BedShardStreamer",
    "grm_from_bed",
    "gblup_from_bed",
    "gblup_from_bed_pieces",
]

_BED_MAGIC = b"\x6c\x1b\x01"


def _iter_device_ahead(shards, depth: int = 1):
    """Double-buffered host→device stage: yield `(start, stop, dev_array)`
    with the NEXT shard's `jax.device_put` running on a worker thread while
    the caller computes on the current one.

    Through a slow (or synchronous) host↔device link the transfer is the
    pipeline's long pole; overlapping it with the device syrk hides the
    compute entirely and keeps `depth + 1` shards in flight (so device
    working-set cost is one extra shard). On a saturated link the gain is
    bounded by the compute share — see the bench's raw-link probe line for
    what the link itself sustains.
    """
    import jax

    if os.environ.get("GBM_STREAM_H2D_AHEAD", "1") == "0":
        # Escape hatch: inline (synchronous) uploads. Some transports
        # serialize badly when a worker thread issues device_put while the
        # main thread dispatches compute — A/B measured per deployment.
        for a, b, host in shards:
            yield a, b, jax.device_put(host)
        return
    with ThreadPoolExecutor(max_workers=1) as pool:
        it = iter(shards)
        pending = []

        def _pull():
            try:
                a, b, host = next(it)
            except StopIteration:
                return False
            pending.append((a, b, pool.submit(jax.device_put, host)))
            return True

        for _ in range(depth + 1):
            if not _pull():
                break
        while pending:
            a, b, fut = pending.pop(0)
            _pull()  # start the next upload BEFORE handing over this shard
            yield a, b, fut.result()


class BedShardStreamer:
    """Iterate `(start, stop, F)` marker shards of a PLINK .bed trio with
    background prefetch.

    F is float32 (n × shard_cols) allele frequencies; missing genotypes are
    imputed to the column mean (the standard VanRaden convention — an imputed
    cell contributes exactly zero after centering). `prefetch` shards are
    decoded ahead on a worker thread.
    """

    def __init__(
        self,
        prefix: Union[str, os.PathLike],
        block_cols: int = 32_768,
        prefetch: int = 2,
        impute_missing: bool = True,
    ):
        self.prefix = Path(prefix)
        self.block_cols = int(block_cols)
        self.prefetch = max(1, int(prefetch))
        self.impute_missing = bool(impute_missing)
        fam = np.loadtxt(self.prefix.with_suffix(".fam"), dtype=str, delimiter="\t", ndmin=2)
        self.entries = fam[:, 1].astype(object)
        self.populations = fam[:, 0].astype(object)
        self.n = len(self.entries)
        self._bytes_per_snp = (self.n + 3) // 4
        bed = self.prefix.with_suffix(".bed")
        size = bed.stat().st_size
        with open(bed, "rb") as fh:
            if fh.read(3) != _BED_MAGIC:
                raise ValueError(f"{bed}: bad PLINK magic (or sample-major, unsupported)")
        self.p = (size - 3) // self._bytes_per_snp

    def _read_payload(self, start: int, stop: int) -> np.ndarray:
        pth = self.prefix.with_suffix(".bed")
        cols = stop - start
        with open(pth, "rb") as fh:
            fh.seek(3 + start * self._bytes_per_snp)
            payload = np.frombuffer(fh.read(cols * self._bytes_per_snp), dtype=np.uint8)
        return np.ascontiguousarray(payload)

    def _decode_shard(self, start: int, stop: int) -> np.ndarray:
        payload = self._read_payload(start, stop)
        cols = stop - start
        F = np.empty((self.n, cols), dtype=np.float64)
        from .native.lib import load_native

        lib = load_native()
        if lib is not None:
            import ctypes

            lib.gbmio_bed_decode(
                payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self.n, cols,
                F.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), 0,
            )
        else:
            lut = np.array([0.0, np.nan, 0.5, 1.0])
            rows = payload.reshape(cols, self._bytes_per_snp)
            codes = np.stack(
                [(rows >> shift) & 0x3 for shift in (0, 2, 4, 6)], axis=-1
            ).reshape(cols, -1)[:, : self.n]
            F[:] = lut[codes].T
        F32 = F.astype(np.float32)
        if self.impute_missing and np.isnan(F32).any():
            mu = np.nanmean(F32, axis=0)
            mu = np.where(np.isfinite(mu), mu, 0.0).astype(np.float32)
            ij = np.where(np.isnan(F32))
            F32[ij] = mu[ij[1]]
        return F32

    def _decode_shard_dosage(self, start: int, stop: int, snp_major: bool = False):
        """Decode a shard straight to int8 dosages {0, 1, 2} (-1 = missing).

        .bed genotypes ARE dosages, so no float materialization is needed:
        the int8 shard is 4x smaller than the f32 one (4x less host→device
        transfer) and feeds the exact int8 Gram (ops/grm.py:gram_dosage).
        With `snp_major` the shard comes back (cols, n) in the .bed's native
        order — no host transpose at all (the device does it inside
        gram_dosage_snp_major; 2 host cores would take ~1 s). Returns None
        when the shard contains missing calls — the caller falls back to the
        imputed float path for that shard.
        """
        payload = self._read_payload(start, stop)
        cols = stop - start
        from .native.lib import load_native

        lib = load_native()
        if lib is not None:
            import ctypes

            shape = (cols, self.n) if snp_major else (self.n, cols)
            D = np.empty(shape, dtype=np.int8)
            n_missing = ctypes.c_long(0)
            lib.gbmio_bed_decode_i8(
                payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self.n, cols,
                D.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), 0,
                ctypes.byref(n_missing), 1 if snp_major else 0,
            )
            if n_missing.value > 0:
                return None
            return D
        # Same code→value convention as the float LUT [0.0, nan, 0.5, 1.0]
        # in _decode_shard, times ploidy 2: code0→0, code2→1, code3→2,
        # code1(missing)→-1.
        lut = np.array([0, -1, 1, 2], dtype=np.int8)
        rows = payload.reshape(cols, self._bytes_per_snp)
        codes = np.stack(
            [(rows >> shift) & 0x3 for shift in (0, 2, 4, 6)], axis=-1
        ).reshape(cols, -1)[:, : self.n]
        D = lut[codes]  # (cols, n) int8, .bed native order
        if (D < 0).any():
            return None
        return np.ascontiguousarray(D if snp_major else D.T)

    def __len__(self) -> int:
        return -(-self.p // self.block_cols)

    def _decode_auto(self, start: int, stop: int, snp_major: bool = False):
        """int8 dosage shard when complete, imputed float32 shard otherwise."""
        D = self._decode_shard_dosage(start, stop, snp_major=snp_major)
        return D if D is not None else self._decode_shard(start, stop)

    def _iter_with(self, decode) -> Iterator[Tuple[int, int, np.ndarray]]:
        bounds = [
            (s, min(s + self.block_cols, self.p))
            for s in range(0, self.p, self.block_cols)
        ]
        with ThreadPoolExecutor(max_workers=1) as pool:
            futures = [pool.submit(decode, a, b) for a, b in bounds[: self.prefetch]]
            for k, (a, b) in enumerate(bounds):
                nxt = k + self.prefetch
                if nxt < len(bounds):
                    futures.append(pool.submit(decode, *bounds[nxt]))
                yield a, b, futures[k].result()
                futures[k] = None  # release the decoded shard

    def __iter__(self) -> Iterator[Tuple[int, int, np.ndarray]]:
        return self._iter_with(self._decode_shard)

    def iter_dosage(self, snp_major: bool = False) -> Iterator[Tuple[int, int, np.ndarray]]:
        """Like iter(), but shards without missing calls come back as int8
        dosages (exact int8 path); shards with missing fall back to imputed
        float32 (always sample-major). `snp_major` keeps the int8 shards in
        the .bed's native (cols, n) order — zero host transpose work; pair
        with `ops.grm.gram_dosage_snp_major` (layout distinguishable by
        dtype: int8 ⇒ snp-major, float32 ⇒ sample-major)."""
        if snp_major:
            return self._iter_with(
                lambda a, b: self._decode_auto(a, b, snp_major=True)
            )
        return self._iter_with(self._decode_auto)

    def iter_payload(self) -> Iterator[Tuple[int, int, np.ndarray]]:
        """Yield RAW packed shards `(start, stop, (cols, ceil(n/4)) uint8)`.

        No host decode at all: the 2-bit payload ships to the device as-is
        (4 genotypes/byte — 4x less host→device traffic than int8 dosages,
        the binding constraint on slow links) and
        `ops.pieces.unpack_bed_payload` expands it on device.
        """
        bps = self._bytes_per_snp
        return self._iter_with(
            lambda a, b: self._read_payload(a, b).reshape(b - a, bps)
        )


def grm_from_bed(
    prefix: Union[str, os.PathLike],
    block_cols: int = 32_768,
    prefetch: int = 2,
    dtype: Optional[str] = None,
    center: bool = True,
):
    """Out-of-core centered Gram matrix straight from a PLINK .bed file.

    Accumulates raw per-shard Grams on device (raw Grams are additive over
    column shards) and applies the double-centering projection once. Peak
    memory: one shard on host + two shards and the n×n f32 output on device.

    Shards with complete calls ride the exact int8 dosage path
    (ops/grm.py:gram_dosage — .bed genotypes ARE dosages): 4x smaller
    host→device transfer, zero quantization error. Shards containing missing
    calls are mean-imputed and take the float path at `dtype` (float32 by
    default).
    Pass dtype="float32"/"bfloat16" to force the float path for every shard.
    """
    import jax.numpy as jnp

    from .ops.grm import center_gram, gram_dosage_snp_major, gram_panel

    force_float = dtype is not None
    dt = jnp.dtype(dtype or "float32")
    streamer = BedShardStreamer(prefix, block_cols=block_cols, prefetch=prefetch)
    K = None
    shards = streamer if force_float else streamer.iter_dosage(snp_major=True)

    def _host_cast(it):
        # Cast float shards to the compute dtype ON HOST so bf16 shards
        # cross the link at 2 bytes/genotype, not 4.
        for a, b, F in it:
            yield a, b, (F if F.dtype == np.int8 else F.astype(dt))

    for _, _, F in _iter_device_ahead(_host_cast(shards)):
        if F.dtype == np.int8:
            # int8 shards arrive SNP-major (no host transpose — the device
            # flips them in-program); dosages are 2x the frequencies, so the
            # raw Gram is rescaled by 1/4.
            G = gram_dosage_snp_major(F, ploidy=2, center=False)
        else:
            G = gram_panel(F, center=False)
        K = G if K is None else K + G
    if K is None:
        raise ValueError(f"{prefix}: no markers")
    return center_gram(K) if center else K


def gblup_from_bed(
    prefix: Union[str, os.PathLike],
    y: np.ndarray,
    lam: float = 0.1,
    block_cols: int = 32_768,
    prefetch: int = 2,
    dtype: Optional[str] = None,
):
    """Out-of-core GBLUP: stream the panel once for the GRM, then one fused
    Cholesky mixed-model solve. Returns (gebv, K)."""
    import jax.numpy as jnp
    from jax.scipy.linalg import cho_solve

    K = grm_from_bed(prefix, block_cols=block_cols, prefetch=prefetch, dtype=dtype)
    K = K / jnp.maximum(jnp.mean(jnp.diag(K)), 1e-12)  # kinship-scale
    y = jnp.asarray(np.asarray(y, dtype=np.float32))
    yc = y - jnp.mean(y)
    A = K + jnp.float32(lam) * jnp.eye(K.shape[0], dtype=K.dtype)
    L = jnp.linalg.cholesky(A)
    alpha = cho_solve((L, True), yc)
    gebv = yc - jnp.float32(lam) * alpha + jnp.mean(y)
    return gebv, K


def gblup_from_bed_pieces(
    prefix: Union[str, os.PathLike],
    y: np.ndarray,
    lam: float = 0.1,
    block_cols: int = 32_768,
    block_rows: int = 4_096,
    prefetch: int = 2,
    cg_iters: int = 30,
) -> Tuple[np.ndarray, float]:
    """Out-of-core GBLUP at north-star scale (n where the square Gram does
    not fit HBM): the Gram only ever exists as lower-trapezoid int32 pieces
    (ops/pieces.py) and the mixed-model solve is matrix-free CG.

    Disk .bed → PACKED 2-bit shards straight to the device (4 genotypes per
    byte; the host never decodes — on slow host↔device links the packed
    transfer is the whole wall-clock and this is 4x less traffic than int8
    dosages) → fused on-device unpack + exact int32 piece syrk (donated) →
    piecewise double-centering → CG. `lam` is on the kinship scale (matches
    `gblup_from_bed`: λ multiplies mean(diag K)). Requires complete calls
    (the exact dosage path) — missing calls are COUNTED on device and the
    stream FAILS FAST: the counter is synced to host after the first shard
    and every 8th shard thereafter (one scalar readback each — negligible
    vs the shard syrk), so a dirty north-star panel is rejected within ~8
    shards instead of after the full multi-GB stream + syrk cost. Impute
    upstream or use the dense `gblup_from_bed`.
    Returns (gebv, cg_residual_norm).
    """
    import jax.numpy as jnp

    from .ops.pieces import (
        accumulate_bed_payload,
        gblup_from_pieces,
        make_bounds,
        zero_pieces,
    )

    streamer = BedShardStreamer(prefix, block_cols=block_cols, prefetch=prefetch)
    n = streamer.n
    bounds = make_bounds(n, block_rows)
    pieces = zero_pieces(n, bounds)
    miss = jnp.zeros((), jnp.int32)

    def _reject(miss_count: int) -> None:
        raise ValueError(
            f"{prefix}: {miss_count} missing calls — the exact pieces path "
            "needs complete dosages; impute upstream or use gblup_from_bed"
        )

    # Double-buffered h2d: shard k+1 uploads on a worker thread while the
    # device runs shard k's unpack+syrk (one extra ~block_cols*n/4-byte
    # shard resident).
    for k, (_, _, payload) in enumerate(_iter_device_ahead(streamer.iter_payload())):
        pieces, miss = accumulate_bed_payload(
            pieces, payload, miss, bounds=bounds, n=n
        )
        # Fail fast on dirty panels: sync the device miss counter after the
        # first shard (catches systematic missingness immediately) and every
        # 8th shard after that. Each sync is one scalar readback.
        if k == 0 or k % 8 == 7:
            if int(miss) > 0:
                _reject(int(miss))
    if int(miss) > 0:
        _reject(int(miss))
    gebv, resid = gblup_from_pieces(
        pieces, np.asarray(y, dtype=np.float32), bounds,
        ploidy=2, lam_rel=float(lam), iters=int(cg_iters),
    )
    return np.asarray(gebv, dtype=np.float64), float(resid)
