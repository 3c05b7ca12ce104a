"""Benchmark suite: GRM+GBLUP throughput plus the BASELINE.md target table.

Emits one JSON line per metric ({"metric", "value", "unit"}). The HEADLINE
metric is the fused GRM+GBLUP step at 8192 x 262144. The headline runs FIRST
and its line is re-emitted after every section so the last stdout line is
ALWAYS the headline JSON (failure/timeout/skip notes go to stderr, never
stdout). Supporting metrics cover the rest of BASELINE.md's target table:

- north star: GRM+GBLUP at n=50_000 x p=500_000 (BASELINE.md "SNPs/s/chip
  ... at 50k x 500k"). The panel never exists whole anywhere: int8 dosage
  column shards are generated on device (rbg bits — data synthesis, not
  compute) and folded into donated lower-trapezoid int32 pieces by the
  syrk of ops/pieces.py (exact int32 accumulation), then GBLUP solves by
  matrix-free CG. Per-stage timings print to stderr.
- raw host->device link probe: a bare 256 MB device_put in MB/s — the link
  rate that the gwas/diskstream/cv stage notes attribute.
- Gibbs sampler marker-updates/s: BayesC on the 2^K-pattern collapsed
  draw (the shipped "auto" default, models/bayesian.py) — + BRR
  joint block draws, plus effect-ESS/s over honest
  1000-post-burnin-sweep windows on a signal panel, plus BASELINE
  config-3 AT SIZE (10k x 102k, device-synthesized panel — see
  bench_sampler_big).
- GWAS-REML markers/s (the reference's O(p n^3) hot spot, rotated).
- cvbulk wall-clock: replicated k-fold CV via the batched fold-sharded
  engine (reference scheduler: src/cross_validation.jl:151-206), now
  including lasso folds.
- disk-streamed GBLUP (DEFAULT-ON; GBM_BENCH_DISK=0 disables):
  gblup_from_bed_pieces on a 25k x 250k auto-generated .bed (cached in
  <checkout>/.bench_data), or the panel at $GBM_BENCH_BED (e.g. the 50k x 500k trio from
  scripts/make_big_bed.py) when set. Stage notes split host IO from
  h2d+syrk.

Budgeting: GBM_BENCH_BUDGET (seconds, default 720) is enforced between
sections: a section whose floor estimate exceeds the remaining budget is
SKIPPED with a stderr note, lowest-priority first (priority order = list
order below).

Sizes: the sections run at size when JAX's default device is an
accelerator. On a CPU-only host the script exits with a message, unless
GBM_BENCH_FORCE_CPU=1 asks for the small CPU shapes (a rehearsal, not a
measurement).
"""

import json
import os
import sys
import time
from pathlib import Path

# Generated benchmark inputs (the diskstream .bed panel) live in the checkout.
DATA_DIR = Path(__file__).resolve().parent / ".bench_data"


def _sync(x):
    import jax

    return jax.block_until_ready(x)


def _median_time(step, reps=5):
    step()  # warmup / compile
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def emit(metric: str, value: float, unit: str) -> None:
    print(
        json.dumps({"metric": metric, "value": round(float(value), 1), "unit": unit}),
        flush=True,
    )


def note(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Raw host->device link probe
# ---------------------------------------------------------------------------


def bench_linkprobe(at_size: bool) -> None:
    """Measure the raw host→device link with a bare device_put: the number
    that attributes the h2d share in the gwas/diskstream/cv stage notes by
    measurement instead of inference."""
    import jax
    import numpy as np

    mb = 256 if at_size else 16
    buf = np.empty(mb * 1024 * 1024, dtype=np.uint8)
    dev = jax.devices()[0]

    def put():
        return jax.device_put(buf, dev).block_until_ready()

    put()  # warm the path (allocator, pinned staging buffers)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        put()
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[1]
    emit(
        f"raw host->device link MB/s (bare device_put of a {mb} MB buffer, "
        "median-of-3)",
        mb / dt,
        "MB/s",
    )


# ---------------------------------------------------------------------------
# North star: 50k x 500k GRM + GBLUP, streamed int8 shards + pieces CG
# ---------------------------------------------------------------------------


def bench_northstar(at_size: bool) -> None:
    import jax
    import jax.numpy as jnp
    from functools import partial

    from genomicbreedingmodels_tpu.ops.pieces import (
        accumulate_dosage_shard, center_scale_pieces, cg_solve_pieces,
        make_bounds, zero_pieces,
    )

    if at_size:
        n, p_shard, n_shards, rng_chunks = 50_000, 62_500, 8, 10
    else:
        n, p_shard, n_shards, rng_chunks = 1_024, 2_048, 2, 2
    p = p_shard * n_shards
    bounds = make_bounds(n, 4096)

    # Shard synthesis: rbg random bits (cheaper than threefry at this size).
    # The shard is drawn in chunks because jax.random materializes 4-byte
    # random bits per element. Data values do not affect syrk timing.
    @partial(jax.jit, donate_argnums=(0,))
    def add_shard(pieces, key):
        ck = jax.random.split(key, rng_chunks)
        cw = p_shard // rng_chunks
        D = jnp.concatenate(
            [jax.random.randint(ck[c], (n, cw), 0, 3, dtype=jnp.int8)
             for c in range(rng_chunks)],
            axis=1,
        )
        return accumulate_dosage_shard(pieces, D, bounds=bounds, snp_major=False)

    keys = jax.random.split(jax.random.key(7, impl="rbg"), n_shards + 1)
    y = jax.random.normal(jax.random.PRNGKey(3), (n,), dtype=jnp.float32)

    def run(report_stages=False):
        t0 = time.perf_counter()
        pieces = zero_pieces(n, bounds)
        for s in range(n_shards):
            pieces = add_shard(pieces, keys[s])
        if report_stages:
            _sync(pieces[0])
            t1 = time.perf_counter()
        pieces = center_scale_pieces(pieces, jnp.float32(4.0), bounds=bounds)
        if report_stages:
            _sync(pieces[0])
            t2 = time.perf_counter()
        gebv, resid = cg_solve_pieces(
            pieces, y, jnp.float32(1e-3), bounds=bounds, iters=30
        )
        res = float(resid)
        _sync(gebv)
        t3 = time.perf_counter()
        if report_stages:
            note(
                f"# northstar stages: rng+syrk={t1 - t0:.2f}s "
                f"center={t2 - t1:.2f}s cg={t3 - t2:.2f}s"
            )
        return t3 - t0, res

    run()  # compile warmup (donated buffers are rebuilt fresh each run)
    run(report_stages=True)  # stage breakdown (syncs between stages)
    dt, res = run()
    snps_per_s = n * p / dt
    # Shards are synthesized on device; the real-disk variant of the same
    # code path (gblup_from_bed_pieces) is the diskstream section (set
    # GBM_BENCH_BED to the make_big_bed.py trio to run it at this size).
    emit(
        f"north-star GRM+GBLUP SNPs/s/chip (n={n}, p={p}, streamed int8 "
        f"shards, pieces syrk + CG, resid={res:.1e})",
        snps_per_s,
        "SNPs/s",
    )


# ---------------------------------------------------------------------------
# Optional: at-size disk-streamed GBLUP (GBM_BENCH_DISK=1)
# ---------------------------------------------------------------------------


def bench_diskstream(at_size: bool) -> None:
    """At-size disk-streamed GBLUP — runs by DEFAULT (GBM_BENCH_DISK=0 to
    disable). If $GBM_BENCH_BED names an existing trio (e.g. the 50k x 500k
    panel of scripts/make_big_bed.py) it is used; otherwise a 25k x 250k
    panel (1.56 GB packed payload; chosen so generation + one streamed pass
    fit the budget alongside the other sections) is generated once into
    DATA_DIR and cached."""
    import numpy as np

    from genomicbreedingmodels_tpu.streaming import BedShardStreamer, gblup_from_bed_pieces

    prefix = os.environ.get("GBM_BENCH_BED", "")
    if not (prefix and os.path.exists(prefix + ".bed")):
        n_gen, p_gen = (25_000, 250_000) if at_size else (512, 4_096)
        DATA_DIR.mkdir(exist_ok=True)
        prefix = str(DATA_DIR / f"gbm_disk_panel_{n_gen}x{p_gen}")
        t0 = time.perf_counter()
        expect = 3 + ((n_gen + 3) // 4) * p_gen
        if not (os.path.exists(prefix + ".bed")
                and os.path.getsize(prefix + ".bed") == expect):
            from genomicbreedingmodels_tpu.io import write_random_bed

            write_random_bed(prefix, n_gen, p_gen)
            note(f"# diskstream: generated {prefix}.bed "
                 f"({expect / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f}s")
    block_cols = 31_250 if at_size else 1_024
    st = BedShardStreamer(prefix, block_cols=block_cols)
    n, p = st.n, st.p
    # Host-side-only sweep (disk read + prefetch thread, no device work):
    # isolates the disk/decode stage so the full-pipeline number can be
    # attributed between host IO and h2d+syrk below.
    t0 = time.perf_counter()
    host_bytes = 0
    for _, _, payload in st.iter_payload():
        host_bytes += payload.nbytes
    t_host = time.perf_counter() - t0
    y = np.random.default_rng(0).normal(size=n).astype(np.float32)
    t0 = time.perf_counter()
    gebv, resid = gblup_from_bed_pieces(
        prefix, y, lam=0.1, block_cols=block_cols, cg_iters=30
    )
    dt = time.perf_counter() - t0
    assert np.all(np.isfinite(gebv))
    note(
        f"# diskstream stages: disk+prefetch-only pass={t_host:.1f}s "
        f"({host_bytes / 1e9:.2f} GB packed @ {host_bytes / 1e9 / t_host:.2f} GB/s); "
        f"full pipeline={dt:.1f}s ⇒ h2d+unpack+syrk+cg ≈ {dt - t_host:.1f}s "
        f"(effective h2d {host_bytes / 1e9 / max(dt - t_host, 1e-9) * 1e3:.0f} MB/s; "
        "read/decode overlap device work via the prefetch thread)"
    )
    emit(
        f"disk-streamed GRM+GBLUP SNPs/s/chip (n={n}, p={p}, .bed packed 2-bit "
        f"h2d -> on-device unpack -> pieces CG, resid={resid:.1e})",
        n * p / dt,
        "SNPs/s",
    )


# ---------------------------------------------------------------------------
# Gibbs sampler throughput (the BGLR replacement)
# ---------------------------------------------------------------------------


def _indicator_update() -> str:
    from genomicbreedingmodels_tpu.utils.config import get_config

    return get_config().mcmc_indicator_update


def bench_sampler(at_size: bool) -> None:
    import numpy as np
    from genomicbreedingmodels_tpu.models.bayesian import gibbs_regression

    if at_size:
        n, p, n_iter, n_burnin = 2_048, 32_768, 150, 30
        n_e, p_e, iter_e, burn_e = 512, 4_096, 1_100, 100
    else:
        n, p, n_iter, n_burnin = 128, 1_024, 60, 10
        n_e, p_e, iter_e, burn_e = 64, 256, 220, 20
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(n, p)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    # GBM_MCMC_INDICATOR_UPDATE=pallas|grouped times the block kernel or the
    # XLA scan; "auto" resolves per backend (models/bayesian.py).
    bayesc_label = f"2^K collapsed draw, {_indicator_update()}"
    for model, label in (
        ("BayesC", bayesc_label),
        ("BRR", "joint block draw"),  # continuous prior: one Cholesky per block
    ):
        # n_iter is a jit static: the warmup must run the EXACT config or the
        # timed call pays the compile. Median of 3 timed runs.
        gibbs_regression(X, y, model=model, n_iter=n_iter, n_burnin=n_burnin, seed=1)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            gibbs_regression(
                X, y, model=model, n_iter=n_iter, n_burnin=n_burnin, seed=1
            )
            times.append(time.perf_counter() - t0)
        dt = sorted(times)[1]
        emit(
            f"{model} Gibbs marker-updates/s (n={n}, p={p}, {n_iter} sweeps, "
            f"{label}, warm median-of-3, panel device-cached across runs)",
            n_iter * p / dt,
            "updates/s",
        )
    # Statistical efficiency with an HONEST window (a 120-sweep window is
    # below the Geyer estimator's resolution floor for σ²ₑ): 1000 post-burnin
    # sweeps — short of nothing BGLR does
    # (its own default is 1500 TOTAL incl. 500 burn-in, src/linear.jl:
    # 446-447) — on a smaller panel WITH genetic signal (h²≈0.5, 1% causal)
    # so σ²ₑ is identified and its chain actually mixes rather than drifts.
    rng_e = np.random.default_rng(7)
    X_e = (rng_e.integers(0, 3, size=(n_e, p_e)) / 2.0).astype(np.float32)
    beta_e = (rng_e.normal(size=p_e) * (rng_e.uniform(size=p_e) < 0.01)).astype(np.float32)
    g_e = X_e @ beta_e
    y_e = (g_e + rng_e.normal(size=n_e) * max(g_e.std(), 1e-3)).astype(np.float32)
    for model, label in (
        ("BayesC", bayesc_label),
        ("BRR", "joint block draw"),
    ):
        gibbs_regression(X_e, y_e, model=model, n_iter=iter_e, n_burnin=burn_e, seed=2)
        t0 = time.perf_counter()
        _, _, diag = gibbs_regression(
            X_e, y_e, model=model, n_iter=iter_e, n_burnin=burn_e, seed=2
        )
        dt_e = time.perf_counter() - t0
        emit(
            f"{model} Gibbs effect-ESS/s (n={n_e}, p={p_e}, {label}, signal panel "
            f"h2=0.5; mean effect ESS={diag['ess_effects_mean']:.0f}, "
            f"sigma_e2 ESS={diag['ess_sigma_e2']:.0f}, window={iter_e - burn_e} "
            "post-burnin sweeps)",
            diag["ess_effects_mean"] / dt_e,
            "ESS/s",
        )


# ---------------------------------------------------------------------------
# Bayesian alphabet at BASELINE config-3 size (10k x ~100k)
# ---------------------------------------------------------------------------


def bench_sampler_big(at_size: bool) -> None:
    """BASELINE config 3 at size: BayesC (grouped) + BRR (joint block) on a
    10_000 x 102_000 panel — the headline BGLR replacement (reference
    src/bayes.jl:92-93) at its own config size.

    The panel is SYNTHESIZED ON DEVICE (diploid dosages/2 + 1%-causal
    signal, h²≈0.5) and consumed through gibbs_regression's jax-array path —
    the production shape for a panel already on the device from the
    streaming loaders. Stage note attributes prep (center+block Grams, re-paid per
    segment) vs the sweep scan; h2d is zero by construction.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from genomicbreedingmodels_tpu.models.bayesian import gibbs_regression

    # p and block_size are chosen so the panel tiles EXACTLY: bs=600 is a
    # multiple of the grouped draw's K=6 and divides p, so p_pad == p and the
    # sampler aliases the device panel instead of materializing a padded
    # 4.1 GB copy.
    if at_size:
        n, p, bs, sweeps, burn = 10_000, 102_000, 600, 60, 10
    else:
        n, p, bs, sweeps, burn = 256, 2_400, 600, 30, 5

    @jax.jit
    def synth(key):
        kx, kb, ke = jax.random.split(key, 3)
        X = (
            jax.random.randint(kx, (n, p), 0, 3, dtype=jnp.int8).astype(jnp.float32)
            * jnp.float32(0.5)
        )
        beta = jax.random.normal(kb, (p,), dtype=jnp.float32) * (
            jax.random.uniform(jax.random.fold_in(kb, 1), (p,)) < 0.01
        )
        g = jnp.dot(X, beta, preferred_element_type=jnp.float32)
        y = g + jax.random.normal(ke, (n,), dtype=jnp.float32) * jnp.std(g)
        return X, y

    X, y_dev = synth(jax.random.key(11, impl="rbg"))
    _sync(X)
    y = np.asarray(y_dev)  # 40 KB readback; the panel never crosses the link
    for model, label in (
        ("BayesC", f"2^K collapsed draw, {_indicator_update()}"),
        ("BRR", "joint block draw"),
    ):
        kw = dict(model=model, n_burnin=burn, seed=4, block_size=bs)
        # Prep probe: a 1-sweep run ≈ center + block-Gram precompute + one
        # sweep — attributes the fixed per-segment cost.
        gibbs_regression(X, y, n_iter=2, **kw)  # compile (prep probe shape)
        t0 = time.perf_counter()
        gibbs_regression(X, y, n_iter=2, **kw)
        t_prep = time.perf_counter() - t0
        gibbs_regression(X, y, n_iter=sweeps, **kw)  # compile full shape
        t0 = time.perf_counter()
        _, _, diag = gibbs_regression(X, y, n_iter=sweeps, **kw)
        dt = time.perf_counter() - t0
        note(
            f"# samplerbig {model} stages: prep+2sweeps={t_prep:.1f}s; "
            f"{sweeps}-sweep run={dt:.1f}s ⇒ sweep scan ≈ "
            f"{(dt - t_prep) / max(sweeps - 2, 1) * 1e3:.0f} ms/sweep; h2d=0 "
            "(device-synthesized panel)"
        )
        emit(
            f"{model} Gibbs marker-updates/s AT SIZE (n={n}, p={p}, {sweeps} "
            f"sweeps, {label}, warm; effect ESS={diag['ess_effects_mean']:.0f} "
            f"of {sweeps - burn}-sweep window — honest mixing windows are the "
            "ESS/s lines)",
            sweeps * p / dt,
            "updates/s",
        )


# ---------------------------------------------------------------------------
# GWAS-REML scan rate
# ---------------------------------------------------------------------------


def bench_gwas(at_size: bool) -> None:
    import numpy as np
    import genomicbreedingmodels_tpu as gbm

    if at_size:
        n, p = 2_048, 32_768
    else:
        n, p = 128, 512
    rng = np.random.default_rng(3)
    freq = rng.integers(0, 3, size=(n, p)).astype(np.float64) / 2.0
    genomes = gbm.Genomes(
        entries=np.array([f"e{i:05d}" for i in range(n)]),
        populations=np.array(["pop_1"] * n),
        loci_alleles=np.array([f"chr1\t{i}\tA|T\tA" for i in range(p)]),
        allele_frequencies=freq,
    )
    phen = rng.normal(size=(n, 1))
    phenomes = gbm.Phenomes(
        entries=genomes.entries,
        populations=genomes.populations,
        traits=np.array(["t"]),
        phenotypes=phen,
    )
    from genomicbreedingmodels_tpu.models import gwas as gwas_mod

    gbm.gwasreml(genomes=genomes, phenomes=phenomes)  # compile warmup
    # COLD timed run (cache cleared): pays the full prep — panel upload
    # (uint8 dosage codes, 4x under the f32 bytes; see
    # models/gwas.py:_prep_device and the raw link-probe line) + GRM.
    gwas_mod._PREP_CACHE.clear()
    t0 = time.perf_counter()
    fit = gbm.gwasreml(genomes=genomes, phenomes=phenomes)
    dt = time.perf_counter() - t0
    assert np.all(np.isfinite(fit.b_hat))
    tm = fit.extras.get("timings", {})
    if tm:
        note(
            "# gwas stages (cold prep, uint8 panel upload): "
            + " ".join(f"{k}={v['total_s']:.1f}s" for k, v in tm.items())
        )
    emit(
        f"GWAS-REML markers/s incl. GRM+eigh (n={n}, p={p}, per-marker 2-VC "
        "REML, warm compile, cold device prep)",
        len(fit.b_hat) / dt,
        "markers/s",
    )
    # WARM repeat on the same panel: the single-slot device-prep cache
    # (utils/devcache.py) skips upload + GRM — the repeated-scan pattern
    # (gwasols + gwaslmm + gwasreml on one panel, or parameter sweeps).
    t0 = time.perf_counter()
    fit = gbm.gwasreml(genomes=genomes, phenomes=phenomes)
    dt_w = time.perf_counter() - t0
    emit(
        f"GWAS-REML markers/s, prep-cached repeat (n={n}, p={p}, device prep "
        "reused via the single-slot panel cache)",
        len(fit.b_hat) / dt_w,
        "markers/s",
    )
    # The other two scans ride the same cached device prep: the whole
    # three-scan sweep (ols t-stats, EMMAX-LMM z-stats, per-marker REML)
    # pays ONE upload+GRM. The reference threads each scan over markers
    # with per-marker pinv / MixedModels fits (src/gwas.jl:238-249,
    # :363-385).
    for fn, name in ((gbm.gwasols, "GWAS-OLS"), (gbm.gwaslmm, "GWAS-LMM")):
        fn(genomes=genomes, phenomes=phenomes)  # compile warmup
        t0 = time.perf_counter()
        fit2 = fn(genomes=genomes, phenomes=phenomes)
        dt2 = time.perf_counter() - t0
        assert np.all(np.isfinite(fit2.b_hat))
        emit(
            f"{name} markers/s, prep-cached (n={n}, p={p}, closed-form "
            "Schur-complement scan)",
            len(fit2.b_hat) / dt2,
            "markers/s",
        )


# ---------------------------------------------------------------------------
# Epistasis pair scan (transform2 — the reference's #4 hot loop)
# ---------------------------------------------------------------------------


def bench_epistasis(at_size: bool) -> None:
    """All-ordered-pairs simple-regression scan for t = x_a * x_b (mult
    kernel): l² pair slopes as three GEMMs per block row + on-device
    running top-k (the reference's O(l²·n) hottest feature loop,
    src/transformation.jl:319-468, executed column-at-a-time there)."""
    import numpy as np
    import genomicbreedingmodels_tpu as gbm
    from genomicbreedingmodels_tpu.features.endofunctions import mult
    from genomicbreedingmodels_tpu.features.transform import transform2

    if at_size:
        n, l = 512, 16_384
    else:
        n, l = 64, 512
    rng = np.random.default_rng(5)
    freq = rng.uniform(size=(n, l))
    genomes = gbm.Genomes(
        entries=np.array([f"e{i:05d}" for i in range(n)]),
        populations=np.array(["pop_1"] * n),
        loci_alleles=np.array([f"chr1\t{i}\tA|T\tA" for i in range(l)]),
        allele_frequencies=freq,
    )
    y = freq[:, :32] @ rng.normal(size=32) + rng.normal(size=n)
    phenomes = gbm.Phenomes(
        entries=genomes.entries, populations=genomes.populations,
        traits=np.array(["t"]), phenotypes=y[:, None],
    )
    kw = dict(n_new_features_per_transformation=1_000)
    transform2(mult, genomes, phenomes, **kw)  # compile warmup
    t0 = time.perf_counter()
    out = transform2(mult, genomes, phenomes, **kw)
    dt = time.perf_counter() - t0
    assert out.allele_frequencies.shape[1] > 0
    # Attribute the end-to-end number: time the device scan alone (the
    # remainder is host prep + the panel h2d).
    import jax.numpy as jnp
    from genomicbreedingmodels_tpu.features.transform import _pairs_topk_single

    Xd = jnp.asarray(freq.astype(np.float32))
    ymd = jnp.asarray((y - y.mean()).astype(np.float32))
    okd = jnp.asarray(np.ones(l, bool))
    args = (Xd, ymd, okd, "mult", False, 1_000, 128)
    float(_pairs_topk_single(*args)[0][0])  # compile + warm
    t0 = time.perf_counter()
    float(_pairs_topk_single(*args)[0][0])
    dt_scan = time.perf_counter() - t0
    note(
        f"# epistasis stages: device scan={dt_scan:.2f}s "
        f"({l * l / dt_scan / 1e6:.0f}M pairs/s scan-only); end-to-end={dt:.2f}s "
        f"(rest = host prep + {n * l * 4 / 1e6:.0f} MB panel h2d)"
    )
    emit(
        f"epistasis pair-scan pairs/s (transform2 mult, n={n}, l={l}, "
        f"l^2={l * l / 1e6:.0f}M ordered pairs, 3-GEMM slopes + device top-k, "
        f"end-to-end warm incl. h2d; scan-only {l * l / dt_scan / 1e9:.2f}G pairs/s)",
        l * l / dt,
        "pairs/s",
    )


# ---------------------------------------------------------------------------
# CV wall-clock (replicated k-fold, batched fold-sharded engine)
# ---------------------------------------------------------------------------


def _format_cv_stages(timer) -> str:
    if timer is None:
        return "n/a"
    return " ".join(
        f"{k}={v['total_s']:.1f}s" for k, v in timer.summary().items()
    )


def bench_cv(at_size: bool) -> None:
    import numpy as np
    import genomicbreedingmodels_tpu as gbm
    from genomicbreedingmodels_tpu.cv.batched import cvbulk_batched
    from genomicbreedingmodels_tpu.utils.backend import compile_cache_dir

    if at_size:
        n, p, n_replications, n_folds = 2_048, 32_768, 3, 5
    else:
        n, p, n_replications, n_folds = 128, 1_024, 2, 3
    models = ("ridge", "gblup", "lasso")
    t_gen = time.perf_counter()
    rng = np.random.default_rng(11)
    # f32 from the start: halves host RAM and the h2d bytes.
    freq = rng.uniform(size=(n, p)).astype(np.float32)
    genomes = gbm.Genomes(
        entries=np.array([f"e{i:05d}" for i in range(n)]),
        populations=np.array(["pop_1"] * n),
        loci_alleles=np.array([f"chr1\t{i}\tA|T\tA" for i in range(p)]),
        allele_frequencies=freq,
    )
    beta = rng.normal(size=p) * (rng.uniform(size=p) < 0.01)
    yy = freq @ beta
    yy = yy + rng.normal(size=n) * yy.std()
    phenomes = gbm.Phenomes(
        entries=genomes.entries,
        populations=genomes.populations,
        traits=np.array(["t"]),
        phenotypes=yy[:, None],
    )
    # Persistent-cache state BEFORE the warmup: attributes the warmup time
    # between XLA compiles (cold cache) and pure h2d+execute (warm cache).
    cache_dir = compile_cache_dir()
    try:
        cache_n = len(os.listdir(cache_dir))
    except OSError:
        cache_n = 0
    t_warm = time.perf_counter()
    cvbulk_batched(  # compile warmup (fold-mask shapes match the timed run)
        genomes, phenomes, models=models,
        n_replications=n_replications, n_folds=n_folds, store_effects=False,
    )
    t0 = time.perf_counter()
    from genomicbreedingmodels_tpu.cv import batched as _batched

    warm_stages = _format_cv_stages(_batched.LAST_TIMER)
    note(
        f"# cv stages: datagen={t_warm - t_gen:.1f}s warmup={t0 - t_warm:.1f}s "
        f"(persistent-cache entries before warmup: {cache_n}; warmup split: "
        f"{warm_stages})"
    )
    cvs, notes = cvbulk_batched(
        genomes, phenomes, models=models,
        n_replications=n_replications, n_folds=n_folds, store_effects=False,
    )
    dt = time.perf_counter() - t0
    note(f"# cv warm-run split: {_format_cv_stages(_batched.LAST_TIMER)}")
    assert len(cvs) >= n_replications * n_folds * len(models)
    emit(
        f"cvbulk wall-clock (n={n}, p={p}, {n_replications}x{n_folds} folds x "
        f"{len(models)} models = {len(cvs)} fits, batched, warm; panel+gram "
        "device-cached across calls — cold split in the stage note)",
        dt,
        "s",
    )


# ---------------------------------------------------------------------------
# Headline: fused GRM+GBLUP step at 8192 x 262144
# ---------------------------------------------------------------------------


def bench_headline(at_size: bool) -> None:
    import jax
    import jax.numpy as jnp

    use_bf16 = os.environ.get("GBM_BENCH_BF16", "0") == "1"
    if at_size:
        n, p = 8192, 262_144
    else:
        n, p = 512, 4_096

    key = jax.random.PRNGKey(0)
    kx, ky = jax.random.split(key)
    y = jax.random.normal(ky, (n,), dtype=jnp.float32)

    if use_bf16:
        from genomicbreedingmodels_tpu.ops.grm import gram_panel as grm

        X = jax.random.uniform(kx, (n, p), dtype=jnp.bfloat16)
    else:
        # Default: called-genotype diploid dosages {0, 1, 2} on the exact
        # int8 path — EXACT int32 accumulation, the centered Gram is built
        # LOWER TRIANGLE ONLY (no mirror pass), and the mixed-model solve is
        # the blocked Cholesky + blocked substitution of ops/chol.py (GEMM
        # panels instead of sequential trsv recurrences).
        from genomicbreedingmodels_tpu.ops.chol import gblup_solve_lower
        from genomicbreedingmodels_tpu.ops.grm import gram_dosage_lower

        X = jax.random.randint(kx, (n, p), 0, 3, dtype=jnp.int8)

        @jax.jit
        def fused_step(D, y):
            K_lower = gram_dosage_lower(D, ploidy=2)
            return gblup_solve_lower(K_lower, y, jnp.float32(0.1))

        dt = _median_time(lambda: _sync(fused_step(X, y)))
        snps_per_s = n * p / dt
        emit(
            f"GRM+GBLUP SNPs/s/chip (n={n}, p={p}, int8 dosage, "
            "lower-tri gram + blocked cholesky)",
            snps_per_s,
            "SNPs/s",
        )
        return

    @jax.jit
    def fused_step(X, y):
        K = grm(X)
        yc = y - jnp.mean(y)
        lam = jnp.float32(0.1)
        A = K + lam * jnp.eye(K.shape[0], dtype=K.dtype)
        L = jnp.linalg.cholesky(A)
        alpha = jax.scipy.linalg.cho_solve((L, True), yc)
        # GEBV = K alpha + mean; K alpha = (A - lam I) alpha = yc - lam*alpha,
        # so the n x n matvec is algebraically free.
        return yc - lam * alpha + jnp.mean(y)

    dt = _median_time(lambda: _sync(fused_step(X, y)))
    snps_per_s = n * p / dt
    emit(f"GRM+GBLUP SNPs/s/chip (n={n}, p={p}, bf16)", snps_per_s, "SNPs/s")


SECTIONS = {
    "headline": bench_headline,
    "linkprobe": bench_linkprobe,
    "northstar": bench_northstar,
    "sampler": bench_sampler,
    "samplerbig": bench_sampler_big,
    "gwas": bench_gwas,
    "cv": bench_cv,
    "diskstream": bench_diskstream,
    "epistasis": bench_epistasis,
}

# Minimum seconds a section realistically needs (compile + run); used by the
# budget guard to decide skips. Priority = dict order of
# SECTIONS (headline always runs; cv sits before diskstream/epistasis so a
# congested run sheds the sections whose story the link probe already tells).
SECTION_FLOOR = {
    "headline": 0,
    "linkprobe": 15,
    "northstar": 90,
    "sampler": 150,
    "samplerbig": 90,
    "gwas": 70,
    "cv": 100,
    "diskstream": 130,
    "epistasis": 60,
}
SECTION_CAP = 600  # hard per-section subprocess timeout ceiling


def _run_section(names: str) -> None:
    """Run one or more (comma-separated) sections in THIS process.

    Sections are grouped so the suite pays backend init and compilation as
    few times as possible. Between sections the group honors the parent's
    absolute deadline (GBM_BENCH_DEADLINE, epoch seconds) minus each
    section's floor. A failure in one section is caught and the group moves
    on (groups are separate processes so that a RESOURCE_EXHAUSTED in one
    cannot wedge the device allocator for the next).
    """
    import jax

    from genomicbreedingmodels_tpu.utils.backend import enable_compile_cache, platform

    # Persistent compilation cache shared across processes (and with
    # chip_smoke.py): a machine that compiled these shapes before pays none
    # of it.
    enable_compile_cache()
    force_cpu = os.environ.get("GBM_BENCH_FORCE_CPU", "0") == "1"
    if force_cpu:
        jax.config.update("jax_platforms", "cpu")
    at_size = platform() != "cpu"
    if not at_size and not force_cpu:
        note("# bench: no accelerator found; set GBM_BENCH_FORCE_CPU=1 for the "
             "small CPU rehearsal shapes")
        sys.exit(2)
    deadline = float(os.environ.get("GBM_BENCH_DEADLINE", "0") or 0)
    for name in names.split(","):
        if deadline and name != "headline":
            remaining = deadline - time.time()
            if remaining < SECTION_FLOOR[name]:
                note(
                    f"# bench section {name} SKIPPED in-group: {remaining:.0f}s "
                    f"left < floor {SECTION_FLOOR[name]}s"
                )
                continue
        try:
            SECTIONS[name](at_size)
        except Exception as err:  # keep the rest of the group alive
            note(f"# bench section {name} failed in-group: {err!r:.300}")


def main() -> None:
    import subprocess

    # The in-group deadline checks shed tail sections first if a run is slow.
    budget = float(os.environ.get("GBM_BENCH_BUDGET", "720"))
    t_start = time.perf_counter()

    # Sections run in GROUPED subprocesses, ONE AFTER ANOTHER, and this
    # parent never starts a JAX backend: one process holds the card at a
    # time (a JAX process reserves most of the card's memory when it starts,
    # so a second one would fail). Groups isolate device-memory poisoning (a
    # RESOURCE_EXHAUSTED can leave the allocator unusable for every later
    # call in the same process) while paying backend init once per group.
    #
    # The HEADLINE runs FIRST in its own subprocess (so it survives any
    # outer wall-clock kill of the full suite) and its line is RE-EMITTED
    # after every group so the LAST printed JSON line is always the
    # headline metric.
    if os.environ.get("GBM_BENCH_HEADLINE_ONLY", "0") == "1":
        groups = [["headline"]]
    else:
        # TWO processes total: the guaranteed headline, then every other
        # section sharing ONE backend init. A section that wedges the device
        # allocator only costs the sections after it — each is try/except'd
        # in-group.
        groups = [
            ["headline"],
            ["linkprobe", "northstar", "sampler", "samplerbig", "gwas", "cv",
             "diskstream", "epistasis"],
        ]
        if os.environ.get("GBM_BENCH_DISK", "1") == "0":
            groups[1].remove("diskstream")
    headline_line = None
    for gi, group in enumerate(groups):
        remaining = budget - (time.perf_counter() - t_start)
        group = [
            nm for nm in group
            if nm == "headline" or remaining >= SECTION_FLOOR[nm]
        ] or None
        if group is None:
            note(
                f"# bench group SKIPPED: {remaining:.0f}s left of "
                f"GBM_BENCH_BUDGET={budget:.0f}s under every section floor"
            )
            continue
        is_headline = group == ["headline"]
        if is_headline:
            timeout_s = SECTION_CAP
        else:
            # Split what's left across this and the LATER non-headline
            # groups, weighted by their floor sums, so an early group cannot
            # starve the rest of the suite.
            my_floor = sum(SECTION_FLOOR[nm] for nm in group)
            later_floor = sum(
                SECTION_FLOOR[nm] for g in groups[gi + 1:] for nm in g
            )
            share = remaining * my_floor / max(my_floor + later_floor, 1)
            # Clamp to the documented hard per-section ceiling: with a raised
            # GBM_BENCH_BUDGET an unclamped share would let one wedged group
            # run arbitrarily long past SECTION_CAP x its section count.
            timeout_s = max(60, min(share, SECTION_CAP * len(group)))
        env = dict(os.environ)
        env["GBM_BENCH_DEADLINE"] = str(time.time() + timeout_s)
        try:
            r = subprocess.run(
                [sys.executable, __file__, "--section", ",".join(group)],
                timeout=timeout_s,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
                env=env,
            )
            out = (r.stdout or "").strip()
            if out:
                print(out, flush=True)
            for ln in (r.stderr or "").splitlines():
                if ln.startswith("#"):  # stage/skip notes only, not tracebacks
                    note(ln)
            if is_headline and out:
                headline_line = out.splitlines()[-1]
            if r.returncode != 0:
                note(f"# bench group {group} failed: exit {r.returncode}")
        except subprocess.TimeoutExpired as e:
            # Salvage whatever the group printed before the deadline —
            # sections emit (flushed) as they finish, so finished sections'
            # metrics survive the kill.
            out = e.stdout or b""
            if isinstance(out, bytes):
                out = out.decode(errors="replace")
            out = out.strip()
            if out:
                print(out, flush=True)
            note(f"# bench group {group} timed out after {timeout_s:.0f}s")
        if not is_headline and headline_line:
            print(headline_line, flush=True)
    if headline_line is None:
        # The parse contract promises the last stdout line is the headline
        # JSON; if the headline subprocess itself died, say so in-band with a
        # sentinel metric rather than leaving a section metric last.
        emit("GRM+GBLUP SNPs/s/chip (headline FAILED; see stderr)", 0.0, "SNPs/s")


def _run_parity() -> None:
    # Accuracy ledger, not throughput: one JSON row per model-vs-f64-oracle
    # measurement, on JAX's default device. Feeds PARITY.md via
    # scripts/update_parity_md.py.
    from genomicbreedingmodels_tpu.parity import run_parity_ledger

    rows = run_parity_ledger()
    bad = [r for r in rows if not r["pass"]]
    if bad:
        note(f"# parity FAILURES: {[r['model'] for r in bad]}")
        sys.exit(1)


if __name__ == "__main__":
    if len(sys.argv) >= 2 and sys.argv[1] == "--parity":
        _run_parity()
    elif len(sys.argv) >= 3 and sys.argv[1] == "--section":
        _run_section(sys.argv[2])
    else:
        main()
