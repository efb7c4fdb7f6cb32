"""Benchmark: single-end alignment throughput on one GPU.

    python bench.py [--seed N]

Workload ~ BASELINE.json config 1: E. coli-scale genome (4.6 Mbp),
100 bp single-end simulated reads (1% error), full pipeline
(seeding -> chaining -> extension on device; dedup/primary/CIGAR
finalization to SAM records).

Prints the device (JAX platform, device kind and count; the card's
name and power limit from nvidia-smi), then ONE JSON line:
  {"metric": ..., "value": reads/sec, "unit": "reads/s",
   "vs_baseline": value / BWAMEM2_40CORE_EST, "device": {...}}
Exits non-zero unless JAX's default backend is a GPU.

Baseline: the reference publishes no absolute reads/s (BASELINE.md);
BWAMEM2_40CORE_EST is 40x a single-core bwa-mem2 run on a CPU host
(tools/bench_bwamem2.sh), so vs_baseline > 2.0 corresponds to the
north-star ">2x reads/s per card vs 40-core bwa-mem2".
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

# Persistent XLA compile cache: cached reruns skip the warm-up compiles.
from bwa_mem_scale_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()

# bwa-mem2 -t1 on the identical E. coli genome + reads, measured on a
# CPU host (tools/bench_bwamem2.sh) = 21,538 reads/s single-core x 40
# cores (near-linear scaling for a cache-resident index per the
# bwa-mem2 paper).
BWAMEM2_40CORE_EST = float(os.environ.get(
    "BENCH_BWAMEM2_ECOLI40", 40 * 21_538.0))
# hg38 denominator: an estimate (40 x 1,650 reads/s single-core), not
# a measurement.
BWAMEM2_40CORE_HG38_EST = float(os.environ.get(
    "BENCH_BWAMEM2_HG38", 40 * 1650.0))

GENOME_BP = int(os.environ.get("BENCH_GENOME_BP", 4_600_000))
READ_LEN = int(os.environ.get("BENCH_READ_LEN", 101))
# reads per device batch (not yet swept on the GPU, ROADMAP 1.5)
BATCH = int(os.environ.get("BENCH_BATCH", 8192))
N_BATCHES = int(os.environ.get("BENCH_N_BATCHES", 4))
ERR = 0.01
FMA_K = int(os.environ.get("BENCH_FMA_K", 11))
# onehot: scatter-free read-per-lane machine (ops/smem_oh.py), the
# CLI's default; readlane/sweep kept for A/B.
SEED_ENGINE = os.environ.get("BENCH_SEED_ENGINE", "onehot")
# readlane worker lanes (backlog refill); 0/unset = one lane per read
SEED_LANES = int(os.environ.get("BENCH_SEED_LANES", 0)) or None
# k-step checkpoint table: FWD extensions consume K bases per
# dependent gather (index/kstep.py); bit-identical output.
# "0" = off (the default); "auto" runs the per-config timing harness
# (one device batch each) and keeps the fastest; "1"/"2" = bigram,
# "3" = trigram.
_KS = os.environ.get("BENCH_KSTEP", "0")
KSTEP_AUTO = _KS == "auto"
KSTEP = _KS not in ("0", "auto")
KSTEP_K = 3 if _KS == "3" else 2
# Prebuilt genome-scale index (BASELINE configs 2+): point
# BENCH_INDEX_PREFIX at e.g. data/chr21s or data/hg38s to bench that
# genome instead of the synthetic E. coli default. EMF/FMA tables are
# used only if present next to the index (building them at bench time
# would dominate the run at these scales).
INDEX_PREFIX = os.environ.get("BENCH_INDEX_PREFIX")
BENCH_TAG = os.environ.get("BENCH_TAG")   # metric-name override

CACHE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    ".bench_index.tpuidx.npz" if GENOME_BP == 4_600_000
    else f".bench_index_{GENOME_BP}.tpuidx.npz")


_IDX_CACHE = {}


def _load_host_index():
    """Host-side index + EMF/FMA tables (loaded once, shared across
    aligner configs in auto-select mode)."""
    if "idx" in _IDX_CACHE:
        return _IDX_CACHE
    from bwa_mem_scale_tpu.index.artifacts import load_index, save_index
    from bwa_mem_scale_tpu.models.aligner import demo_genome
    from bwa_mem_scale_tpu.index.build import build_index
    from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex
    from bwa_mem_scale_tpu.ops.fma import (build_fma_table, save_fma,
                                           load_fma)
    from bwa_mem_scale_tpu.index.perfect import (build_perfect_table,
                                                 save_perfect_table,
                                                 load_perfect_table)

    if INDEX_PREFIX:
        t0 = time.time()
        idx = load_index(INDEX_PREFIX)
        print(f"* loaded {INDEX_PREFIX} "
              f"(l_pac={idx.bns.l_pac:,}, "
              f"pos_dtype={'int32' if idx.pos_fits_int32 else 'int64'}"
              f") in {time.time() - t0:.1f}s", file=sys.stderr)
        prefix = INDEX_PREFIX
        fma = None
        if SEED_ENGINE == "sweep":
            fma_path = f"{prefix}.fma{FMA_K}.npz"
            fma = load_fma(fma_path) if os.path.exists(fma_path) else None
        emf_path = f"{prefix}.emf{READ_LEN}.npz"
        emf = (load_perfect_table(emf_path)
               if os.path.exists(emf_path)
               and not os.environ.get("BENCH_NO_EMF") else None)
    else:
        prefix = CACHE[: -len(".tpuidx.npz")]
        if os.path.exists(CACHE):
            idx = load_index(CACHE)
        else:
            print("* building benchmark index...", file=sys.stderr)
            t0 = time.time()
            bns = demo_genome(GENOME_BP, seed=7, n_contigs=1)
            # full SA residency: the MEMSCALE memory-for-speed tradeoff
            idx = build_index(bns, sa_compx=0)
            save_index(idx, prefix)
            print(f"* index built in {time.time() - t0:.1f}s",
                  file=sys.stderr)

        # FMA is only consumed by the sweep engine (ops/smem_rl.py
        # docstring: measured wash on readlane; the one-hot machine
        # doesn't consume it either) — don't spend bench budget
        # building a table the default engine discards.
        fma = None
        if SEED_ENGINE == "sweep":
            fma_path = f"{prefix}.fma{FMA_K}.npz"
            if os.path.exists(fma_path):
                fma = load_fma(fma_path)
            else:
                t0 = time.time()
                fma = build_fma_table(DeviceFMIndex.from_host(idx),
                                      K=FMA_K)
                save_fma(fma, prefix)
                print(f"* FMA table (K={FMA_K}) built in "
                      f"{time.time() - t0:.1f}s", file=sys.stderr)

        emf_path = f"{prefix}.emf{READ_LEN}.npz"
        if os.environ.get("BENCH_NO_EMF"):
            # accelerator A/B: default config vs
            # the same pipeline with the EMF short-circuit disabled
            emf = None
        elif os.path.exists(emf_path):
            emf = load_perfect_table(emf_path)
        else:
            t0 = time.time()
            emf = build_perfect_table(idx, seed_len=READ_LEN)
            save_perfect_table(emf, prefix)
            print(f"* EMF table built in {time.time() - t0:.1f}s",
                  file=sys.stderr)

    _IDX_CACHE.update(idx=idx, emf=emf, fma=fma, prefix=prefix)
    return _IDX_CACHE


def _load_cp2(kstep_k):
    """k-step table for the given K (None = off). Builds it for the
    synthetic bench genome; for prebuilt indexes (INDEX_PREFIX) only
    loads an existing artifact — building one at bench time would
    dominate the run."""
    if kstep_k is None:
        return None
    from bwa_mem_scale_tpu.index.kstep import build_cp2, save_cp2, load_cp2
    prefix = _load_host_index()["prefix"]
    cp2_path = f"{prefix}.cp{kstep_k}.npz"
    if os.path.exists(cp2_path):
        return load_cp2(cp2_path)
    if INDEX_PREFIX:
        return None
    t0 = time.time()
    cp2 = build_cp2(_load_host_index()["idx"], K=kstep_k)
    save_cp2(cp2, prefix)
    print(f"* {kstep_k}-step table built in {time.time() - t0:.1f}s",
          file=sys.stderr)
    return cp2


def get_aligner(kstep_k=None):
    from bwa_mem_scale_tpu.config import MemOptions
    from bwa_mem_scale_tpu.pipeline.align import TpuAligner, PipelineConfig
    h = _load_host_index()
    # Repeat-rich genome-scale workloads (hg38-class, int64
    # positions) overflow a 256-coord budget on ~30% of reads
    # (measured round 3); provision 2x so the retry ladder is the
    # exception, not the path.
    big = not h["idx"].pos_fits_int32
    # hg38 measured demand (round-4 probes): pairs mean 4.7/read with
    # a 19k-batch peak (4*B = 16,384 was the dominant overflow
    # driver), coords P100 = 720 at base 512.
    cfg = PipelineConfig(max_coords=512 if big else 256,
                         max_chains=64 if big else 32,
                         max_seeds_per_chain=16,
                         max_regs=64 if big else 32,
                         max_pairs=(8 if big else 4) * BATCH,
                         seed_engine=SEED_ENGINE,
                         seed_lanes=SEED_LANES)
    return TpuAligner(h["idx"], MemOptions(), cfg, fma=h["fma"],
                      emf=h["emf"], cp2=_load_cp2(kstep_k))


def _card() -> str:
    """The card's name and power limit (nvidia-smi, a child process
    that does not touch the device)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description="single-end reads/s on "
                                             "one GPU")
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed of the simulated read batches")
    args = ap.parse_args(argv)
    import jax

    devs = jax.devices()
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    print(f"* device: {device}", file=sys.stderr)
    if device["platform"] != "gpu":
        print("bench.py measures the GPU; JAX found "
              f"{device['platform']}", file=sys.stderr)
        return 1
    card = _card()
    print(f"* card: {card}", file=sys.stderr)

    from bwa_mem_scale_tpu.models.aligner import simulate_reads

    h = _load_host_index()
    seed0 = args.seed
    print(f"* batch seed base {seed0}", file=sys.stderr)
    batches = [simulate_reads(h["idx"].bns, BATCH, READ_LEN,
                              seed=seed0 + i, err_rate=ERR)
               for i in range(N_BATCHES)]

    def _dev_time(al, n=2):
        """Seconds per device batch (seed+chain+extend), warm."""
        for codes, lens in batches[:1]:      # compile
            jax.block_until_ready(al._jit_extend(
                al.fmi, al.dbns, np.asarray(codes, dtype=np.int32),
                np.asarray(lens, dtype=np.int32), L=READ_LEN,
                fma=al.dfma, ert=al.dert))
        t0 = time.time()
        for codes, lens in batches[1:1 + n]:
            jax.block_until_ready(al._jit_extend(
                al.fmi, al.dbns, np.asarray(codes, dtype=np.int32),
                np.asarray(lens, dtype=np.int32), L=READ_LEN,
                fma=al.dfma, ert=al.dert))
        return (time.time() - t0) / n

    if KSTEP_AUTO:
        # Self-select the k-step config by measurement. Candidates
        # whose table isn't available collapse to the 1-step config
        # and are deduped.
        cands, seen = [], set()
        for kk in (None, 2, 3):
            cp2 = _load_cp2(kk)
            key = "off" if cp2 is None else f"K{kk}"
            if key in seen:
                continue
            seen.add(key)
            cands.append((key, kk if cp2 is not None else None))
        best, aligner = None, None
        for key, kk in cands:
            al = get_aligner(kk)
            try:
                dt = _dev_time(al)
            except Exception as e:
                print(f"* kstep={key}: failed ({type(e).__name__}: "
                      f"{e}); skipping", file=sys.stderr)
                continue
            print(f"* kstep={key}: {BATCH / dt:,.0f} reads/s "
                  f"device stage", file=sys.stderr)
            if best is None or dt < best[1]:
                best, aligner = (key, dt), al
        if best is None:
            raise SystemExit("every kstep candidate failed to "
                             "compile/run (see messages above)")
        print(f"* selected kstep={best[0]}", file=sys.stderr)
    else:
        aligner = get_aligner(KSTEP_K if KSTEP else None)

    t0 = time.time()
    codes, lens = batches[0]
    recs = aligner.align_and_finalize(codes, lens)
    print(f"* warmup (compile) {time.time() - t0:.1f}s", file=sys.stderr)
    n_mapped = sum(1 for r in recs if r and r[0].rid >= 0)
    print(f"* warmup mapped {n_mapped}/{BATCH}", file=sys.stderr)

    # Device-only timing (seeding+chaining+extension).
    t0 = time.time()
    for codes, lens in batches:
        jax.block_until_ready(aligner._jit_extend(
            aligner.fmi, aligner.dbns,
            np.asarray(codes, dtype=np.int32),
            np.asarray(lens, dtype=np.int32), L=READ_LEN,
            fma=aligner.dfma, ert=aligner.dert))
    dev_dt = time.time() - t0
    dev_rps = N_BATCHES * BATCH / dev_dt
    print(f"* device stage: {dev_rps:,.0f} reads/s", file=sys.stderr)

    # End-to-end timing: EMF-compacted stream with one device batch
    # in flight (same machinery as the CLI driver), producing
    # finished SAM text per read (native compose_sam_se — the
    # production deliverable, not boxed record objects).
    from bwa_mem_scale_tpu.pipeline.stream import SeStream
    from bwa_mem_scale_tpu.pipeline import native_finalize
    SAM_MODE = (native_finalize.available()
                and not os.environ.get("BENCH_NO_SAM"))
    stream = SeStream(aligner, BATCH, READ_LEN, sam=SAM_MODE)
    # warm the compacted-batch compile path (skip_emf variant)
    stream.feed(*batches[0], 0)
    stream.flush()
    n_out = sum(1 for _ in stream.ready())
    assert n_out == BATCH

    from bwa_mem_scale_tpu.utils.profiling import PROFILER
    PROFILER.totals.clear()
    PROFILER.counts.clear()
    stream = SeStream(aligner, BATCH, READ_LEN, sam=SAM_MODE)
    t0 = time.time()
    total = 0
    n_out = 0
    sam_bytes = 0
    for codes, lens in batches:
        stream.feed(codes, lens, total)
        total += len(lens)
        for _rid, rec in stream.ready():
            n_out += 1
            if SAM_MODE:
                sam_bytes += len(rec)
    stream.flush()
    for _rid, rec in stream.ready():
        n_out += 1
        if SAM_MODE:
            sam_bytes += len(rec)
    assert n_out == total, (n_out, total)
    dt = time.time() - t0
    if os.environ.get("BENCH_PROFILE"):
        PROFILER.report()
    rps = total / dt
    print(f"* end-to-end: {rps:,.0f} reads/s ({dt:.2f}s for {total}"
          + (f", {sam_bytes / 1e6:.1f} MB SAM text" if SAM_MODE
             else "") + ")", file=sys.stderr)
    if aligner.emf_checked:
        print(f"* EMF hits: {aligner.emf_hits}/{aligner.emf_checked}",
              file=sys.stderr)
    n_retry = getattr(aligner, "overflow_retried", 0)
    n_oracle = getattr(aligner, "overflow_oracle", 0)
    if n_retry or n_oracle:
        print(f"* overflow: {n_retry} reads retried at 4x shapes, "
              f"{n_oracle} fell through to the host oracle",
              file=sys.stderr)
    comp = getattr(aligner, "oracle_of_components", None)
    if comp:
        print(f"* tier-2 overflow components: {comp}", file=sys.stderr)

    # Roofline accounting: count the seeding machine's dependent FM extensions (= busy lane-ticks) and the
    # exact bytes its occ gathers must touch, so perf work has a
    # denominator. Skipped only if the diagnostic run fails.
    roofline = {}
    try:
        from bwa_mem_scale_tpu.ops.smem_oh import one_pos_machine_oh
        from bwa_mem_scale_tpu.ops.smem import SmemBuf
        import jax.numpy as jnp
        codes, lens = batches[0]
        B = codes.shape[0]
        _, (ticks, done_at, phase_ticks) = one_pos_machine_oh(
            aligner.fmi, jnp.asarray(np.asarray(codes, np.int32)),
            jnp.asarray(np.asarray(lens, np.int32)),
            jnp.arange(B, dtype=jnp.int32), jnp.zeros(B, jnp.int32),
            jnp.ones(B, jnp.int32), jnp.asarray(lens) > 0, True,
            aligner.opt.min_seed_len, READ_LEN,
            SmemBuf.empty(B, READ_LEN, aligner.fmi.pos_dtype),
            with_ticks=True)
        ticks = int(np.asarray(ticks))
        busy = int(np.asarray(phase_ticks)[:4].sum())
        row_b = (aligner.fmi.cp2_fused.shape[1] * 4
                 if aligner.fmi.cp2_fused is not None else 32)
        occ_bytes = ticks * 2 * B * row_b   # 2 addresses/lane/tick
        dev_batch_s = dev_dt / N_BATCHES
        roofline = {
            "fm_ext_per_read": round(busy / B, 1),
            "seed_ticks_p1": ticks,
            "occ_bytes_per_read": round(occ_bytes / B, 1),
            "occ_gather_gbps": round(occ_bytes / dev_batch_s / 1e9, 2),
        }
        print(f"* roofline: pass-1 {ticks} ticks, "
              f"{busy / B:.0f} FM ext/read, occ gathers "
              f"{occ_bytes / 1e6:.0f} MB/batch "
              f"({roofline['occ_gather_gbps']} GB/s-equiv; lockstep "
              f"tail = "
              f"{1 - busy / max(ticks * B, 1):.0%} idle lanes)",
              file=sys.stderr)
    except Exception as e:
        print(f"* roofline accounting skipped: {type(e).__name__}: "
              f"{e}", file=sys.stderr)

    if BENCH_TAG:
        metric = f"se_reads_per_sec_chip_{BENCH_TAG}"
    elif INDEX_PREFIX:
        base = os.path.basename(INDEX_PREFIX).split(".")[0]
        metric = f"se_reads_per_sec_chip_{base}_{READ_LEN}bp"
    else:
        metric = ("se_reads_per_sec_chip_ecoli101"
                  if GENOME_BP == 4_600_000 and READ_LEN == 101 else
                  f"se_reads_per_sec_chip_{GENOME_BP // 1_000_000}"
                  f"mbp_{READ_LEN}bp")
    extra = {}
    n_retry = getattr(aligner, "overflow_retried", 0)
    if n_retry:
        extra["overflow_retried"] = n_retry
        extra["overflow_oracle"] = getattr(aligner, "overflow_oracle",
                                           0)
    payload = {
        "metric": metric,
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps / BWAMEM2_40CORE_EST, 4),
        "device": device,
        "card": card,
        **roofline,
        **extra,
    }
    if INDEX_PREFIX and not h["idx"].pos_fits_int32:
        payload["vs_baseline"] = round(rps / BWAMEM2_40CORE_HG38_EST, 4)
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    sys.exit(main())
