#!/usr/bin/env python3
"""Smoke test of the aligner's main path on an NVIDIA GPU.

    python3 chip_smoke.py              # phases a-e on one card
    python3 chip_smoke.py --mesh 4     # only `mem --devices 4` vs 1

a. Device check: JAX's platform, device kind and count, and the card's
   name and power limit from nvidia-smi. Fails unless the platform is
   "gpu".
b. BSW at real widths: the Pallas kernel (ops/bsw_pallas.py) against
   ops/bsw.banded_swa_batch on the pair count of one 8192-read batch
   (4 x 8192 pairs, 151 bp queries), band w and 2w: all six result
   fields equal, a sample of pairs equal to the scalar oracle
   (ref/bsw.py), and the warm median time of both engines.
c. Single-end at chr21 scale through the CLI: `index -s 0` and
   `perfect-index -l 151` on data/chr21s.fa, then `mem --batch-reads
   8192` on simulated 151 bp reads (tools/make_reads.py, 1% errors,
   0.1% indels). Checks: primary records of a read sample identical to
   the oracle pipeline (ref/pipeline.py), the share placed at the
   simulated position, the overflow-retry and oracle fall-through
   counts, native finalize in use. Then the end-to-end A/B of the two
   BSW engines: the same reads through the SE stream in this process,
   passes kernel, jnp, jnp, kernel; the SAM text must be identical.
d. Paired-end at chr21 scale: `mem` on simulated pairs; the SAM of one
   batch byte-equal between the native and the Python PE path
   (BWA_TPU_NO_NATIVE_PE=1); the properly paired share.
e. Report: reads/s of c and d with the card's name and power limit,
   set-up (compile) time, peak device memory, BSW times.

--mesh N runs only the read-sharded path: the SE and PE read sets
through `mem --devices N` and `--devices 1`, SAM bodies byte-equal,
reads/s of both, and the index replicated once on every card.

Everything that uses JAX runs in this process. The index build and the
read simulation run as CPU-only children (JAX_PLATFORMS=cpu) while
phase b holds the card. Work files go to build/smoke/ (git-ignored).
The last line of standard output is one JSON object; any failed phase
exits non-zero without it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "smoke")
FASTA = os.path.join(REPO, "data", "chr21s.fa")
READ_LEN = 151
BATCH = 8192
SE_READS = 100_000
PE_PAIRS = 50_000
ORACLE_SAMPLE = 200
PLACE_TOL = 10          # bp between the simulated and the reported POS

_CHILDREN: list = []


def say(msg: str) -> None:
    print(msg, flush=True)


def card_lines() -> list:
    """nvidia-smi's name and power limit, one line per card (a child
    process that does not import JAX)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


class HostJobs:
    """CPU-only commands run one after another on a background thread
    (the index build and the read simulation need no card)."""

    def __init__(self, cmds):
        self.cmds = cmds
        self.times = []
        self.err = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   CUDA_VISIBLE_DEVICES="")
        for cmd in self.cmds:
            t0 = time.perf_counter()
            p = subprocess.Popen(cmd, cwd=REPO, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
            _CHILDREN.append(p)
            _, err = p.communicate()
            self.times.append(time.perf_counter() - t0)
            if p.returncode:
                self.err = (f"{' '.join(cmd)} exited {p.returncode}:\n"
                            f"{err[-3000:]}")
                return

    def wait(self):
        self.thread.join()
        if self.err:
            raise RuntimeError(self.err)
        return self.times


def cli_cmd(*args) -> list:
    return [sys.executable, "-m", "bwa_mem_scale_tpu.cli", *args]


def start_host_jobs(n_se: int, n_pe: int):
    """Index and EMF table on one thread, reads on two more."""
    os.makedirs(WORK, exist_ok=True)
    prefix = os.path.join(WORK, "chr21s")
    idx_cmds = [cli_cmd("index", FASTA, "-p", prefix, "-s", "0"),
                cli_cmd("perfect-index", prefix, "-l", str(READ_LEN))]
    mk = [sys.executable, os.path.join(REPO, "tools", "make_reads.py"),
          FASTA]
    se = os.path.join(WORK, "se.fq")
    pe1, pe2 = (os.path.join(WORK, f"pe{k}.fq") for k in (1, 2))
    jobs = dict(
        index=HostJobs(idx_cmds),
        se=HostJobs([mk + [se, "-n", str(n_se), "-l", str(READ_LEN),
                           "--err", "0.01", "--indel", "0.001",
                           "--seed", "11"]]),
        pe=HostJobs([mk + [pe1, "-n", str(n_pe), "-l", str(READ_LEN),
                           "--err", "0.01", "--indel", "0.001",
                           "--seed", "12", "--pe", pe2]]))
    return prefix, se, (pe1, pe2), jobs


def head_fastq(src: str, dst: str, n_reads: int) -> str:
    with open(src) as f, open(dst, "w") as g:
        for i, ln in enumerate(f):
            if i >= 4 * n_reads:
                break
            g.write(ln)
    return dst


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


@contextlib.contextmanager
def _env(extra):
    old = {k: os.environ.get(k) for k in extra}
    os.environ.update(extra)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_mem(prefix, fastqs, out, *extra, env=None) -> dict:
    """`cli mem` in this process. Returns wall seconds and the counters
    it prints."""
    from bwa_mem_scale_tpu import cli as cli_mod
    from bwa_mem_scale_tpu.utils.profiling import PROFILER
    PROFILER.totals.clear()
    PROFILER.counts.clear()
    buf = io.StringIO()
    argv = ["mem", prefix, *fastqs, "-o", out, "--batch-reads",
            str(BATCH), *extra]
    with _env(env or {}), contextlib.redirect_stderr(
            _Tee(sys.stderr, buf)):
        t0 = time.perf_counter()
        rc = cli_mod.main(argv)
        wall = time.perf_counter() - t0
    if rc:
        raise RuntimeError(f"mem {' '.join(argv)} exited {rc}")
    text = buf.getvalue()
    m = re.search(r"overflow retries: (\d+) reads \((\d+) to oracle\)",
                  text)
    n = re.search(r"\* aligned (\d+) reads", text)
    return dict(wall=wall, reads=int(n.group(1)) if n else 0,
                retried=int(m.group(1)) if m else 0,
                oracle=int(m.group(2)) if m else 0)


def sam_body(path: str) -> bytes:
    with open(path, "rb") as f:
        return b"".join(ln for ln in f if not ln.startswith(b"@"))


def primary_lines(path: str) -> dict:
    out = {}
    with open(path) as f:
        for ln in f:
            if ln.startswith("@"):
                continue
            cols = ln.split("\t", 3)
            if not int(cols[1]) & 0x900:
                out.setdefault(cols[0], []).append(ln.rstrip("\n"))
    return out


# ---------------------------------------------------------------- phase b

def bsw_inputs(P, QL, TL, w, seed):
    """Extension pairs shaped like one batch's: query flanks up to the
    read length, targets that follow them with substitutions and short
    indels, dead lanes, h0 a seed score."""
    import numpy as np
    rng = np.random.default_rng(seed)
    q_lens = rng.integers(1, QL + 1, P)
    t_lens = np.minimum(q_lens + rng.integers(0, w + 1, P), TL)
    dead = rng.random(P) < 0.1
    q_lens[dead] = 0
    t_lens[dead] = 0
    qs = rng.integers(0, 4, (P, QL))
    ts = rng.integers(0, 4, (P, TL))
    sub = rng.random((P, QL)) < 0.02
    ts[:, :QL] = np.where(sub, rng.integers(0, 4, (P, QL)), qs)
    for k in np.flatnonzero(rng.random(P) < 0.25):
        p = int(rng.integers(1, QL - 1))
        ts[k, p:] = np.roll(ts[k, p:], int(rng.integers(-3, 4)))
    h0 = rng.integers(19, READ_LEN + 1, P)
    i32 = np.int32
    return (qs.astype(i32), q_lens.astype(i32), ts.astype(i32),
            t_lens.astype(i32), h0.astype(i32))


def median_time(fn, args, n=5) -> float:
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def phase_bsw(report):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from bwa_mem_scale_tpu.config import MemOptions
    from bwa_mem_scale_tpu.ops.bsw import banded_swa_batch
    from bwa_mem_scale_tpu.ops.bsw_pallas import banded_swa_batch_pallas
    from bwa_mem_scale_tpu.pipeline.align import select_bsw
    from bwa_mem_scale_tpu.ref.bsw import scalar_banded_swa

    if select_bsw(jax.default_backend()) is not banded_swa_batch_pallas:
        raise RuntimeError("the GPU does not select the Pallas kernel")
    opt = MemOptions()
    P, QL = 4 * BATCH, READ_LEN
    TL = QL + 2 * opt.w + 8
    fields = ("score", "qle", "tle", "gtle", "gscore", "max_off")
    res = {}
    for w in (opt.w, 2 * opt.w):
        host = bsw_inputs(P, QL, TL, w, seed=w)
        args = tuple(jnp.asarray(x) for x in host)
        pen = (w, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop,
               opt.mat)
        kern = jax.jit(lambda *a: banded_swa_batch_pallas(*a, *pen))
        ref = jax.jit(lambda *a: banded_swa_batch(*a, *pen))
        t0 = time.perf_counter()
        got = jax.block_until_ready(kern(*args))
        t_compile = time.perf_counter() - t0
        want = jax.block_until_ready(ref(*args))
        for f in fields:
            a = np.asarray(getattr(got, f))
            b = np.asarray(getattr(want, f))
            if not (a == b).all():
                bad = np.flatnonzero(a != b)
                raise AssertionError(
                    f"BSW w={w} {f}: {bad.size} pairs differ from the "
                    f"jnp kernel (first {bad[:5].tolist()})")
        qs, ql, ts, tl, h0 = host
        live = np.flatnonzero((ql > 0) & (tl > 0))
        sample = live[:: max(len(live) // 150, 1)][:150]
        for k in sample.tolist():
            s = scalar_banded_swa(qs[k, :ql[k]], ts[k, :tl[k]], w,
                                  int(h0[k]), opt.o_del, opt.e_del,
                                  opt.o_ins, opt.e_ins, opt.zdrop,
                                  opt.mat)
            g = tuple(int(np.asarray(getattr(got, f))[k]) for f in fields)
            if g != tuple(getattr(s, f) for f in fields):
                raise AssertionError(f"BSW w={w} pair {k}: kernel {g} "
                                     f"vs scalar oracle {s}")
        res[w] = dict(kernel_s=median_time(kern, args),
                      jnp_s=median_time(ref, args),
                      compile_s=t_compile, scalar_checked=len(sample))
        say(f"phase b: BSW w={w} P={P}: kernel == jnp on all 6 fields, "
            f"{len(sample)} pairs == scalar oracle; kernel "
            f"{res[w]['kernel_s'] * 1e3:.3f} ms, jnp "
            f"{res[w]['jnp_s'] * 1e3:.3f} ms (warm median of 5), kernel "
            f"compile {t_compile:.1f} s")
    report["bsw"] = res


# ---------------------------------------------------------------- phase c

def primary_stats(sam_path: str) -> tuple:
    """(placed, properly paired, total) over primary records; placed
    means within PLACE_TOL of the simulated position that
    tools/make_reads.py encodes in the read name (mate 2's second)."""
    placed = proper = total = 0
    with open(sam_path) as f:
        for ln in f:
            if ln.startswith("@"):
                continue
            cols = ln.split("\t", 5)
            flag = int(cols[1])
            if flag & 0x900:
                continue
            total += 1
            proper += bool(flag & 0x2)
            if flag & 0x4:
                continue
            parts = cols[0].split("_")
            want = int(parts[2] if flag & 0x80 else parts[1])
            placed += abs(int(cols[3]) - want) <= PLACE_TOL
    return placed, proper, total


def _equal_but_emf_secondaries(got, want) -> bool:
    """The documented EMF class: a perfect-match read short-circuited
    by the EMF table reports only other perfect hits as secondaries
    (XS:i:0 and no XA otherwise), as the reference's mem_perfect2sam
    does; every other field must be identical."""
    if got is None or len(got) != len(want):
        return False
    for g, w in zip(got, want):
        gf = g.split("\t")
        if any(f.startswith("XA:Z:") for f in gf):
            return False
        if [f for f in gf if not f.startswith("XS:i:")] != \
                [f for f in w.split("\t")
                 if not f.startswith(("XS:i:", "XA:Z:"))]:
            return False
    return True


def oracle_sample(prefix: str, se_fq: str, sam_path: str) -> dict:
    """Primary records of an evenly spaced read sample vs the oracle
    pipeline (ref/pipeline.py), which has no EMF short-circuit."""
    import numpy as np
    from bwa_mem_scale_tpu.cli import find_emf
    from bwa_mem_scale_tpu.config import MemOptions
    from bwa_mem_scale_tpu.index.artifacts import load_index
    from bwa_mem_scale_tpu.index.perfect import emf_lookup_host
    from bwa_mem_scale_tpu.io.fastq import ReadBatch, iter_fastx
    from bwa_mem_scale_tpu.ops.emf import FW_MATCHED, RC_MATCHED
    from bwa_mem_scale_tpu.ref.fm import FMOracle
    from bwa_mem_scale_tpu.ref.pipeline import align_batch_to_sam

    reads = list(iter_fastx(se_fq))
    got = primary_lines(sam_path)
    idx = load_index(prefix)
    fm = FMOracle(idx)
    opt = MemOptions()
    step = max(len(reads) // ORACLE_SAMPLE, 1)
    ids = list(range(0, len(reads), step))[:ORACLE_SAMPLE]
    emf_hit = set()
    emf = find_emf(prefix)
    if emf is not None:
        L = max(len(reads[g].seq) for g in ids)
        codes = np.full((len(ids), L), 4, np.int32)
        lens = np.zeros(len(ids), np.int32)
        for j, g in enumerate(ids):
            codes[j, :len(reads[g].seq)] = reads[g].seq
            lens[j] = len(reads[g].seq)
        code = emf_lookup_host(emf, idx.ref_string, codes, lens)["code"]
        emf_hit = {g for g, c in zip(ids, code)
                   if c in (FW_MATCHED, RC_MATCHED)}
    t0 = time.perf_counter()
    diffs, emf_xs = [], 0
    for g in ids:
        r = reads[g]
        want = [ln.rstrip("\n") for ln in align_batch_to_sam(
            fm, opt, ReadBatch([r]), id_offset=g)
            if not int(ln.split("\t", 2)[1]) & 0x900]
        mine = got.get(r.name)
        if mine == want:
            continue
        if g in emf_hit and _equal_but_emf_secondaries(mine, want):
            emf_xs += 1
            continue
        diffs.append((r.name, mine, want))
    for name, g, w in diffs[:5]:
        say(f"  oracle diff {name}:\n    mem    {g}\n    oracle {w}")
    return dict(n=len(ids), diffs=len(diffs), emf_hits=len(emf_hit),
                emf_xs=emf_xs, seconds=time.perf_counter() - t0)


def phase_se(report, prefix, se_fq):
    from bwa_mem_scale_tpu.pipeline import native_finalize
    if not native_finalize.available():
        raise RuntimeError("native finalize did not build or load")
    warm_fq = head_fastq(se_fq, os.path.join(WORK, "se_warm.fq"),
                         2 * BATCH)
    se_sam = os.path.join(WORK, "se.sam")
    warm = run_mem(prefix, [warm_fq], os.path.join(WORK, "warm.sam"))
    run = run_mem(prefix, [se_fq], se_sam)
    placed, _, total = primary_stats(se_sam)
    orc = oracle_sample(prefix, se_fq, se_sam)
    rps = run["reads"] / run["wall"]
    say(f"phase c: SE {run['reads']} reads, {rps:,.1f} reads/s wall "
        f"(kernel BSW); set-up run ({warm['reads']} reads, compile) "
        f"{warm['wall']:.1f} s; placed {placed}/{total} "
        f"({placed / max(total, 1):.2%}); overflow retries "
        f"{run['retried']}, oracle fall-throughs {run['oracle']}; "
        f"oracle sample: {orc['n'] - orc['diffs'] - orc['emf_xs']}/"
        f"{orc['n']} reads' primary records identical, {orc['emf_xs']} "
        f"of the {orc['emf_hits']} EMF hits identical but for the "
        f"documented EMF secondaries (XS/XA), {orc['diffs']} differ "
        f"({orc['seconds']:.0f} s)")
    if orc["diffs"]:
        raise AssertionError(f"{orc['diffs']} sampled reads differ from "
                             f"the oracle pipeline")
    if placed < 0.9 * total:
        raise AssertionError(f"only {placed}/{total} reads placed")

    ab = engine_ab(prefix, se_fq)
    report["se"] = dict(reads=run["reads"], reads_per_s=rps,
                        setup_s=warm["wall"], placed=placed, total=total,
                        retried=run["retried"], oracle=run["oracle"],
                        oracle_sample=orc, ab=ab)


def _stream_pass(al, batches, L) -> tuple:
    """One pass of the SE stream (EMF probe, extend, native SAM text,
    retry backlog) over pre-parsed batches: (reads/s, SAM bytes)."""
    from bwa_mem_scale_tpu.pipeline.stream import SeStream
    st = SeStream(al, BATCH, L, sam=True)
    out = {}
    t0 = time.perf_counter()
    total = 0
    for codes, lens in batches:
        st.feed(codes, lens, total)
        total += len(lens)
        out.update(st.ready())
    st.flush()
    out.update(st.ready())
    dt = time.perf_counter() - t0
    if len(out) != total:
        raise AssertionError(f"stream emitted {len(out)}/{total} reads")
    return total / dt, b"".join(out[i] for i in range(total))


def engine_ab(prefix: str, se_fq: str) -> dict:
    """End-to-end A/B of the BSW engines on the SE stream, in this
    process with the index loaded and every program compiled: passes
    kernel, jnp, jnp, kernel over the same reads. The jnp aligner
    traces its programs with select_bsw pinned to the jnp kernel."""
    import numpy as np
    from bwa_mem_scale_tpu.cli import find_emf
    from bwa_mem_scale_tpu.config import MemOptions
    from bwa_mem_scale_tpu.index.artifacts import load_index
    from bwa_mem_scale_tpu.io.fastq import ReadBatch, iter_fastx
    from bwa_mem_scale_tpu.pipeline import align as align_mod

    reads = list(iter_fastx(se_fq))
    L = max(len(r.seq) for r in reads)
    batches = []
    for b in range(0, len(reads), BATCH):
        codes, lens = ReadBatch(reads[b: b + BATCH]).padded_codes(L)
        batches.append((codes.astype(np.int32), lens))
    idx = load_index(prefix)
    emf = find_emf(prefix)
    cfg = align_mod.PipelineConfig(seed_engine="onehot",
                                   max_pairs=4 * BATCH)
    als = {e: align_mod.TpuAligner(idx, MemOptions(), cfg, emf=emf)
           for e in ("kernel", "jnp")}
    keep = align_mod.select_bsw
    sam = {}
    t0 = time.perf_counter()
    _, sam["kernel"] = _stream_pass(als["kernel"], batches, L)  # compile
    align_mod.select_bsw = lambda platform: align_mod.banded_swa_batch
    try:
        _, sam["jnp"] = _stream_pass(als["jnp"], batches, L)    # compile
    finally:
        align_mod.select_bsw = keep
    setup = time.perf_counter() - t0
    if sam["kernel"] != sam["jnp"]:
        raise AssertionError("SE SAM differs between the BSW engines")
    rates = {"kernel": [], "jnp": []}
    for e in ("kernel", "jnp", "jnp", "kernel"):
        rates[e].append(_stream_pass(als[e], batches, L)[0])
    say(f"phase c: BSW engine A/B on the SE stream, {len(reads)} reads, "
        f"passes kernel/jnp/jnp/kernel: kernel "
        f"{', '.join(f'{r:,.1f}' for r in rates['kernel'])} reads/s, jnp "
        f"{', '.join(f'{r:,.1f}' for r in rates['jnp'])} reads/s; SAM "
        f"identical; warm-up of both {setup:.1f} s")
    return rates


# ---------------------------------------------------------------- phase d

def phase_pe(report, prefix, pe_fqs):
    one = [head_fastq(p, os.path.join(WORK, f"pe_one{k}.fq"), BATCH // 2)
           for k, p in enumerate(pe_fqs, 1)]
    nat_sam = os.path.join(WORK, "pe_one_native.sam")
    py_sam = os.path.join(WORK, "pe_one_python.sam")
    warm = run_mem(prefix, one, nat_sam)
    run_mem(prefix, one, py_sam, env={"BWA_TPU_NO_NATIVE_PE": "1"})
    if sam_body(nat_sam) != sam_body(py_sam):
        raise AssertionError("PE batch SAM differs between the native "
                             "and the Python PE path")
    pe_sam = os.path.join(WORK, "pe.sam")
    run = run_mem(prefix, list(pe_fqs), pe_sam)
    placed, proper, total = primary_stats(pe_sam)
    rps = run["reads"] / run["wall"]
    say(f"phase d: PE {run['reads']} reads, {rps:,.1f} reads/s wall; "
        f"set-up run ({warm['reads']} reads, compile) {warm['wall']:.1f}"
        f" s; one batch byte-equal native vs Python PE; properly paired "
        f"{proper}/{total} ({proper / max(total, 1):.2%}); placed "
        f"{placed}/{total}; overflow retries {run['retried']}, oracle "
        f"fall-throughs {run['oracle']}")
    if proper < 0.8 * total:
        raise AssertionError(f"only {proper}/{total} properly paired")
    report["pe"] = dict(reads=run["reads"], reads_per_s=rps,
                        setup_s=warm["wall"], proper=proper, total=total,
                        placed=placed, retried=run["retried"],
                        oracle=run["oracle"])


# ------------------------------------------------------------ phase --mesh

def phase_mesh(report, n_dev, prefix, se_fq, pe_fqs):
    import jax
    from jax.sharding import NamedSharding
    from bwa_mem_scale_tpu.index.artifacts import load_index
    from bwa_mem_scale_tpu.parallel.mesh import make_mesh
    from bwa_mem_scale_tpu.pipeline.align import TpuAligner

    mesh = make_mesh(n_dev)
    al = TpuAligner(load_index(prefix), mesh=mesh)
    for leaf in jax.tree_util.tree_leaves((al.fmi, al.dbns)):
        sh = getattr(leaf, "sharding", None)
        if not (isinstance(sh, NamedSharding) and sh.is_fully_replicated
                and len(sh.device_set) == n_dev):
            raise AssertionError(f"index leaf not replicated on the "
                                 f"mesh: {sh}")
    del al
    say(f"phase mesh: index arrays replicated once on each of {n_dev} "
        f"cards")
    res = {}
    warm_se = [head_fastq(se_fq, os.path.join(WORK, "warm_se.fq"),
                          2 * BATCH)]
    warm_pe = [head_fastq(p, os.path.join(WORK, f"warm_pe{k}.fq"), BATCH)
               for k, p in enumerate(pe_fqs, 1)]
    for tag, fqs, warm in (("se", [se_fq], warm_se),
                           ("pe", list(pe_fqs), warm_pe)):
        sams, runs = {}, {}
        for d in (n_dev, 1):
            sams[d] = os.path.join(WORK, f"mesh_{tag}_{d}.sam")
            run_mem(prefix, warm, os.path.join(WORK, "warm.sam"),
                    "--devices", str(d))                    # set-up
            runs[d] = run_mem(prefix, fqs, sams[d], "--devices", str(d))
        if sam_body(sams[n_dev]) != sam_body(sams[1]):
            raise AssertionError(f"{tag} SAM differs between "
                                 f"--devices {n_dev} and 1")
        res[tag] = {d: runs[d]["reads"] / runs[d]["wall"] for d in runs}
        say(f"phase mesh: {tag} {runs[1]['reads']} reads, --devices "
            f"{n_dev} {res[tag][n_dev]:,.1f} reads/s, --devices 1 "
            f"{res[tag][1]:,.1f} reads/s (wall, warm); SAM bodies "
            f"byte-equal")
    report["mesh"] = res


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="run only the N-card vs 1-card mem comparison")
    ap.add_argument("--se-reads", type=int, default=SE_READS)
    ap.add_argument("--pe-pairs", type=int, default=PE_PAIRS)
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    plat, kind = devs[0].platform, devs[0].device_kind
    say(f"phase a: platform={plat} device_kind={kind} count={len(devs)}")
    if plat != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {plat}",
              file=sys.stderr)
        return 1
    cards = card_lines()
    for ln in cards:
        say(f"nvidia-smi: {ln}")
    n_dev = args.mesh or 1
    if n_dev > len(devs):
        print(f"chip_smoke: --mesh {n_dev} but {len(devs)} devices",
              file=sys.stderr)
        return 1

    sys.path.insert(0, REPO)
    from bwa_mem_scale_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    say(f"compile cache: {jax.config.jax_compilation_cache_dir}")

    t_all = time.perf_counter()
    report = {}
    prefix, se_fq, pe_fqs, jobs = start_host_jobs(
        args.se_reads, args.pe_pairs)
    if args.mesh:
        t_idx = jobs["index"].wait()
        jobs["se"].wait()
        jobs["pe"].wait()
        say(f"set-up: index {t_idx[0]:.1f} s, EMF table {t_idx[1]:.1f} s")
        phase_mesh(report, n_dev, prefix, se_fq, pe_fqs)
    else:
        phase_bsw(report)
        t_idx = jobs["index"].wait()
        t_se = jobs["se"].wait()
        t_pe = jobs["pe"].wait()
        say(f"set-up: index {t_idx[0]:.1f} s, EMF table {t_idx[1]:.1f} s,"
            f" reads SE {t_se[0]:.1f} s PE {t_pe[0]:.1f} s (CPU children)")
        phase_se(report, prefix, se_fq)
        phase_pe(report, prefix, pe_fqs)

    # phase e: report
    peak = max((d.memory_stats() or {}).get("peak_bytes_in_use", 0)
               for d in devs[:n_dev])
    card = cards[0] if cards else "unknown card"
    if "se" in report:
        se, pe = report["se"], report["pe"]
        say(f"report [{card}]: mem SE {se['reads_per_s']:,.1f} reads/s, "
            f"PE {pe['reads_per_s']:,.1f} reads/s (wall incl. index load "
            f"and tracing); set-up (compile) SE {se['setup_s']:.1f} s, PE "
            f"{pe['setup_s']:.1f} s; SE stream kernel BSW "
            f"{statistics.median(se['ab']['kernel']):,.1f} vs jnp BSW "
            f"{statistics.median(se['ab']['jnp']):,.1f} reads/s (median)")
        for w, b in report["bsw"].items():
            say(f"report [{card}]: BSW w={w} kernel "
                f"{b['kernel_s'] * 1e3:.3f} ms, jnp {b['jnp_s'] * 1e3:.3f}"
                f" ms per 32768-pair call")
    say(f"report [{card}]: peak_bytes_in_use {peak} "
        f"({peak / 2**30:.2f} GiB); total {time.perf_counter() - t_all:.0f}"
        f" s")
    print(json.dumps({"ok": True, "device": {
        "platform": plat, "kind": kind, "count": n_dev}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException:
        import traceback
        traceback.print_exc()
        code = 1
    finally:
        for p in _CHILDREN:
            if p.poll() is None:
                p.kill()
    sys.exit(code)
