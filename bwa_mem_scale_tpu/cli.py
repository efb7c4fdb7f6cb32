"""Command-line interface.

Subcommand set mirrors the reference binary (src/main.cpp:51-168):
  index          build the FM-index artifact from a FASTA
  mem            align FASTQ reads, emit SAM
  smem-table     build the FMA acceleration tables     (reference: FMI_search.cpp:229)
  perfect-index  build the EMF perfect-match table     (reference: perfect_index.cpp:1741)
  version

Runtime options of `mem` mirror mem_opt_t flags (src/fastmap.cpp:952+).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from . import __version__
from .config import (MemOptions, MEM_F_ALL, MEM_F_SOFTCLIP,
                     MEM_F_NO_RESCUE, MEM_F_NOPAIRING,
                     MEM_F_NO_MULTI, MEM_F_PRIMARY5,
                     MEM_F_KEEP_SUPP_MAPQ)


def _add_mem_opts(p: argparse.ArgumentParser):
    p.add_argument("-t", type=int, default=1, dest="n_threads",
                   help="host worker threads (IO/finalize)")
    p.add_argument("-k", type=int, default=19, dest="min_seed_len")
    p.add_argument("-w", type=int, default=100, dest="band_width")
    p.add_argument("-d", type=int, default=100, dest="zdrop")
    p.add_argument("-r", type=float, default=1.5, dest="split_factor")
    p.add_argument("-y", type=int, default=20, dest="max_mem_intv")
    p.add_argument("-c", type=int, default=500, dest="max_occ")
    p.add_argument("-A", type=int, default=1, dest="match")
    p.add_argument("-B", type=int, default=4, dest="mismatch")
    p.add_argument("-O", type=str, default="6,6", dest="gap_open")
    p.add_argument("-E", type=str, default="1,1", dest="gap_ext")
    p.add_argument("-L", type=str, default="5,5", dest="clip_pen")
    p.add_argument("-U", type=int, default=17, dest="pen_unpaired")
    p.add_argument("-T", type=int, default=30, dest="min_score")
    p.add_argument("-D", type=float, default=0.50, dest="drop_ratio")
    p.add_argument("-W", type=int, default=0, dest="min_chain_weight")
    p.add_argument("-G", type=int, default=10000, dest="max_chain_gap")
    p.add_argument("-m", type=int, default=50, dest="max_matesw")
    p.add_argument("-S", action="store_true", dest="skip_rescue",
                   help="skip mate rescue")
    p.add_argument("-P", action="store_true", dest="skip_pairing",
                   help="skip pairing (rescue still runs unless -S)")
    p.add_argument("-a", action="store_true", dest="output_all")
    p.add_argument("-Y", action="store_true", dest="softclip_supp")
    p.add_argument("-M", action="store_true", dest="mark_secondary",
                   help="mark shorter split hits as secondary")
    p.add_argument("-C", action="store_true", dest="copy_comment",
                   help="append FASTA/FASTQ comment to SAM")
    p.add_argument("-j", action="store_true", dest="ignore_alt",
                   help="treat ALT contigs as primary")
    p.add_argument("-5", action="store_true", dest="primary5",
                   help="smallest-coordinate split hit is primary")
    p.add_argument("-q", action="store_true", dest="keep_supp_mapq",
                   help="don't cap MAPQ of supplementary alignments")
    p.add_argument("-h", "--xa-hits", type=str, default="5,200",
                   dest="xa_hits",
                   help="max XA hits [primary,alt]")
    p.add_argument("-K", type=int, default=None, dest="chunk_bp",
                   help="process this many bp per batch (determinism)")
    p.add_argument("-p", action="store_true", dest="smart_pairing",
                   help="first input is interleaved paired-end")
    p.add_argument("-I", type=str, default=None, dest="insert_spec",
                   help="mean[,std[,max[,min]]] fixed insert size")
    p.add_argument("-v", type=int, default=3, dest="verbosity")
    p.add_argument("-R", type=str, default=None, dest="rg_line")
    p.add_argument("-x", type=str, default=None, dest="read_type",
                   help="preset: pacbio, pbref, ont2d, intractg "
                        "(src/fastmap.cpp:1129-1169)")
    p.add_argument("--batch-reads", type=int, default=512,
                   help="device batch size in reads")
    p.add_argument("--devices", type=int, default=1,
                   help="run the device pipeline read-sharded over "
                        "the first N local devices (index replicated "
                        "per chip; batch-reads must divide evenly)")
    p.add_argument("--seed-engine", choices=("sweep", "readlane"),
                   default=None,
                   help="SMEM seeding kernel: read-per-lane machine "
                        "(default; the bench engine) or "
                        "position-parallel sweep (identical output)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="sidecar file tracking emitted reads; rerun "
                        "with the same arguments resumes and appends")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="multi-host mode: total hosts sharing the "
                        "FASTQ stream (each aligns every Nth batch "
                        "and writes its own SAM part; global read "
                        "ids preserved so parts byte-match the "
                        "single-host run)")
    p.add_argument("--host-id", type=int, default=0,
                   help="this host's rank in [0, num-hosts)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port for jax.distributed.initialize "
                        "(optional; omit when each host runs its own "
                        "local devices without cross-host collectives)")


def _opts_from_args(args) -> MemOptions:
    o_del, o_ins = (int(x) for x in args.gap_open.split(","))
    e_del, e_ins = (int(x) for x in args.gap_ext.split(","))
    p5, p3 = (int(x) for x in args.clip_pen.split(","))
    xa = [int(x) for x in args.xa_hits.split(",")]

    # -x read-type presets (src/fastmap.cpp:1129-1169) and the -A
    # rescaling of update_a (src/fastmap.cpp:716-730). "Explicitly
    # set" is approximated as "differs from the argparse default"
    # (the reference tracks opt0 bits; the corner where a user
    # re-passes a default value explicitly behaves as unset here).
    def _unset(name, default):
        return getattr(args, name) == default

    mode = args.read_type
    if mode is not None:
        if mode == "intractg":
            if _unset("gap_open", "6,6"):
                o_del = o_ins = 16
            if _unset("mismatch", 4):
                args.mismatch = 9
            if _unset("clip_pen", "5,5"):
                p5 = p3 = 5
        elif mode in ("pacbio", "pbref", "ont2d"):
            if _unset("gap_open", "6,6"):
                o_del = o_ins = 1
            if _unset("gap_ext", "1,1"):
                e_del = e_ins = 1
            if _unset("mismatch", 4):
                args.mismatch = 1
            if _unset("split_factor", 1.5):
                args.split_factor = 10.0
            if mode == "ont2d":
                if _unset("min_chain_weight", 0):
                    args.min_chain_weight = 20
                if _unset("min_seed_len", 19):
                    args.min_seed_len = 14
            else:
                if _unset("min_chain_weight", 0):
                    args.min_chain_weight = 40
                if _unset("min_seed_len", 19):
                    args.min_seed_len = 17
            if _unset("clip_pen", "5,5"):
                p5 = p3 = 0
        else:
            raise SystemExit(f"unknown read type '{mode}'")
    elif args.match != 1:
        # update_a: -A rescales every default-valued penalty
        a = args.match
        if _unset("mismatch", 4):
            args.mismatch *= a
        if _unset("min_score", 30):
            args.min_score *= a
        if _unset("gap_open", "6,6"):
            o_del *= a
            o_ins *= a
        if _unset("gap_ext", "1,1"):
            e_del *= a
            e_ins *= a
        if _unset("zdrop", 100):
            args.zdrop *= a
        if _unset("clip_pen", "5,5"):
            p5 *= a
            p3 *= a
        if _unset("pen_unpaired", 17):
            args.pen_unpaired *= a
    opt = MemOptions(
        a=args.match, b=args.mismatch, o_del=o_del, o_ins=o_ins,
        e_del=e_del, e_ins=e_ins, pen_clip5=p5, pen_clip3=p3,
        w=args.band_width, zdrop=args.zdrop,
        min_seed_len=args.min_seed_len, split_factor=args.split_factor,
        max_mem_intv=args.max_mem_intv, max_occ=args.max_occ,
        T=args.min_score, pen_unpaired=args.pen_unpaired,
        drop_ratio=args.drop_ratio,
        min_chain_weight=args.min_chain_weight,
        max_chain_gap=args.max_chain_gap, max_matesw=args.max_matesw,
        max_XA_hits=xa[0],
        max_XA_hits_alt=xa[1] if len(xa) > 1 else 200,
        copy_comment=args.copy_comment)
    if args.output_all:
        opt.flag |= MEM_F_ALL
    if args.softclip_supp:
        opt.flag |= MEM_F_SOFTCLIP
    if args.skip_rescue:
        opt.flag |= MEM_F_NO_RESCUE
    if args.skip_pairing:
        opt.flag |= MEM_F_NOPAIRING
    if args.mark_secondary:
        opt.flag |= MEM_F_NO_MULTI
    if args.primary5:
        opt.flag |= MEM_F_PRIMARY5
    if args.keep_supp_mapq:
        opt.flag |= MEM_F_KEEP_SUPP_MAPQ
    opt.ignore_alt = args.ignore_alt
    return opt


def cmd_index(argv):
    p = argparse.ArgumentParser(prog="bwa-mem-scale-tpu index")
    p.add_argument("fasta")
    p.add_argument("-p", dest="prefix", default=None)
    p.add_argument("-s", dest="sa_compx", type=int, default=3,
                   help="SA sampling shift: keep every 2^s-th entry "
                        "(0 = full SA, fastest lookups; 3 = reference "
                        "default)")
    args = p.parse_args(argv)
    from .index.bntseq import parse_fasta
    from .index.build import build_index
    from .index.artifacts import save_index
    prefix = args.prefix or args.fasta
    t0 = time.time()
    print(f"* parsing {args.fasta}", file=sys.stderr)
    bns = parse_fasta(args.fasta)
    alt_path = args.fasta + ".alt"
    import os as _os
    if _os.path.exists(alt_path):
        # bwa-mem .alt convention: contig name is the first column
        alt_names = set()
        with open(alt_path) as f:
            for line in f:
                if line.strip() and not line.startswith("@"):
                    alt_names.add(line.split()[0])
        n_alt = 0
        for a in bns.anns:
            if a.name in alt_names:
                a.is_alt = True
                n_alt += 1
        print(f"* {n_alt} ALT contigs from {alt_path}", file=sys.stderr)
    print(f"* l_pac={bns.l_pac} n_seqs={bns.n_seqs}; building index",
          file=sys.stderr)
    idx = build_index(bns, sa_compx=args.sa_compx)
    path = save_index(idx, prefix)
    print(f"* wrote {path} in {time.time() - t0:.1f}s", file=sys.stderr)
    return 0


def cmd_mem(argv):
    # add_help off: -h is the reference's max-XA-hits option
    p = argparse.ArgumentParser(prog="bwa-mem-scale-tpu mem",
                                add_help=False)
    p.add_argument("--help", action="help")
    p.add_argument("prefix")
    p.add_argument("fastq", nargs="+")
    p.add_argument("-o", dest="output", default="-")
    _add_mem_opts(p)
    args = p.parse_args(argv)
    opt = _opts_from_args(args)

    from .index.artifacts import load_index
    from .io.fastq import read_fastq, ReadBatch
    from .io.sam import sam_header
    from .pipeline.align import TpuAligner
    from .pipeline.driver import run_alignment
    from .utils.profiling import PROFILER

    with PROFILER.phase("index_load"):
        from . import store as _store
        att = _store.attach(args.prefix)
        if att is not None:
            print(f"* attached in-memory index store at {att.root}",
                  file=sys.stderr)
            idx = _store.index_from_store(att.pieces["index"])
            fma = (_store.fma_from_store(att.pieces["fma"])
                   if att.has("fma") else None)
            emf = (_store.emf_from_store(att.pieces["emf"])
                   if att.has("emf") else None)
            ert = (_store.ert_from_store(att.pieces["ert"])
                   if att.has("ert") else None)
        else:
            idx = load_index(args.prefix)
            fma = find_fma(args.prefix)
            emf = find_emf(args.prefix)
            ert = find_ert(args.prefix, idx)
        cp2 = find_cp2(args.prefix)
        if args.ignore_alt:
            # -j: treat ALT contigs as primary, i.e. ignore the .alt
            # annotations recorded at index-build time
            # (src/fastmap.cpp:896, bwa_idx_load's ignore_alt path)
            for a in idx.bns.anns:
                a.is_alt = False
        if fma is not None:
            print(f"* FMA ladder table loaded (K={fma.K})",
                  file=sys.stderr)
        if emf is not None:
            print(f"* EMF perfect-match table loaded "
                  f"(seed_len={emf.seed_len})", file=sys.stderr)
        if cp2 is not None:
            print(f"* {cp2.K}-step ({'tri' if cp2.K == 3 else 'bi'}"
                  f"gram) checkpoint table loaded", file=sys.stderr)
        if ert is not None and idx.sa_compx == 0:
            print(f"* ERT index loaded (K={ert.K}, "
                  f"{ert.n_nodes} nodes)", file=sys.stderr)
        elif ert is not None:
            ert = None
        from .pipeline.align import PipelineConfig
        # Engine default is "auto": an auto-loaded ERT index wins,
        # otherwise the scatter-free one-hot machine — the engine
        # bench.py uses, so CLI users get the benchmarked path.
        engine = args.seed_engine or "onehot"
        # extension-pair capacity per device batch: 4 pairs per read
        # (8 for int64-position genomes), as bench.py sizes it; a
        # smaller fixed capacity sends most reads of a large batch to
        # the overflow-retry ladder
        per_dev = -(-args.batch_reads // max(args.devices, 1))
        max_pairs = (4 if idx.pos_fits_int32 else 8) * per_dev
        cfg = PipelineConfig(seed_engine=engine, max_pairs=max_pairs)
        if engine in ("readlane", "onehot"):
            if ert is not None:
                if args.seed_engine is None:
                    engine = "sweep"     # auto: let the ERT run
                    cfg = PipelineConfig(seed_engine=engine,
                                         max_pairs=max_pairs)
                else:
                    # explicit engine choice beats auto-loaded
                    # accelerators that would bypass it
                    print("* note: readlane seeding selected; "
                          "ignoring auto-loaded ERT index",
                          file=sys.stderr)
                    ert = None
        if engine in ("readlane", "onehot") and fma is not None:
            print(f"* note: {engine} seeding ignores the FMA "
                  "table", file=sys.stderr)
        mesh = None
        if args.devices > 1:
            import jax
            from .parallel.mesh import make_mesh
            n_avail = len(jax.devices())
            if args.devices > n_avail:
                raise SystemExit(f"--devices {args.devices} but only "
                                 f"{n_avail} available")
            if args.batch_reads % args.devices:
                raise SystemExit("--batch-reads must be divisible by "
                                 "--devices")
            mesh = make_mesh(args.devices)
            print(f"* device mesh: {args.devices}x read-sharded",
                  file=sys.stderr)
        aligner = TpuAligner(idx, opt, cfg, fma=fma, emf=emf, ert=ert,
                             mesh=mesh, cp2=cp2)
    if args.verbosity >= 4:
        # one-shot device stage table on the first batch (-v 4; the
        # display_stats analogue, src/profiling.cpp:87)
        aligner.stage_profile_pending = True

    host_shard = None
    if args.num_hosts > 1:
        if not (0 <= args.host_id < args.num_hosts):
            raise SystemExit("--host-id must be in [0, num-hosts)")
        if args.checkpoint:
            raise SystemExit("--checkpoint is per-host-stream; not "
                             "supported with --num-hosts")
        if args.coordinator:
            # cross-host device federation (per-host FASTQ sharding
            # itself needs no collectives; this wires the mesh story
            # for fleets whose devices span hosts, SURVEY section 5.8)
            import jax
            jax.distributed.initialize(
                coordinator_address=args.coordinator,
                num_processes=args.num_hosts,
                process_id=args.host_id)
            print(f"* jax.distributed: host {args.host_id}/"
                  f"{args.num_hosts} via {args.coordinator}",
                  file=sys.stderr)
        host_shard = (args.num_hosts, args.host_id)
        print(f"* multi-host shard: batches {args.host_id} mod "
              f"{args.num_hosts}", file=sys.stderr)

    skip_reads = 0
    if args.checkpoint and args.output != "-":
        import json as _json
        import os as _os
        if _os.path.exists(args.checkpoint):
            with open(args.checkpoint) as f:
                ck = _json.load(f)
            if ck.get("inputs") != args.fastq:
                raise SystemExit("checkpoint was written for different "
                                 f"inputs: {ck.get('inputs')}")
            skip_reads = int(ck["reads_emitted"])
            print(f"* resuming after {skip_reads} reads "
                  f"({args.checkpoint})", file=sys.stderr)
    resuming = skip_reads > 0
    out = (sys.stdout if args.output == "-"
           else open(args.output, "a" if resuming else "w"))
    rg_id = None
    if args.rg_line:
        for field in args.rg_line.replace("\\t", "\t").split("\t"):
            if field.startswith("ID:"):
                rg_id = field[3:]
    if not resuming:
        out.write(sam_header(idx.bns, args.rg_line,
                             pg_cl=" ".join(sys.argv)))
    paired = args.smart_pairing or len(args.fastq) == 2
    if args.insert_spec:
        from .pipeline.pe import PeStat
        parts = [float(x) for x in args.insert_spec.split(",")]
        mean = parts[0]
        std = parts[1] if len(parts) > 1 else mean * 0.1
        hi = parts[2] if len(parts) > 2 else int(mean + 4 * std + 0.499)
        lo = parts[3] if len(parts) > 3 else int(mean - 4 * std + 0.499)
        pes = [PeStat() for _ in range(4)]
        pes[1] = PeStat(low=max(int(lo), 1), high=int(hi), avg=mean,
                        std=std, failed=False)
        aligner.pes = pes
        print(f"* fixed FR insert size: mean {mean} std {std} "
              f"proper [{pes[1].low}, {pes[1].high}]", file=sys.stderr)
    n_reads = run_alignment(aligner, args.fastq, out,
                            batch_reads=args.batch_reads,
                            chunk_bp=args.chunk_bp, rg_id=rg_id,
                            n_workers=args.n_threads, paired=paired,
                            skip_reads=skip_reads,
                            checkpoint_path=args.checkpoint,
                            host_shard=host_shard,
                            verbosity=args.verbosity)
    if out is not sys.stdout:
        out.close()
    PROFILER.report()
    aligner.emf_report()
    print(f"* aligned {n_reads} reads", file=sys.stderr)
    return 0


def cmd_smem_table(argv):
    p = argparse.ArgumentParser(prog="bwa-mem-scale-tpu smem-table")
    p.add_argument("prefix")
    p.add_argument("-k", dest="kmer", type=int, default=None,
                   help="ladder k-mer length (default 11, the "
                        "reference's ALL_SMEM_MAX_BP)")
    args = p.parse_args(argv)
    from .index.artifacts import load_index
    from .ops.occ import DeviceFMIndex
    from .ops.fma import build_fma_table, save_fma, DEFAULT_FMA_K
    idx = load_index(args.prefix)
    fmi = DeviceFMIndex.from_host(idx)
    t0 = time.time()
    fma = build_fma_table(fmi, K=args.kmer or DEFAULT_FMA_K)
    path = save_fma(fma, args.prefix)
    print(f"* wrote {path} in {time.time() - t0:.1f}s", file=sys.stderr)
    return 0


def find_cp2(prefix: str):
    """Auto-load the k-step checkpoint table next to the index, if
    built (`kstep-table`; trigram preferred; see index/kstep.py)."""
    import os as _os
    from .index.kstep import load_cp2
    for k in (3, 2):
        path = f"{prefix}.cp{k}.npz"
        if _os.path.exists(path):
            try:
                return load_cp2(path)
            except Exception as e:
                print(f"* WARNING: ignoring unreadable k-step table "
                      f"{path}: {e}", file=sys.stderr)
    return None


def find_fma(prefix: str):
    """Auto-load the FMA ladder table artifact next to the index, if
    built (the reference auto-loads .all_smem.* when SMEM_ACCEL is on,
    src/FMI_search.cpp:394-411)."""
    import glob
    from .ops.fma import load_fma
    for path in sorted(glob.glob(f"{prefix}.fma*.npz"), reverse=True):
        try:
            return load_fma(path)
        except Exception as e:
            print(f"* WARNING: ignoring unreadable FMA table {path}: "
                  f"{e}", file=sys.stderr)
    return None


def cmd_kstep_table(argv):
    p = argparse.ArgumentParser(prog="bwa-mem-scale-tpu kstep-table")
    p.add_argument("prefix")
    p.add_argument("-k", type=int, default=2, choices=(2, 3),
                   help="gram size: 2 (bigram, 5 B/position) or 3 "
                        "(trigram, 21 B/position, FWD walks consume "
                        "three bases per gather)")
    args = p.parse_args(argv)
    from .index.artifacts import load_index
    from .index.kstep import build_cp2, save_cp2
    idx = load_index(args.prefix)
    t0 = time.time()
    cp2 = build_cp2(idx, K=args.k)
    path = save_cp2(cp2, args.prefix)
    print(f"* wrote {path} ({cp2.nbytes() / 1e6:.0f} MB) in "
          f"{time.time() - t0:.1f}s", file=sys.stderr)
    return 0


def cmd_ert_index(argv):
    p = argparse.ArgumentParser(prog="bwa-mem-scale-tpu ert-index")
    p.add_argument("prefix")
    p.add_argument("-k", dest="kmer", type=int, default=None)
    p.add_argument("--max-depth", type=int, default=None)
    args = p.parse_args(argv)
    from .index.artifacts import load_index
    from .index.ert import (build_ert_from_index, save_ert,
                            DEFAULT_ERT_K, DEFAULT_MAX_DEPTH)
    idx = load_index(args.prefix)
    t0 = time.time()
    ert = build_ert_from_index(idx, K=args.kmer or DEFAULT_ERT_K,
                               max_depth=args.max_depth
                               or DEFAULT_MAX_DEPTH)
    path = save_ert(ert, args.prefix)
    print(f"* wrote {path} ({ert.n_nodes} nodes) in "
          f"{time.time() - t0:.1f}s", file=sys.stderr)
    return 0


def find_ert(prefix: str, idx):
    """Auto-load the ERT trie next to the index (requires a full-SA
    index, the reference's ERT memory class)."""
    import glob
    from .index.ert import load_ert
    for path in sorted(glob.glob(f"{prefix}.ert*.npz"), reverse=True):
        try:
            ert = load_ert(path)
            if idx.sa_compx != 0:
                print(f"* WARNING: {path} needs a full-SA index "
                      f"(rebuild with index -s 0); ignoring",
                      file=sys.stderr)
                return None
            return ert
        except Exception as e:
            print(f"* WARNING: ignoring unreadable ERT index {path}: "
                  f"{e}", file=sys.stderr)
    return None


def find_emf(prefix: str):
    """Auto-load the EMF perfect-match table next to the index, if
    built (the reference auto-loads .perfect.<len>,
    src/fastmap.cpp:1227)."""
    import glob
    from .index.perfect import load_perfect_table
    for path in sorted(glob.glob(f"{prefix}.emf*.npz"), reverse=True):
        try:
            return load_perfect_table(path)
        except Exception as e:
            print(f"* WARNING: ignoring unreadable EMF table {path}: "
                  f"{e}", file=sys.stderr)
    return None


def cmd_perfect_index(argv):
    p = argparse.ArgumentParser(prog="bwa-mem-scale-tpu perfect-index")
    p.add_argument("prefix")
    p.add_argument("-l", dest="seed_len", type=int, default=151)
    p.add_argument("-g", dest="budget_gb", type=float, default=None,
                   help="table memory budget in GB (MEMSCALE partial "
                        "EMF: only the earliest-position seeds get "
                        "entries; misses take the normal path)")
    p.add_argument("--chunked", action="store_true",
                   help="force the streaming chunked builder (auto "
                        "for genomes over 256 Mbp or with -g)")
    args = p.parse_args(argv)
    from .index.artifacts import load_index
    from .index.perfect import (build_perfect_table,
                                build_perfect_table_chunked,
                                save_perfect_table)
    idx = load_index(args.prefix)
    chunked = (args.chunked or args.budget_gb is not None
               or idx.bns.l_pac > (256 << 20))
    if chunked:
        budget = (int(args.budget_gb * (1 << 30))
                  if args.budget_gb else None)
        table = build_perfect_table_chunked(
            idx, args.seed_len, budget_bytes=budget,
            log=lambda m: print(m, file=sys.stderr))
    else:
        table = build_perfect_table(idx, args.seed_len)
    path = save_perfect_table(table, args.prefix)
    print(f"* wrote {path}", file=sys.stderr)
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # --platform cpu|gpu (or BWATPU_PLATFORM): pin the JAX backend
    # before first device use; there is no fallback between them
    plat = os.environ.get("BWATPU_PLATFORM")
    if "--platform" in argv:
        i = argv.index("--platform")
        plat = argv[i + 1]
        del argv[i:i + 2]
    if plat:
        if plat not in ("cpu", "gpu"):
            print(f"--platform must be cpu or gpu, not {plat}",
                  file=sys.stderr)
            return 1
        import jax
        jax.config.update("jax_platforms",
                          "cuda" if plat == "gpu" else "cpu")
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: bwa-mem-scale-tpu "
              "{index,mem,smem-table,kstep-table,perfect-index,ert-index,"
              "load-shm,remove-shm,version} ...", file=sys.stderr)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "index":
        return cmd_index(rest)
    if cmd == "mem":
        return cmd_mem(rest)
    if cmd == "smem-table":
        return cmd_smem_table(rest)
    if cmd == "kstep-table":
        return cmd_kstep_table(rest)
    if cmd == "perfect-index":
        return cmd_perfect_index(rest)
    if cmd == "ert-index":
        return cmd_ert_index(rest)
    if cmd == "load-shm":
        p = argparse.ArgumentParser(prog="bwa-mem-scale-tpu load-shm")
        p.add_argument("prefix")
        p.add_argument("-g", dest="budget_gb", type=float, default=None,
                       help="memory budget in GB (MEMSCALE policy)")
        a = p.parse_args(rest)
        from . import store as _store
        root = _store.stage(a.prefix, a.budget_gb,
                            log=lambda m: print(m, file=sys.stderr))
        print(f"* index store ready at {root}", file=sys.stderr)
        return 0
    if cmd == "remove-shm":
        p = argparse.ArgumentParser(prog="bwa-mem-scale-tpu remove-shm")
        p.add_argument("prefix")
        a = p.parse_args(rest)
        from . import store as _store
        ok = _store.remove(a.prefix)
        print("* removed" if ok else "* no store found",
              file=sys.stderr)
        return 0
    if cmd == "version":
        print(__version__)
        return 0
    print(f"unknown command: {cmd}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
