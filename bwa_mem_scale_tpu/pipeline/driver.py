"""Streaming alignment driver: FASTQ -> batches -> device -> SAM.

The device equivalent of the reference's 3-stage ktp pipeline
(src/fastmap.cpp:307-509): a reader thread prefetches fixed-bp chunks
(the -K determinism anchor), the main loop dispatches device batches
(async under jit), and finalization/SAM text runs while the next batch
computes. Output order is input order regardless of batching.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
from typing import List, Optional

import numpy as np

from ..io.fastq import iter_fastx, Read, ReadBatch
from ..io.sam import aln_to_sam_line
from ..utils.profiling import PROFILER


def _iter_reads(paths: List[str], paired: bool):
    """Yield reads; for two input files, interleave mates 2i/2i+1
    (bseq_read's smart pairing, src/bwa.cpp:266-362)."""
    if paired and len(paths) == 2:
        it0, it1 = iter_fastx(paths[0]), iter_fastx(paths[1])
        while True:
            r0 = next(it0, None)
            r1 = next(it1, None)
            if r0 is None and r1 is None:
                return
            if r0 is None or r1 is None:
                raise ValueError("paired FASTQ files differ in length")
            yield r0
            yield r1
    else:
        for path in paths:
            yield from iter_fastx(path)


def _reader(paths: List[str], batch_reads: int, chunk_bp: Optional[int],
            q: "queue.Queue", paired: bool = False,
            skip_reads: int = 0):
    try:
        batch: List[Read] = []
        bp = 0
        step = 2 if paired else 1
        skipped = 0
        for r in _iter_reads(paths, paired):
            if skipped < skip_reads:
                skipped += 1
                continue
            batch.append(r)
            bp += len(r.seq)
            full = (len(batch) >= batch_reads
                    if chunk_bp is None else bp >= chunk_bp)
            if full and len(batch) % step == 0:
                q.put(ReadBatch(batch))
                batch, bp = [], 0
        if batch:
            if paired and len(batch) % 2:
                raise ValueError("odd number of reads in paired input")
            q.put(ReadBatch(batch))
        q.put(None)
    except BaseException as e:  # surface reader errors to the driver
        q.put(e)


def run_alignment(aligner, fastq_paths: List[str], out,
                  batch_reads: int = 512, chunk_bp: Optional[int] = None,
                  rg_id: Optional[str] = None, n_workers: int = 1,
                  paired: bool = False, skip_reads: int = 0,
                  checkpoint_path: Optional[str] = None,
                  host_shard: Optional[tuple] = None,
                  verbosity: int = 2) -> int:
    """Stream-align FASTQ to SAM. With checkpoint_path, a sidecar
    JSON records how many input reads have been fully emitted after
    each processed batch (written atomically); a rerun resumes by
    skipping that many reads and appending. Records are always
    emitted in input order, so the count IS the resume point — an
    addition over the reference, whose recovery story is re-run
    (SURVEY section 5.4).

    host_shard=(num_hosts, host_id) is the multi-host FASTQ-sharding
    mode (SURVEY section 5.8): every host parses the full stream but
    aligns only batches with index % num_hosts == host_id, writing
    its own SAM part. Global read ordinals are preserved (the
    hash_64 MAPQ tiebreaks see the same ids as a single-host run, so
    part files byte-match the corresponding single-host records) —
    the analogue of the reference's multi-process runs
    against one shm index store (src/bwa_shm.cpp), which likewise
    emit one output per process. Requires a fixed batch_reads
    (chunk_bp batching would make batch boundaries host-dependent)."""
    if host_shard is not None:
        n_hosts, host_id = host_shard
        if chunk_bp is not None:
            raise ValueError("host_shard requires fixed batch_reads, "
                             "not chunk_bp batching")
        if checkpoint_path is not None:
            raise ValueError("checkpoint/resume is per-host-stream; "
                             "not supported with host_shard")
        if not (0 <= host_id < n_hosts):
            raise ValueError(f"host_id {host_id} out of range")
    else:
        n_hosts, host_id = 1, 0
    import time as _time0
    t_start = _time0.time()
    q: "queue.Queue" = queue.Queue(maxsize=4)
    t = threading.Thread(target=_reader,
                         args=(fastq_paths, batch_reads, chunk_bp, q,
                               paired, skip_reads),
                         daemon=True)
    t.start()
    n_reads = 0
    # global input ordinals (the hash_64 MAPQ tiebreaks use them, so
    # a resumed run reproduces the original ids)
    id_offset = skip_reads
    n_emitted = skip_reads
    opt = aligner.opt
    bns = aligner.idx.bns

    def write_checkpoint():
        if checkpoint_path is None:
            return
        import json as _json
        tmp = checkpoint_path + ".tmp"
        with open(tmp, "w") as f:
            _json.dump({"reads_emitted": n_emitted,
                        "inputs": fastq_paths}, f)
        os.replace(tmp, checkpoint_path)

    def emit(batch, records_per_read, mates):
        nonlocal n_emitted
        with PROFILER.phase("sam_write"):
            for ri, (read, records) in enumerate(
                    zip(batch.reads, records_per_read)):
                if isinstance(records, bytes):  # native SAM text
                    out.write(records.decode("ascii"))
                else:
                    for which in range(len(records)):
                        out.write(aln_to_sam_line(
                            opt, bns, read, len(records), records,
                            which, mate=mates[ri], rg_id=rg_id))
                n_emitted += 1
        write_checkpoint()

    def pe_sam_ctx(batch):
        from . import native_finalize
        if (not native_finalize.available()
                or getattr(opt, "copy_comment", False)):
            return None
        return dict(
            names=[r.name.encode() for r in batch.reads],
            quals=[r.qual.encode() if r.qual else b""
                   for r in batch.reads],
            rg_id=rg_id)

    # SE path: EMF-compacted streaming with one device batch in
    # flight (pipeline/stream.py); records re-emitted in input order.
    # PE keeps the simple loop (its rescue stage needs host results
    # mid-batch).
    from .stream import SeStream
    stream = None
    reads_by_id = {}
    holes = []   # skipped [lo, hi) id ranges (other hosts' batches)

    def emit_ready():
        nonlocal n_emitted
        wrote = False
        while True:
            drained = True
            for rid, records in stream.ready():
                with PROFILER.phase("sam_write"):
                    if isinstance(records, bytes):   # native SAM text
                        out.write(records.decode("ascii"))
                    else:
                        read = reads_by_id.pop(rid)
                        for which in range(len(records)):
                            out.write(aln_to_sam_line(
                                opt, bns, read, len(records), records,
                                which, rg_id=rg_id))
                n_emitted += 1
                wrote = True
            # jump the emit cursor over another host's batch
            if holes and stream.next_emit >= holes[0][0]:
                stream.next_emit = max(stream.next_emit, holes.pop(0)[1])
                drained = False
            if drained:
                break
        if wrote:
            out.flush()
            write_checkpoint()

    pe_pending = None   # (batch, fetched, id_offset) awaiting pe_post
    batch_idx = -1
    while True:
        item = q.get()
        if item is None:
            break
        if isinstance(item, BaseException):
            raise item
        batch = item
        batch_idx += 1
        if batch_idx % n_hosts != host_id:   # another host's batch
            holes.append((id_offset, id_offset + len(batch)))
            n_reads += len(batch)
            id_offset += len(batch)
            continue
        codes, lens = batch.padded_codes()
        if paired:
            # Depth-1 execute queue: fetch the in-flight batch FIRST
            # (sync point), dispatch the next extend, then do the
            # host-side PE work under it (stream.py has the details).
            with PROFILER.phase("align_batch"):
                if pe_pending is not None:
                    b0, ph0, off0 = pe_pending
                    fetched0 = aligner.fetch_pairs(ph0)
                ph = aligner.dispatch_pairs(codes.astype(np.int32),
                                            lens)
                if pe_pending is not None:
                    records0, mates0 = aligner.pe_post(
                        fetched0, off0, sam_ctx=pe_sam_ctx(b0))
                    emit(b0, records0, mates0)
                pe_pending = (batch, ph, id_offset)
        else:
            if stream is None:
                # Native SAM text mode: records AND their SAM lines
                # are composed in C (compose_sam_se); the emit loop
                # just writes bytes. Falls back to Aln records +
                # the Python writer when the native library is
                # unavailable or -C needs FASTQ comments appended.
                from . import native_finalize
                sam_mode = (native_finalize.available()
                            and not getattr(opt, "copy_comment",
                                            False))
                stream = SeStream(aligner, batch_reads,
                                  int(codes.shape[1]), sam=sam_mode,
                                  rg_id=rg_id)
                stream.next_emit = id_offset   # global ordinals
            if not stream.sam:
                for ri, read in enumerate(batch.reads):
                    reads_by_id[id_offset + ri] = read
            # Long-read-regime reads (mem_flt_chained_seeds active,
            # src/bwamem.cpp:506) run on the device path too: the
            # seed-SW filter is traced into long-L jit buckets
            # (ops/seedsw.py).
            with PROFILER.phase("align_batch"):
                if stream.sam:
                    stream.feed(
                        codes.astype(np.int32), lens, id_offset,
                        names=[r.name.encode() for r in batch.reads],
                        quals=[r.qual.encode() if r.qual else b""
                               for r in batch.reads])
                else:
                    stream.feed(codes.astype(np.int32), lens,
                                id_offset)
            emit_ready()
        n_reads += len(batch)
        id_offset += len(batch)
        if verbosity >= 3:
            # per-chunk progress, the reference's mem_process_seqs
            # report (src/bwamem.cpp:1861-1870)
            import time as _time
            now = _time.time()
            dt = now - t_start
            print(f"[M::mem] processed {n_reads} reads "
                  f"({dt:.1f} s, {n_reads / max(dt, 1e-9):.0f} "
                  f"reads/s cumulative)", file=sys.stderr)
    if pe_pending is not None:
        b0, ph0, off0 = pe_pending
        with PROFILER.phase("align_batch"):
            records0, mates0 = aligner.pe_post(
                aligner.fetch_pairs(ph0), off0,
                sam_ctx=pe_sam_ctx(b0))
        emit(b0, records0, mates0)
    if stream is not None:
        with PROFILER.phase("align_batch"):
            stream.flush()
        emit_ready()
        assert not reads_by_id, "unemitted reads remain"
    t.join()
    if getattr(aligner, "emf_checked", 0):
        print(f"* EMF perfect-match hits: {aligner.emf_hits}/"
              f"{aligner.emf_checked} reads short-circuited",
              file=sys.stderr)
    return n_reads
