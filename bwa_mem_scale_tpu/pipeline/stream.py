"""Streaming SE aligner with EMF backlog compaction.

The reference's EMF win is that perfect-matched reads skip
seeding/chaining/extension entirely (src/bwamem.cpp:1085-1130). With
fixed-shape device batches, zeroing their lanes only shrinks the
extension stage; the full win needs re-batching: perfect reads are
resolved straight from the table and only the misses accumulate into
a backlog that is dispatched to the device pipeline in full batches.
Output order is restored by a reorder buffer keyed on the global read
id — the determinism anchor the reference gets from -K chunking.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils.profiling import PROFILER


def _mk_perfect_aln(pos, rid, is_rev, is_alt, l_seq, score):
    from ..ref.finalize import Aln
    return Aln(pos=pos, rid=rid, flag=0, is_rev=is_rev,
               is_alt=is_alt, mapq=60, NM=0, cigar=[(l_seq, 0)],
               MD=str(l_seq), score=score, sub=0)


class SeStream:
    """Feed raw read batches in, collect per-read records in input
    order. One device batch is kept in flight (dispatch-ahead)."""

    def __init__(self, aligner, batch_reads: int, max_len: int,
                 sam: bool = False, rg_id=None):
        self.al = aligner
        self.B = batch_reads
        self.L = max_len
        self.backlog_codes: List[np.ndarray] = []
        self.backlog_lens: List[int] = []
        self.backlog_ids: List[int] = []
        self.results: Dict[int, list] = {}
        self.next_emit = 0
        # sam mode: results hold finished SAM text (bytes) per read,
        # composed natively (compose_sam_se) — the production CLI
        # path; Aln mode remains for PE and the record-level API.
        self.sam = sam
        self.rg_id = rg_id
        self.backlog_names: List[bytes] = []
        self.backlog_quals: List[bytes] = []
        # overflow-retry backlog (sam mode): reads whose fixed-shape
        # device results were truncated accumulate here and run the
        # tier ladder as amortized full batches instead of per-batch
        # serialized retry programs
        self.rb_codes: List[np.ndarray] = []
        self.rb_lens: List[int] = []
        self.rb_ids: List[int] = []
        self.rb_names: List[bytes] = []
        self.rb_quals: List[bytes] = []
        self.retry_batch = max(256, batch_reads // 8)
        # 3-stage pipeline: extend in flight -> cigar DP in flight
        self.pending: deque = deque()    # (ids, extend handle)
        self.pending2: deque = deque()   # (ids, finalize stage)

    # -- input side ----------------------------------------------------
    def post_result(self, rid: int, records) -> None:
        """Install externally computed records for a read (used by the
        driver's oracle route for long-read-regime reads)."""
        self.results[rid] = records

    def feed(self, codes: np.ndarray, lens: np.ndarray,
             first_id: int, skip=None, names=None, quals=None) -> None:
        """codes [n, L'] int32 (L' <= max_len), lens [n]. Rows where
        `skip` is True are not processed — the caller resolves them
        via post_result. names/quals: per-row bytes (sam mode)."""
        from .perfect import perfect_sam_records
        from ..ops.emf import FW_MATCHED, RC_MATCHED
        n = codes.shape[0]
        ids = np.arange(first_id, first_id + n)
        if skip is not None and skip.any():
            keep = ~skip
            codes = codes[keep]
            lens = np.asarray(lens)[keep]
            ids = ids[keep]
            if names is not None:
                names = [nm for nm, k in zip(names, keep) if k]
            if quals is not None:
                quals = [q for q, k in zip(quals, keep) if k]
            n = codes.shape[0]
            if n == 0:
                return
            # drop padding introduced by the (skipped) longest reads
            w = int(lens.max())
            if w < codes.shape[1]:
                codes = codes[:, :w]
        if self.sam and names is None:
            names = [b"r%d" % i for i in ids]
        if codes.shape[1] > self.L:   # longer reads arrived: grow
            self.L = int(codes.shape[1])
            self.backlog_codes = [
                np.concatenate([c, np.full(self.L - len(c), 4,
                                           np.int32)])
                for c in self.backlog_codes]
        if codes.shape[1] < self.L:
            pad = np.full((n, self.L - codes.shape[1]), 4, np.int32)
            codes = np.concatenate([codes, pad], axis=1)
        pm = None
        if (self.al.emf is not None
                and codes.shape[1] >= self.al.emf.seed_len):
            # host-side probe: a device probe would have to be fetched
            # and the fetch drains the in-flight extend batch
            from ..index.perfect import emf_lookup_host
            with PROFILER.phase("emf_probe_host"):
                pm = emf_lookup_host(self.al.emf,
                                     self.al.idx.ref_string,
                                     codes, lens)
        is_pm = np.zeros(n, dtype=bool)
        if pm is not None:
            is_pm = ((pm["code"] == FW_MATCHED)
                     | (pm["code"] == RC_MATCHED))
            self.al.emf_checked += n
            self.al.emf_hits += int(is_pm.sum())
            self.al._emf_count(pm["code"])
            opt, bns = self.al.opt, self.al.idx.bns
            ref = self.al.idx.ref_string
            pt = self.al.emf
            with PROFILER.phase("emf_records"):
                hit = np.flatnonzero(is_pm)
                # Vectorized fast path — the common case: a
                # single-location entry for a read exactly seed_len
                # long. perfect_locations returns [(loc0, rev)] there
                # and dedup/selection are identities, so the record
                # fields are pure arithmetic (mem_perfect2sam's
                # primary-only branch, src/bwamem.cpp:2328-2377).
                slots = np.asarray(pm["slot"])[hit]
                lens_h = np.asarray(lens)[hit]
                fast = (pt.mlidx[slots] < 0) & (lens_h == pt.seed_len)
                fi = hit[fast]
                if fi.size:
                    loc = np.asarray(pm["loc"])[fi].astype(np.int64)
                    rev = np.asarray(pm["code"])[fi] == RC_MATCHED
                    rid = bns.pos2rid(loc)
                    pos = loc - bns.offsets[rid]
                    alt = np.asarray(bns.is_alt)[rid]
                    L = int(pt.seed_len)
                    score = L * opt.a
                    if self.sam:
                        from .native_finalize import (perfect_raw,
                                                      compose_sam_raw)
                        raw = perfect_raw(fi, rid, pos, rev, alt, L,
                                          score)
                        sams = compose_sam_raw(
                            raw, opt, bns, codes, lens, names,
                            quals, self.rg_id)
                        for j in range(fi.size):
                            self.results[int(ids[fi[j]])] = \
                                sams[int(fi[j])]
                    else:
                        mk = _mk_perfect_aln
                        for j in range(fi.size):
                            self.results[int(ids[fi[j]])] = [
                                mk(int(pos[j]), int(rid[j]),
                                   bool(rev[j]), bool(alt[j]), L,
                                   score)]
                for i in hit[~fast]:
                    read = codes[i, : lens[i]].astype(np.uint8)
                    recs = perfect_sam_records(
                        opt, bns, self.al.emf, ref, read,
                        int(pm["code"][i]), int(pm["slot"][i]),
                        loc0=int(pm["loc"][i]))
                    if self.sam:
                        from ..io.sam import compose_sam_python
                        recs = compose_sam_python(
                            opt, bns, read, recs,
                            dict(names=names, quals=quals,
                                 rg_id=self.rg_id), int(i))
                    self.results[int(ids[i])] = recs
        for i in np.flatnonzero(~is_pm):
            self.backlog_codes.append(codes[i])
            self.backlog_lens.append(int(lens[i]))
            self.backlog_ids.append(int(ids[i]))
            if self.sam:
                self.backlog_names.append(names[i])
                self.backlog_quals.append(
                    quals[i] if quals is not None else b"")
        while len(self.backlog_ids) >= self.B:
            self._dispatch(self.B)

    def _dispatch(self, take: int) -> None:
        codes = np.stack(self.backlog_codes[:take])
        lens = np.array(self.backlog_lens[:take], dtype=np.int32)
        ids = self.backlog_ids[:take]
        del self.backlog_codes[:take]
        del self.backlog_lens[:take]
        del self.backlog_ids[:take]
        sam_ctx = None
        if self.sam:
            pad = self.B - take
            sam_ctx = dict(
                names=self.backlog_names[:take] + [b""] * pad,
                quals=self.backlog_quals[:take] + [b""] * pad,
                rg_id=self.rg_id, defer_overflow=True)
            del self.backlog_names[:take]
            del self.backlog_quals[:take]
        if take < self.B:   # ragged tail: pad with dead lanes
            pad = self.B - take
            codes = np.concatenate(
                [codes, np.full((pad, self.L), 4, np.int32)])
            lens = np.concatenate([lens, np.zeros(pad, np.int32)])
        # Order: (1) FETCH extend(i-1) — the natural sync point;
        # (2) enqueue extend(i) onto the now-idle device immediately;
        # (3) do ALL host work — unpack, dedup, cigar, records — while
        # extend(i) runs. One batch is in flight at a time; whether a
        # deeper queue or an asynchronous fetch helps on the GPU is
        # not yet measured (ROADMAP 1.5).
        # Exception: a batch with overflow retries runs its full
        # finalize BEFORE the next dispatch — retries launch device
        # programs of their own, which must not queue behind a 0.25 s
        # extend.
        held = []
        while self.pending:
            ids1, h, sc1 = self.pending.popleft()
            with PROFILER.phase("fetch_wait"):
                h = self.al.fetch_extend(h)
            if (not self.sam
                    and (h[4]["slot"]["meta"][:, 1] > 0.5).any()):
                # Aln mode still runs inline retries, which launch
                # device programs — finalize BEFORE the next dispatch
                # so they don't queue behind a long extend. sam mode
                # defers retries to the backlog instead.
                with PROFILER.phase("finalize_a"):
                    self.pending2.append(
                        (ids1,
                         self.al.finalize_stage_a(h, read_ids=ids1,
                                                  sam_ctx=sc1),
                         h[0], h[1], sc1))
            else:
                held.append((ids1, h, sc1))
        with PROFILER.phase("dispatch_extend"):
            handle = self.al.dispatch_batch(codes, lens, skip_emf=True)
        for ids1, h, sc1 in held:
            with PROFILER.phase("finalize_a"):
                self.pending2.append(
                    (ids1, self.al.finalize_stage_a(h, read_ids=ids1,
                                                    sam_ctx=sc1),
                     h[0], h[1], sc1))
        # pad ids for dead lanes (their empty reg lists ignore the id)
        self.pending.append((ids + [-1] * (self.B - take), handle,
                             sam_ctx))
        while self.pending2:
            self._complete_oldest()

    def _complete_oldest(self) -> None:
        ids, stage, codes1, lens1, sc1 = self.pending2.popleft()
        with PROFILER.phase("finalize_b"):
            recs = self.al.finalize_stage_b(stage)
        for j, rid in enumerate(ids):
            if rid < 0:
                continue
            if recs[j] is None and self.sam:
                # deferred overflow read -> retry backlog
                self.rb_codes.append(codes1[j])
                self.rb_lens.append(int(lens1[j]))
                self.rb_ids.append(rid)
                self.rb_names.append(sc1["names"][j])
                self.rb_quals.append(sc1["quals"][j])
            else:
                self.results[rid] = recs[j]
        if len(self.rb_ids) >= self.retry_batch:
            self._drain_retries()

    def _drain_retries(self) -> None:
        """Run the overflow tier ladder on the accumulated backlog as
        one amortized batch and install the composed SAM bytes."""
        if not self.rb_ids:
            return
        from ..io.sam import compose_sam_python
        n = len(self.rb_ids)
        codes = np.stack(self.rb_codes)
        lens = np.asarray(self.rb_lens, np.int32)
        rids = np.asarray(self.rb_ids, np.int64)
        names = self.rb_names
        quals = self.rb_quals
        self.rb_codes, self.rb_lens, self.rb_ids = [], [], []
        self.rb_names, self.rb_quals = [], []
        al = self.al
        with PROFILER.phase("overflow_retry"):
            all_regs = al._apply_overflow_retry(
                [[] for _ in range(n)], np.ones(n, bool), codes, lens)
        by_idx = al._records_from_regs(
            codes, lens, np.ones(n, bool), all_regs, rids)
        ctx = dict(names=names, quals=quals, rg_id=self.rg_id)
        with PROFILER.phase("retry_records"):
            for i, recs in by_idx.items():
                self.results[int(rids[i])] = compose_sam_python(
                    al.opt, al.idx.bns, codes[i, : lens[i]], recs,
                    ctx, i)

    # -- output side ---------------------------------------------------
    def ready(self) -> Iterator[Tuple[int, list]]:
        while self.next_emit in self.results:
            yield self.next_emit, self.results.pop(self.next_emit)
            self.next_emit += 1

    def flush(self) -> None:
        if self.backlog_ids:
            self._dispatch(len(self.backlog_ids))
        while self.pending:
            ids1, h, sc1 = self.pending.popleft()
            h = self.al.fetch_extend(h)
            with PROFILER.phase("finalize_a"):
                self.pending2.append(
                    (ids1, self.al.finalize_stage_a(h, read_ids=ids1,
                                                    sam_ctx=sc1),
                     h[0], h[1], sc1))
        while self.pending2:
            self._complete_oldest()
        self._drain_retries()
