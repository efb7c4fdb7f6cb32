"""End-to-end single-end alignment pipeline (device compute path).

Per batch of reads:
  device: SMEM seeding -> SA lookup -> chaining -> chain filter ->
          left/right banded extension with band-doubling retries
          (one fused jit program, `seed_chain_extend`)
  host:   dedup/patch, primary marking, record selection (tiny per-read
          work on numpy-backed AlnRegs, reusing the oracle finalizers)
  device: batched banded global alignment for CIGARs (`ops/kswg`)
  host:   NM/MD strings + SAM text

This mirrors the reference's kernel split (mem_kernel1_core /
mem_kernel2_core / worker_sam, src/bwamem.cpp:1209-1850) with the
irregular finalization work on host, exactly where the reference also
leaves the string-ish work.

mem_flt_chained_seeds (per-seed SW validation) only activates for
reads longer than ~666 bp with default scoring — the reference skips
it whenever min_l > MEM_SEEDSW_COEF * l_query (src/bwamem.cpp:500-506).
Long-L jit buckets trace the device implementation (ops/seedsw.py);
short-read buckets never pay for it.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MemOptions, MEM_F_PRIMARY5
from ..index.artifacts import FMIndex
from ..ops.occ import DeviceFMIndex
from ..ops.smem import collect_smems_device
from ..ops.sal import expand_and_lookup
from ..ops.chain import (DeviceBns, chain_seeds_device, chain_filter_device,
                         frac_rep_device, chain_weights)
from ..ops.bsw import banded_swa_batch
from ..ops import kswg
from ..ref.extend import AlnReg, MAX_BAND_TRY
from ..ref.finalize import (sort_dedup_patch, mark_primary,
                            reorder_primary5,
                            reg2sam_records)
from ..io.sam import aln_to_sam_line


def _trunc_div(n, d):
    return jnp.where(n >= 0, n // d, -((-n) // d))


def _cal_max_gap(qlen, a, o_del, e_del, o_ins, e_ins, w):
    l_del = _trunc_div(qlen * a - o_del, e_del) + 1
    l_ins = _trunc_div(qlen * a - o_ins, e_ins) + 1
    l = jnp.maximum(jnp.maximum(l_del, l_ins), 1)
    return jnp.minimum(l, w << 1)


def select_bsw(platform: str):
    """The banded-SW extension kernel for a JAX platform: the Pallas
    kernel on the GPU (compiled for the card; a compile failure is an
    error, never a fallback), the jnp kernel on the CPU."""
    if platform == "gpu":
        from ..ops.bsw_pallas import banded_swa_batch_pallas
        return banded_swa_batch_pallas
    return banded_swa_batch


@dataclasses.dataclass
class PipelineConfig:
    """Fixed-shape capacities for the device pipeline."""
    max_smem_out: Optional[int] = None   # per pass; default read length
    max_coords: int = 512                # SA coordinates per read
    max_chains: int = 64
    max_seeds_per_chain: int = 32
    max_regs: int = 64                   # extension candidates per read
    max_pairs: int = 4096                # extension pairs per batch
    target_pad: int = 8
    # "sweep": position-parallel sweep (ops/smem.py); "readlane":
    # read-per-lane micro-op machine (ops/smem_rl.py) — fewer, smaller
    # gathers; bit-identical output; ignores the FMA table.
    seed_engine: str = "sweep"
    # readlane worker lanes (< batch): lanes pull reads from the
    # backlog as they finish (kt_for-style dynamic scheduling) —
    # None = one lane per read (no refill).
    seed_lanes: Optional[int] = None
    # one-hot machine per-lane emission-buffer / interval-stack
    # depths (None = full read length, provably sufficient). Measured
    # occupancy is a small fraction of L; a read exceeding either
    # budget is routed to the overflow-retry ladder (full shapes), so
    # output is unchanged. "auto" = 24 for int32-position genomes
    # (E. coli/chr21: <1% overflow) and full for int64 genomes
    # (hg38-class repeat density overflowed 62% of reads at depth 24
    # — the retry ladder must stay the exception). Tier 1 of the
    # retry ladder runs widened-but-bounded depths (48); only tier 2
    # runs with None (full depth) — tier-1 overflows cascade there.
    seed_emit_depth: object = "auto"
    seed_stack_depth: object = "auto"
    # reseed (pass-2) lane budget = factor * batch; overflow routes
    # to the retry ladder. Normal batches need ~1.3 lanes/read; the
    # retry tiers carry repeat monsters with tens of candidates each
    # (measured round 4: every tier-2 oracle fallthrough was a
    # reseed-lane overflow).
    reseed_factor: int = 2


def seed_chain_extend(fmi: DeviceFMIndex, dbns: DeviceBns, codes, lens,
                      L: int, *, opt: MemOptions, cfg: "PipelineConfig",
                      fma=None, ert=None, cut: str = None):
    """Device stage 1: seeding -> chaining -> extension for one batch.

    Free function so multi-chip wrappers (parallel/mesh.py) can shard it
    with shard_map; TpuAligner jits it with captured index state.

    `cut` (jit-static, profiling only — tools/bench_extend.py) returns
    early with a live reduction over the named prefix: "enum" (candidate
    enumeration incl. argsorts + rmax), "seqs" (+pair compaction and
    extension sequence gathers), "bsw1" (+left BSW round 1), "bswL"
    (+left retry), "bswLR1" (+right round 1).
    """
    B = codes.shape[0]
    bidx = jnp.arange(B)
    pos_dtype = fmi.pos_dtype

    if ert is not None:
        from ..ops.ert import collect_smems_ert
        bufs = collect_smems_ert(
            ert, fmi.ref, codes, lens,
            min_seed_len=opt.min_seed_len, split_len=opt.split_len,
            split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
            max_out=cfg.max_smem_out or L, pos_dtype=fmi.pos_dtype,
            seq_len=2 * fmi.l_pac)
    elif cfg.seed_engine == "readlane":
        from ..ops.smem_rl import collect_smems_rl
        bufs = collect_smems_rl(
            fmi, codes, lens,
            min_seed_len=opt.min_seed_len, split_len=opt.split_len,
            split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
            max_out=cfg.max_smem_out or L, lanes=cfg.seed_lanes)
    elif cfg.seed_engine == "onehot":
        from ..ops.smem_oh import collect_smems_oh
        small_pos = jnp.dtype(fmi.pos_dtype).itemsize <= 4
        ed, sd = cfg.seed_emit_depth, cfg.seed_stack_depth
        bufs = collect_smems_oh(
            fmi, codes, lens,
            min_seed_len=opt.min_seed_len, split_len=opt.split_len,
            split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
            max_out=cfg.max_smem_out or L,
            emit_depth=(24 if small_pos else None) if ed == "auto"
            else ed,
            stack_depth=(24 if small_pos else None) if sd == "auto"
            else sd,
            reseed_factor=cfg.reseed_factor)
    else:
        bufs = collect_smems_device(
            fmi, codes, lens,
            min_seed_len=opt.min_seed_len, split_len=opt.split_len,
            split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
            max_out=cfg.max_smem_out or L, fma=fma)
    if cut == "seed":
        return {"packed": bufs.cnt + bufs.k[:, 0].astype(jnp.int32)}
    rbeg, seed_idx, coord_valid, total, coord_of = expand_and_lookup(
        fmi, bufs, opt.max_occ, cfg.max_coords)
    if cut == "sal":
        return {"packed": total + rbeg[:, 0].astype(jnp.int32)}
    # SMEM buffer at capacity: treat as (possible) overflow so the
    # read is retried at a larger shape rather than silently truncated.
    smem_of = bufs.cnt >= bufs.m.shape[1]
    ch = chain_seeds_device(
        dbns, bufs, rbeg, seed_idx, coord_valid,
        w=opt.w, max_chain_gap=opt.max_chain_gap,
        max_chains=cfg.max_chains,
        max_seeds_per_chain=cfg.max_seeds_per_chain)
    if cut == "chain":
        return {"packed": ch.n_seeds.sum(axis=1)
                + ch.seed_rbeg[:, 0, 0].astype(jnp.int32)}
    order, kept, w_slot = chain_filter_device(
        ch, dbns, min_chain_weight=opt.min_chain_weight,
        mask_level=opt.mask_level, max_chain_gap=opt.max_chain_gap,
        drop_ratio=opt.drop_ratio, min_seed_len=opt.min_seed_len,
        max_chain_extend=opt.max_chain_extend)
    frac_rep = frac_rep_device(bufs, lens, opt.max_occ)

    C = cfg.max_chains
    S = cfg.max_seeds_per_chain
    R = cfg.max_regs
    sidx = jnp.arange(S, dtype=jnp.int32)[None, None, :]

    # ---- long-read regime: SW-validate chain seeds on device ----
    # mem_flt_chained_seeds (src/bwamem.cpp:494-526). Inactive (and
    # untraced) for short-read buckets: the stage only exists when a
    # read of length L could trigger it.
    from ..config import needs_seed_sw_filter
    if needs_seed_sw_filter(opt, L):
        from ..ops.seedsw import seed_sw_filter
        seed_live, seed_score_eff, sw_of = seed_sw_filter(
            fmi, dbns, codes, lens, ch, order, kept, opt,
            max_sw=cfg.max_pairs)
    else:
        seed_live = sidx < ch.n_seeds[:, :, None]      # [B, C, S] slot
        seed_score_eff = ch.seed_score
        sw_of = jnp.zeros((B,), dtype=bool)

    # ---- enumerate (chain, seed) candidates in processing order ----
    # All selection here is rank arithmetic + one-hot masked sums:
    # instead of an argsort over [B, C*S] plus per-lane indexed
    # gathers/scatters; candidate keys are dense ranks, so sorting
    # them is just counting.
    kept_chain = kept > 0                              # [B, C] sorted pos
    chain_rank = jnp.cumsum(kept_chain.astype(jnp.int32), axis=1) - 1
    slot_by_pos = order                                # [B, C]
    iota_c = jnp.arange(C, dtype=jnp.int32)
    perm_oh = slot_by_pos[:, :, None] == iota_c[None, None, :]
    # [B, Cpos, Cslot] one-hot of the weight-sort permutation
    live_by_pos = jnp.any(perm_oh[:, :, :, None] & seed_live[:, None],
                          axis=2)                      # [B, C, S]
    score_by_pos = jnp.sum(
        jnp.where(perm_oh[:, :, :, None], seed_score_eff[:, None], 0),
        axis=2)
    svalid = live_by_pos & kept_chain[:, :, None]
    # seeds processed best-score-first, ties by larger index; keys are
    # unique, so descending rank = count of strictly larger keys.
    seed_key = ((score_by_pos.astype(jnp.int32) << 16)
                | sidx.astype(jnp.int32))
    seed_key = jnp.where(svalid, seed_key, jnp.int32(-1))
    seed_rank = jnp.sum(
        (seed_key[:, :, None, :] > seed_key[:, :, :, None]),
        axis=3, dtype=jnp.int32)                       # [B, C, S]

    # dense candidate rank: seeds of earlier kept chains first, then
    # score rank within the chain (identical order to the argsort of
    # chain_rank * S + seed_rank it replaces).
    nlive = jnp.sum(svalid, axis=2, dtype=jnp.int32)   # [B, C]
    base = jnp.cumsum(nlive, axis=1) - nlive           # [B, C]
    dense = jnp.where(svalid, base[:, :, None] + seed_rank,
                      jnp.int32(1 << 30))
    n_cand = jnp.sum(nlive, axis=1)
    reg_overflow = n_cand > R

    # sel encodes (data slot, seed idx) directly: slot*S + sidx
    slotflat = (slot_by_pos[:, :, None] * S
                + sidx.astype(jnp.int32)).reshape(B, C * S)
    dense_f = dense.reshape(B, C * S)
    iota_r = jnp.arange(R, dtype=jnp.int32)
    sel_oh = dense_f[:, None, :] == iota_r[None, :, None]  # [B,R,C*S]
    sel_ss = jnp.sum(jnp.where(sel_oh, slotflat[:, None, :], 0),
                     axis=2, dtype=jnp.int32)          # [B, R]
    sel_valid = iota_r[None, :] < n_cand[:, None]

    if cut == "enum":
        return dict(dbg=sel_ss.sum() + sel_valid.sum())

    sel_slot = sel_ss // S                             # chain data slot
    sel_sidx = sel_ss % S                              # raw seed index
    g_oh = sel_ss[:, :, None] == jnp.arange(
        C * S, dtype=jnp.int32)[None, None, :]         # [B, R, C*S]

    def g_take(arr):                                   # [B, C, S] field
        flat = arr.reshape(B, C * S)
        return jnp.sum(jnp.where(g_oh, flat[:, None, :], 0),
                       axis=2, dtype=arr.dtype)

    g_qbeg = g_take(ch.seed_qbeg)
    g_rbeg = g_take(ch.seed_rbeg)
    g_len = g_take(ch.seed_len)
    sslot_oh = sel_slot[:, :, None] == iota_c[None, None, :]
    g_rid = jnp.sum(jnp.where(sslot_oh, ch.rid[:, None, :], 0),
                    axis=2, dtype=ch.rid.dtype)

    # ---- per-chain reference span rmax (by slot) ----
    a_, w_ = opt.a, opt.w
    cs_qbeg = ch.seed_qbeg.astype(jnp.int64)
    cs_len = ch.seed_len.astype(jnp.int64)
    cs_rbeg = ch.seed_rbeg.astype(jnp.int64)
    cs_valid = seed_live
    l_query = lens.astype(jnp.int64)[:, None, None]
    gap_l = _cal_max_gap(cs_qbeg, a_, opt.o_del, opt.e_del,
                         opt.o_ins, opt.e_ins, w_)
    flank_r = l_query - cs_qbeg - cs_len
    gap_r = _cal_max_gap(flank_r, a_, opt.o_del, opt.e_del,
                         opt.o_ins, opt.e_ins, w_)
    b_cand = cs_rbeg - (cs_qbeg + gap_l)
    e_cand = cs_rbeg + cs_len + flank_r + gap_r
    l_pac2 = jnp.int64(2 * dbns.l_pac)
    rmax0 = jnp.min(jnp.where(cs_valid, b_cand, l_pac2), axis=2)
    rmax1 = jnp.max(jnp.where(cs_valid, e_cand, 0), axis=2)
    rmax0 = jnp.maximum(rmax0, 0)
    rmax1 = jnp.minimum(rmax1, l_pac2)
    # first LIVE seed (post seed-SW filter; argmax finds the first
    # True, and slot 0 — the pre-filter behavior — when none live)
    first_i = jnp.argmax(seed_live, axis=2)
    first_rbeg = jnp.sum(
        jnp.where(jnp.arange(S, dtype=jnp.int32)[None, None, :]
                  == first_i[:, :, None], cs_rbeg, 0),
        axis=2, dtype=cs_rbeg.dtype)
    bridging = (rmax0 < dbns.l_pac) & (dbns.l_pac < rmax1)
    rmax1 = jnp.where(bridging & (first_rbeg < dbns.l_pac),
                      dbns.l_pac, rmax1)
    rmax0 = jnp.where(bridging & (first_rbeg >= dbns.l_pac),
                      dbns.l_pac, rmax0)
    # clamp to the contig of the first seed (bns_fetch_seq_v2)
    mid = first_rbeg
    mid_f, mid_rev = dbns.depos(mid)
    mid_rid = dbns.pos2rid(mid_f)
    mrid = jnp.clip(mid_rid, 0, None).astype(jnp.int32)
    n_off = jnp.concatenate(
        [dbns.offsets, jnp.asarray([dbns.l_pac], jnp.int64)])
    n_seqs = dbns.offsets.shape[0]
    if n_seqs <= 128:
        # one-hot over the small contig table instead of [B, C]-lane
        # gathers
        ri = jnp.arange(n_seqs + 1, dtype=jnp.int32)
        oh = mrid[:, :, None] == ri[None, None, :-1]
        far_beg = jnp.sum(jnp.where(oh, dbns.offsets[None, None, :], 0),
                          axis=2, dtype=jnp.int64)
        oh1 = (mrid + 1)[:, :, None] == ri[None, None, :]
        far_end = jnp.sum(jnp.where(oh1, n_off[None, None, :], 0),
                          axis=2, dtype=jnp.int64)
    else:
        far_beg = dbns.offsets[mrid]
        far_end = n_off[mrid + 1]
    fb = jnp.where(mid_rev, l_pac2 - far_end, far_beg)
    fe = jnp.where(mid_rev, l_pac2 - far_beg, far_end)
    rmax0 = jnp.maximum(rmax0, fb)
    rmax1 = jnp.minimum(rmax1, fe)

    rm0 = jnp.sum(jnp.where(sslot_oh, rmax0[:, None, :], 0),
                  axis=2, dtype=rmax0.dtype)           # [B, R]
    rm1 = jnp.sum(jnp.where(sslot_oh, rmax1[:, None, :], 0),
                  axis=2, dtype=rmax1.dtype)

    # ---- compact candidates to pair space ----
    # Only real candidates get sequence buffers and DP lanes; results
    # come back in (read, processing-rank) order for the host.
    PX = cfg.max_pairs
    from ..ops.smem import compact_indices
    flatv = sel_valid.reshape(B * R)
    pidx, p_valid = compact_indices(flatv, PX)
    pair_overflow = flatv.sum() > PX
    # per-read: did compaction drop any of THIS read's candidates?
    # (compact_indices keeps the first PX in read-major order, so only
    # tail reads lose pairs)
    pair_rank = jnp.cumsum(flatv.astype(jnp.int32)) - 1
    pair_dropped = flatv & (pair_rank >= PX)
    read_pair_of = jnp.any(pair_dropped.reshape(B, R), axis=1)
    p_read = pidx // R

    def topair(x):
        return jnp.take(x.reshape(B * R), pidx)

    p_qbeg = topair(g_qbeg)
    p_rbeg = topair(g_rbeg).astype(jnp.int64)
    p_len = topair(g_len)
    p_rid = topair(g_rid)
    p_slot = topair(sel_slot)
    p_rm0 = topair(rm0)
    p_rm1 = topair(rm1)
    p_lens = jnp.where(p_valid, lens[p_read], 0).astype(jnp.int32)

    # ---- build extension pair sequences [PX, ...] ----
    # Windowed staging (ops/window.py): block row-gathers + static
    # rolls instead of per-element gathers — the SoA SeqPair fill of
    # mem_chain2aln_across_reads_V2 (src/bwamem.cpp:2976-3188).
    TL = L + 2 * w_ + cfg.target_pad
    from ..ops.window import take_windows, ref_windows
    p_codes = codes[p_read]                            # [PX, L]

    # left: query reversed prefix, target reversed ref[rm0:rbeg]
    ql_len = jnp.where(p_valid, p_qbeg, 0)
    q_l = take_windows(p_codes, p_qbeg - 1, L, reverse=True)
    tl_len = jnp.where(p_valid, p_rbeg - p_rm0, 0).astype(jnp.int32)
    t_l = ref_windows(fmi.ref, p_rbeg - 1, TL, dbns.l_pac,
                      reverse=True)

    # right: query suffix from qe, target ref[rbeg+len : rm1]
    p_qe = p_qbeg + p_len
    qr_len = jnp.where(p_valid, p_lens - p_qe, 0)
    q_r = take_windows(p_codes, p_qe, L)
    re0 = p_rbeg + p_len.astype(jnp.int64)
    tr_len = jnp.where(p_valid, p_rm1 - re0, 0).astype(jnp.int32)
    t_r = ref_windows(fmi.ref, re0, TL, dbns.l_pac)

    do_left = p_valid & (p_qbeg > 0)
    do_right = p_valid & (p_qe < p_lens)
    h0_l = (p_len * a_).astype(jnp.int32)

    if cut == "seqs":
        return dict(dbg=(q_l.sum() + t_l.sum() + q_r.sum() + t_r.sum()
                         + tl_len.sum() + tr_len.sum() + h0_l.sum()))

    _bsw = select_bsw(jax.default_backend())

    def run_bsw(q, qlen, t, tlen, h0, wv):
        return _bsw(
            q.astype(jnp.int32), qlen, t, tlen, h0, wv,
            opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
            opt.zdrop, opt.mat)

    def pick(r1, r2, which2):
        return jax.tree_util.tree_map(
            lambda x1, x2: jnp.where(which2, x2, x1), r1, r2)

    # ---- left extension with band-doubling retry ----
    resL1 = run_bsw(q_l, jnp.where(do_left, ql_len, 0),
                    t_l, jnp.where(do_left, tl_len, 0), h0_l, w_)
    if cut == "bsw1":
        return dict(dbg=resL1.score.sum() + resL1.qle.sum())
    acc1 = resL1.max_off < ((w_ >> 1) + (w_ >> 2))
    need2 = do_left & ~acc1
    resL2 = run_bsw(q_l, jnp.where(need2, ql_len, 0), t_l,
                    jnp.where(need2, tl_len, 0), h0_l, w_ << 1)
    resL = pick(resL1, resL2, need2)
    wL = jnp.where(need2, w_ << 1, w_)

    score_l = jnp.where(do_left, resL.score, p_len * a_)
    gs_ok_l = (resL.gscore <= 0) | (resL.gscore
                                    <= score_l - opt.pen_clip5)
    qb = jnp.where(do_left,
                   jnp.where(gs_ok_l, p_qbeg - resL.qle, 0), 0)
    rb = jnp.where(do_left,
                   jnp.where(gs_ok_l, p_rbeg - resL.tle,
                             p_rbeg - resL.gtle), p_rbeg)
    truesc = jnp.where(do_left,
                       jnp.where(gs_ok_l, score_l, resL.gscore),
                       p_len * a_)
    a_w = jnp.where(do_left, jnp.maximum(w_, wL), w_)

    if cut == "bswL":
        return dict(dbg=score_l.sum() + qb.sum() + truesc.sum())

    # ---- right extension (h0 = left score) ----
    resR1 = run_bsw(q_r, jnp.where(do_right, qr_len, 0), t_r,
                    jnp.where(do_right, tr_len, 0), score_l, w_)
    if cut == "bswLR1":
        return dict(dbg=resR1.score.sum() + resR1.qle.sum())
    accR1 = ((resR1.score == score_l)
             | (resR1.max_off < ((w_ >> 1) + (w_ >> 2))))
    needR2 = do_right & ~accR1
    resR2 = run_bsw(q_r, jnp.where(needR2, qr_len, 0), t_r,
                    jnp.where(needR2, tr_len, 0), score_l, w_ << 1)
    resR = pick(resR1, resR2, needR2)
    wR = jnp.where(needR2, w_ << 1, w_)

    score_f = jnp.where(do_right, resR.score, score_l)
    gs_ok_r = (resR.gscore <= 0) | (resR.gscore
                                    <= score_f - opt.pen_clip3)
    qe_f = jnp.where(do_right,
                     jnp.where(gs_ok_r, p_qe + resR.qle, p_lens),
                     p_lens)
    re_f = jnp.where(do_right,
                     re0 + jnp.where(gs_ok_r, resR.tle,
                                     resR.gtle).astype(jnp.int64),
                     re0)
    truesc = truesc + jnp.where(
        do_right,
        jnp.where(gs_ok_r, score_f, resR.gscore) - score_l, 0)
    a_w = jnp.where(do_right, jnp.maximum(a_w, wR), a_w)

    # ---- seed coverage over the final region (pair space) ----
    ch_q = ch.seed_qbeg[p_read, p_slot]                # [PX, S]
    ch_r = ch.seed_rbeg[p_read, p_slot].astype(jnp.int64)
    ch_l = ch.seed_len[p_read, p_slot]
    ch_v = seed_live[p_read, p_slot]
    inside = (ch_v
              & (ch_q >= qb[:, None])
              & (ch_q + ch_l <= qe_f[:, None])
              & (ch_r >= rb[:, None])
              & (ch_r + ch_l <= re_f[:, None]))
    seedcov = jnp.sum(jnp.where(inside, ch_l, 0), axis=1)

    # One int32 matrix holding every per-pair field the host needs,
    # so the host makes ONE device-to-host fetch instead of 12. int64
    # ref positions are split into 31-bit halves (always nonnegative).
    i32 = lambda x: x.astype(jnp.int32)
    packed = jnp.stack(
        [i32(p_valid), p_read.astype(jnp.int32), i32(qb), i32(qe_f),
         i32(score_f), i32(truesc), i32(a_w), i32(seedcov),
         i32(p_rid), i32(p_len),
         i32(rb & 0x7FFFFFFF), i32(rb >> 31),
         i32(re_f & 0x7FFFFFFF), i32(re_f >> 31)], axis=1)

    # Any capacity that silently truncated this read's work: the
    # reference never drops alignments (heap-backed mem_alnreg_v,
    # src/bwamem.cpp:789-1050), so flagged reads are re-run by the
    # host at a larger shape (TpuAligner._retry_overflow_regs).
    read_overflow = (smem_of | coord_of | ch.overflow
                     | reg_overflow | read_pair_of | sw_of)
    # one [B, 2] fetch carries both per-read host fields
    meta = jnp.stack(
        [frac_rep.astype(jnp.float32),
         read_overflow.astype(jnp.float32)], axis=1)

    return dict(
        valid=p_valid, read=p_read, qb=qb, qe=qe_f, rb=rb, re=re_f,
        score=score_f, truesc=truesc, w=a_w, seedcov=seedcov,
        rid=p_rid, seedlen0=p_len, frac_rep=frac_rep,
        packed=packed, meta=meta, read_overflow=read_overflow,
        smem_cnt=bufs.cnt, coord_total=total,
        chain_overflow=ch.overflow, reg_overflow=reg_overflow,
        pair_overflow=pair_overflow,
    )



class TpuAligner:
    """Holds device index state and compiled pipeline stages."""

    def __init__(self, idx: FMIndex, opt: Optional[MemOptions] = None,
                 cfg: Optional[PipelineConfig] = None, fma=None,
                 emf=None, ert=None, mesh=None, cp2=None):
        self.idx = idx
        self.mesh = mesh            # jax.sharding.Mesh or None
        self.opt = opt or MemOptions()
        self.cfg = cfg or PipelineConfig()
        if not idx.pos_fits_int32:
            # hg38-class repeat density overflows ~20% of a batch
            # (measured round 4): retries are a volume path there, and
            # their cost is SAL-bound (~ batch x coords), so serve
            # them in few, wide dispatches
            self.RETRY_BATCH = 512
            self.RETRY2_BATCH = 16
        self.fmi = DeviceFMIndex.from_host_cached(idx, cp2=cp2)
        self.dbns = DeviceBns.from_host(idx.bns)
        self.dfma = (fma.to_device(self.fmi.pos_dtype)
                     if fma is not None else None)
        self.dert = None
        if ert is not None:
            from ..ops.ert import DeviceErt
            if idx.sa_compx != 0:
                raise ValueError("ERT mode needs a full-SA index "
                                 "(build with sa_compx=0)")
            self.dert = DeviceErt.from_host(ert, idx.sa_samples,
                                            idx.count)
        self.emf = emf
        self.demf = None
        self.emf_hits = 0   # pprof-style outcome counter (bwamem.cpp:54)
        self.emf_checked = 0
        # full outcome histogram keyed by FIND_PERFECT_* code — the
        # pprof/pprof2 analogue (src/bwamem.cpp:54-56, report
        # display_stats src/profiling.cpp:87)
        import collections
        self.emf_hist = collections.Counter()
        self.pes = None     # fixed insert-size override (-I)
        if emf is not None:
            # HBM residency gate: a genome-scale EMF table (hg38 at
            # 2^30 slots is ~22 GB) cannot live in one chip's HBM
            # next to the FM index; the streaming driver probes it on
            # HOST anyway (emf_lookup_host), so past the threshold we
            # skip the device copy and dispatch_batch's device probe.
            emf_bytes = (emf.loc.nbytes + emf.fp.nbytes
                         + emf.cnt.nbytes + emf.fwless.nbytes)
            if emf_bytes <= int(os.environ.get(
                    "EMF_DEVICE_BYTES", 4 << 30)):
                from ..ops.emf import DeviceEmf, emf_lookup
                self.demf = DeviceEmf.from_host(emf)
                if mesh is not None:
                    from ..parallel.mesh import sharded_emf_fn
                    self._jit_emf = sharded_emf_fn(mesh)
                else:
                    self._jit_emf = jax.jit(emf_lookup)
            else:
                print(f"* EMF table ({emf_bytes / 1e9:.1f} GB) stays "
                      f"host-resident (HBM budget); the streaming "
                      f"driver probes it on host", file=sys.stderr)
        if mesh is not None:
            # one replica of the index state per device of the mesh,
            # placed here once instead of being copied from the first
            # device by every sharded call
            from jax.sharding import NamedSharding, PartitionSpec
            (self.fmi, self.dbns, self.dfma, self.dert,
             self.demf) = jax.device_put(
                (self.fmi, self.dbns, self.dfma, self.dert, self.demf),
                NamedSharding(mesh, PartitionSpec()))
        # fma is a jit argument, not a closure capture: captured arrays
        # become jaxpr constants and get shipped with every compile
        # request (oversized for GB-scale ladder tables).
        if mesh is not None:
            # Multi-device: every device stage of the per-batch
            # pipeline (EMF probe above, seed-chain-extend here) runs
            # read-sharded over the mesh with the index replicated per
            # chip (SURVEY.md section 5.8); the host stages are
            # shard-oblivious because pair rows carry global read ids.
            self._extend_sharded = {}

            def _mesh_extend(fmi, dbns, codes, lens, *, L, fma=None,
                             ert=None):
                if codes.shape[0] % mesh.size:
                    raise ValueError(
                        f"batch {codes.shape[0]} not divisible by "
                        f"mesh size {mesh.size}")
                key = (L, fma is not None, ert is not None)
                fn = self._extend_sharded.get(key)
                if fn is None:
                    from ..parallel.mesh import sharded_align_fn
                    fn = sharded_align_fn(
                        mesh, self.opt, self.cfg, L,
                        with_fma=fma is not None,
                        with_ert=ert is not None)
                    self._extend_sharded[key] = fn
                extra = [x for x in (fma, ert) if x is not None]
                return fn(fmi, dbns, codes, lens, *extra)

            self._jit_extend = _mesh_extend
        else:
            self._jit_extend = jax.jit(
                partial(seed_chain_extend, opt=self.opt, cfg=self.cfg),
                static_argnames=("L",))
        self._jit_kswg = jax.jit(
            kswg.ksw_global_batch, static_argnames=())

    EMF_CODE_NAMES = ("no_table", "with_n", "not_matched",
                      "fw_matched", "rc_matched")

    def _emf_count(self, code_arr):
        """Accumulate the per-outcome histogram (pprof analogue)."""
        c = np.bincount(np.asarray(code_arr, dtype=np.int64).ravel(),
                        minlength=5)
        for name, n in zip(self.EMF_CODE_NAMES, c[:5]):
            if n:
                self.emf_hist[name] += int(n)

    def emf_report(self, file=None):
        """EMF outcome histogram + overflow-retry counters, printed
        after display_stats the way the reference prints pprof."""
        file = file or sys.stderr
        if self.emf_hist:
            total = sum(self.emf_hist.values())
            print("EMF outcomes:", file=file)
            for name in self.EMF_CODE_NAMES:
                n = self.emf_hist.get(name, 0)
                if n:
                    print(f"  {name:<12} {n:>10}  "
                          f"({100.0 * n / total:5.1f}%)", file=file)
        nr = getattr(self, "overflow_retried", 0)
        if nr:
            print(f"overflow retries: {nr} reads "
                  f"({getattr(self, 'overflow_oracle', 0)} to oracle)",
                  file=file)

    def emf_filter(self, codes: np.ndarray, lens: np.ndarray):
        """Perfect-match prefilter (mem_kernel1_core's EMF pass,
        src/bwamem.cpp:1085-1130). Returns numpy dict or None."""
        if self.demf is None or codes.shape[1] < self.emf.seed_len:
            return None
        out = self._jit_emf(self.demf, self.fmi.ref,
                            jnp.asarray(codes, dtype=jnp.int32),
                            jnp.asarray(lens, dtype=jnp.int32))
        return {k: np.asarray(v) for k, v in out.items()}

    # ------------------------------------------------------------------
    # Host finalization
    # ------------------------------------------------------------------
    def align_batch(self, codes: np.ndarray, lens: np.ndarray):
        """codes [B, L] int (nt4), lens [B]. Returns per-read raw
        AlnReg lists."""
        L = int(codes.shape[1])
        out = self._jit_extend(self.fmi, self.dbns,
                               jnp.asarray(codes, dtype=jnp.int32),
                               jnp.asarray(lens, dtype=jnp.int32), L=L,
                               fma=self.dfma, ert=self.dert)
        all_regs, overflow = self._regs_from_device(out, codes)
        return self._apply_overflow_retry(all_regs, overflow, codes,
                                          lens)

    def _regs_from_device(self, out, codes: np.ndarray,
                          prefetched=None):
        """Returns (all_regs, overflow) — overflow[i] marks reads whose
        device results were truncated by a fixed-shape capacity and
        must be recomputed (consumed by _apply_overflow_retry)."""
        # Two fetches total (see the `packed` comment in
        # seed_chain_extend): the per-pair matrix and the [B, 2]
        # meta (frac_rep, overflow) — already local when a prefetch
        # thread ran.
        if prefetched is not None:
            pk = prefetched["packed"]
            meta = prefetched["meta"]
        else:
            pk = np.asarray(out["packed"])
            meta = np.asarray(out["meta"])
        frac_rep = meta[:, 0]
        overflow = meta[:, 1] > 0.5
        is_alt = self.idx.bns.is_alt
        B = codes.shape[0]

        (valid, read, qb_a, qe_a, score_a, truesc_a, w_a, seedcov_a,
         rid_a, seedlen0_a, rb_lo, rb_hi, re_lo, re_hi) = pk.T
        rb_a = (rb_hi.astype(np.int64) << 31) | rb_lo
        re_a = (re_hi.astype(np.int64) << 31) | re_lo

        all_regs: List[List[AlnReg]] = [[] for _ in range(B)]
        # Pairs come back compacted in (read, processing-rank) order
        # within each device shard; shards concatenate in read order
        # too, so scanning the valid rows preserves per-read rank.
        # Bulk-convert the valid rows' columns to Python scalars once
        # (.tolist is a C loop; per-element int() was ~4x the cost of
        # the whole device fetch at bench scale).
        rows = np.flatnonzero(valid & (qe_a > qb_a))
        cols = [c[rows].tolist() for c in
                (read, rb_a, re_a, qb_a, qe_a, rid_a, score_a,
                 truesc_a, w_a, seedcov_a, seedlen0_a)]
        frep = frac_rep[read[rows]].tolist()
        alt = is_alt[rid_a[rows]].tolist()
        for (i, rb, re, qb, qe, rid, sc, tsc, w, scov, sl0), fr, al \
                in zip(zip(*cols), frep, alt):
            all_regs[i].append(AlnReg(
                rb=rb, re=re, qb=qb, qe=qe, rid=rid, score=sc,
                truesc=tsc, w=w, seedcov=scov, seedlen0=sl0,
                frac_rep=fr, is_alt=bool(al)))
        return all_regs, overflow

    # ------------------------------------------------------------------
    # Overflow retry: reads whose device results were truncated by a
    # fixed-shape capacity are re-run at a larger shape (a second jit
    # bucket, batch RETRY_BATCH), and — should even that overflow — by
    # the NumPy oracle. The reference never drops alignment work
    # (heap-backed vectors, src/bwamem.cpp:789-1050); this is the
    # fixed-shape equivalent of that guarantee.
    # ------------------------------------------------------------------
    # Tier batches: big enough that a high-overflow batch (repeat-
    # rich genomes) costs a handful of retry dispatches, not hundreds
    RETRY_BATCH = 64
    RETRY2_BATCH = 8

    def _retry_jit(self):
        if getattr(self, "_retry_fn", None) is None:
            c = self.cfg
            # Tier shapes follow the MEASURED overflow drivers (hg38
            # round-4 probes): coordinate demand tops out ~720 at a
            # 512 base while chains/regs/pairs are what actually trip
            # — so tier 1 doubles coords (SAL cost ~ batch x coords,
            # the retry path's dominant term) and multiplies the
            # trip-prone capacities instead.
            cfg_big = PipelineConfig(
                max_smem_out=4 * (c.max_smem_out or 128),
                max_coords=max(1024, 2 * c.max_coords),
                max_chains=max(256, 4 * c.max_chains),
                max_seeds_per_chain=max(64, 2 * c.max_seeds_per_chain),
                max_regs=max(512, 4 * c.max_regs),
                max_pairs=0,    # set below: full B*R, no pair drops
                target_pad=c.target_pad,
                seed_engine=c.seed_engine,
                # generous but not maximal: the tier-1 machines carry
                # the batch's repeat monsters, and a [RF*B, L]-depth
                # reseed machine dominated retry cost when maximal
                # (hg38 profile: 18 s/dispatch). What still trips
                # here falls to tier 2 at full depth.
                seed_emit_depth=48, seed_stack_depth=48,
                reseed_factor=8)
            # pairs demand tops out ~64/read even on overflow reads
            # (round-4 probe); full B*R here meant a 262k-pair BSW
            # per tier-1 dispatch at hg38 — 16x the main batch's
            cfg_big.max_pairs = min(
                self.RETRY_BATCH * cfg_big.max_regs,
                128 * self.RETRY_BATCH)
            self._retry_cfg = cfg_big
            self._retry_fn = jax.jit(
                partial(seed_chain_extend, opt=self.opt, cfg=cfg_big),
                static_argnames=("L",))
        return self._retry_fn

    def _retry2_jit(self):
        """Second retry tier (repeat-monster reads; hg38-class
        genomes overflow tier 1 often enough that the pure-Python
        oracle — seconds per read at 3 Gbp — must stay a last
        resort, not a common path)."""
        if getattr(self, "_retry2_fn", None) is None:
            c1 = self._retry_cfg
            # Sized so the seconds-per-read oracle is vanishingly
            # rare (tier-2 batches are small: the wide arrays stay
            # cheap).
            cfg2 = PipelineConfig(
                max_smem_out=2 * c1.max_smem_out,
                max_coords=16 * c1.max_coords,
                max_chains=4 * c1.max_chains,
                max_seeds_per_chain=4 * c1.max_seeds_per_chain,
                max_regs=4 * c1.max_regs,
                max_pairs=0,
                target_pad=c1.target_pad,
                seed_engine=c1.seed_engine,
                seed_emit_depth=None, seed_stack_depth=None,
                reseed_factor=256)
            cfg2.max_pairs = self.RETRY2_BATCH * cfg2.max_regs
            self._retry2_cfg = cfg2
            self._retry2_fn = jax.jit(
                partial(seed_chain_extend, opt=self.opt, cfg=cfg2),
                static_argnames=("L",))
        return self._retry2_fn

    def _oracle_raw_regs(self, query: np.ndarray):
        """Raw (pre-dedup) AlnRegs for one read via the NumPy oracle —
        the unbounded-capacity fallback of last resort."""
        from ..ref.fm import FMOracle
        from ..ref import chain as chain_mod
        from ..ref.extend import chain2aln
        if not hasattr(self, "_fm_oracle"):
            self._fm_oracle = FMOracle(self.idx)
        opt, bns = self.opt, self.idx.bns
        smems = self._fm_oracle.collect_smems(query, 0, opt)
        chains = chain_mod.chain_seeds(self._fm_oracle, opt, bns,
                                       query, 0, smems)
        chains = chain_mod.chain_flt(opt, chains)
        chain_mod.flt_chained_seeds(opt, bns, self.idx.ref_string,
                                    query, chains)
        return chain2aln(opt, bns, self.idx.ref_string, query, chains)

    def _apply_overflow_retry(self, all_regs, overflow, codes, lens):
        """Replace truncated reads' regs with full-capacity reruns."""
        idxs = [int(i) for i in np.flatnonzero(overflow)
                if int(lens[i]) > 0]
        if not idxs:
            return all_regs
        self.overflow_retried = getattr(self, "overflow_retried", 0) \
            + len(idxs)
        fn = self._retry_jit()
        L = int(codes.shape[1])
        RB = self.RETRY_BATCH
        for base in range(0, len(idxs), RB):
            grp = idxs[base: base + RB]
            gc = np.full((RB, L), 4, dtype=np.int32)
            gl = np.zeros(RB, dtype=np.int32)
            for j, i in enumerate(grp):
                gc[j] = codes[i]
                gl[j] = lens[i]
            out = fn(self.fmi, self.dbns, jnp.asarray(gc),
                     jnp.asarray(gl), L=L, fma=self.dfma,
                     ert=self.dert)
            regs2, of2 = self._regs_from_device(out, gc)
            tier2 = []
            for j, i in enumerate(grp):
                if of2[j]:   # tier 2 before the oracle of last resort
                    tier2.append(i)
                else:
                    all_regs[i] = regs2[j]
            fn2 = self._retry2_jit() if tier2 else None
            for base2 in range(0, len(tier2), self.RETRY2_BATCH):
                grp2 = tier2[base2: base2 + self.RETRY2_BATCH]
                g2c = np.full((self.RETRY2_BATCH, L), 4, dtype=np.int32)
                g2l = np.zeros(self.RETRY2_BATCH, dtype=np.int32)
                for j, i in enumerate(grp2):
                    g2c[j] = codes[i]
                    g2l[j] = lens[i]
                out2 = fn2(self.fmi, self.dbns, jnp.asarray(g2c),
                           jnp.asarray(g2l), L=L, fma=self.dfma,
                           ert=self.dert)
                regs3, of3 = self._regs_from_device(out2, g2c)
                if of3.any():
                    # diagnose which capacity still trips tier 2 —
                    # every oracle fallthrough costs ~a second at
                    # 3 Gbp, so the tally directs tier sizing
                    comp = getattr(self, "oracle_of_components", {})
                    for key in ("chain_overflow", "reg_overflow",
                                "pair_overflow"):
                        comp[key] = comp.get(key, 0) + int(
                            np.asarray(out2[key]).sum())
                    ct = np.asarray(out2["coord_total"])
                    cap = self._retry2_cfg.max_coords
                    comp["coord_at_cap"] = comp.get(
                        "coord_at_cap", 0) + int((ct >= cap).sum())
                    smc = np.asarray(out2["smem_cnt"])
                    comp["smem_cnt_max"] = max(
                        comp.get("smem_cnt_max", 0), int(smc.max()))
                    self.oracle_of_components = comp
                for j, i in enumerate(grp2):
                    if of3[j]:   # still truncated: oracle (never drops)
                        self.overflow_oracle = getattr(
                            self, "overflow_oracle", 0) + 1
                        all_regs[i] = self._oracle_raw_regs(
                            codes[i, : lens[i]].astype(np.uint8))
                    else:
                        all_regs[i] = regs3[j]
        return all_regs

    def dispatch_batch(self, codes: np.ndarray, lens: np.ndarray,
                       skip_emf: bool = False):
        """Asynchronously launch the device stages (EMF probe + the
        fused seed-chain-extend program) for one batch. Returns an
        opaque handle for finalize_batch — the device equivalent of the
        ktp pipeline's compute step overlapping the neighbours
        (src/fastmap.cpp:470-509)."""
        codes = np.ascontiguousarray(codes, dtype=np.int32)
        lens = np.ascontiguousarray(lens, dtype=np.int32)
        L = int(codes.shape[1])
        if getattr(self, "stage_profile_pending", False):
            # mem -v 4: one-shot incremental stage table on the first
            # real batch (display_stats analogue)
            self.stage_profile_pending = False
            from .stageprof import device_stage_profile
            device_stage_profile(self, codes, lens)
        pm_dev = None
        lens_dev = jnp.asarray(lens)
        codes_dev = jnp.asarray(codes)
        if (not skip_emf and self.demf is not None
                and L >= self.emf.seed_len):
            from ..ops.emf import FW_MATCHED, RC_MATCHED
            pm_dev = self._jit_emf(self.demf, self.fmi.ref, codes_dev,
                                   lens_dev)
            is_pm = ((pm_dev["code"] == FW_MATCHED)
                     | (pm_dev["code"] == RC_MATCHED))
            lens_dev = jnp.where(is_pm, 0, lens_dev)
        out = self._jit_extend(self.fmi, self.dbns, codes_dev,
                               lens_dev, L=L, fma=self.dfma,
                               ert=self.dert)
        return (codes, lens, pm_dev, out)

    def start_prefetch(self, handle):
        """Fetch the extend outputs on a background thread (the RPC
        wait releases the GIL). Not used by the stream driver, which
        fetches synchronously; an asynchronous fetch on the GPU is an
        open measurement (ROADMAP 1.5)."""
        import threading
        codes, lens, pm_dev, out = handle
        pm_stacked = None
        if pm_dev is not None:
            pm_stacked = jnp.stack(
                [pm_dev["code"].astype(jnp.int64),
                 pm_dev["slot"].astype(jnp.int64),
                 pm_dev["loc"]], axis=1)
        slot = {}

        def work():
            try:
                slot["packed"] = np.asarray(out["packed"])
                slot["meta"] = np.asarray(out["meta"])
                if pm_stacked is not None:
                    slot["pm_cs"] = np.asarray(pm_stacked)
            except Exception as e:      # surfaced at join time
                slot["err"] = e

        th = threading.Thread(target=work, daemon=True)
        th.start()
        return (codes, lens, pm_dev, out, {"thread": th, "slot": slot})

    def fetch_extend(self, handle):
        """Synchronously fetch the extend outputs (waits for the
        device program). Returns the 5-tuple handle form that
        finalize_stage_a consumes without re-fetching — letting the
        caller dispatch the NEXT extend batch in the gap between the
        fetch and the per-read host work (pipeline/stream.py), so the
        device never idles through dedup/cigar_begin."""
        if len(handle) == 5:
            return handle
        codes, lens, pm_dev, out = handle
        slot = {"packed": np.asarray(out["packed"]),
                "meta": np.asarray(out["meta"])}
        if pm_dev is not None:
            slot["pm_cs"] = np.asarray(jnp.stack(
                [pm_dev["code"].astype(jnp.int64),
                 pm_dev["slot"].astype(jnp.int64),
                 pm_dev["loc"]], axis=1))
        return (codes, lens, pm_dev, out, {"slot": slot})

    @staticmethod
    def _join_prefetch(handle):
        if len(handle) == 5:
            pf = handle[4]
            if "thread" in pf:
                pf["thread"].join()
            if "err" in pf["slot"]:
                raise pf["slot"]["err"]
            return handle[:4], pf["slot"]
        return handle, None

    def finalize_batch(self, handle, id_offset: int = 0,
                       read_ids=None):
        """Host half of align_and_finalize for a dispatched batch.
        read_ids (optional) carries the true global read ids for the
        hash_64 tiebreaks when the batch is a compacted backlog."""
        return self.finalize_stage_b(
            self.finalize_stage_a(handle, id_offset, read_ids))

    def finalize_stage_a(self, handle, id_offset: int = 0,
                         read_ids=None, sam_ctx=None):
        """Fetch extend results, run the per-read host work, and
        dispatch the CIGAR DP asynchronously (3-stage pipeline:
        extend | cigar | records).

        sam_ctx (dict with names/quals/rg_id) switches the native
        path to composing finished SAM text per read (the
        mem_aln2sam analogue, all in one C call) instead of boxed
        Aln records — stage_b then returns {batch_idx: bytes}."""
        from .finalize import BatchFinalizer
        from ..utils.profiling import PROFILER
        opt = self.opt
        bns = self.idx.bns
        ref = self.idx.ref_string
        handle, pf = self._join_prefetch(handle)
        codes, lens, pm_dev, out = handle

        pm_records = {}
        if pm_dev is not None:
            from .perfect import perfect_sam_records
            from ..ops.emf import FW_MATCHED, RC_MATCHED
            # single fetch: code/slot/loc are all the host consumes
            cs = (pf["pm_cs"] if pf is not None and "pm_cs" in pf
                  else np.asarray(jnp.stack(
                      [pm_dev["code"].astype(jnp.int64),
                       pm_dev["slot"].astype(jnp.int64),
                       pm_dev["loc"]], axis=1)))
            pm_code, pm_slot, pm_loc = cs[:, 0], cs[:, 1], cs[:, 2]
            is_pm = ((pm_code == FW_MATCHED)
                     | (pm_code == RC_MATCHED))
            self.emf_checked += len(lens)
            self.emf_hits += int(is_pm.sum())
            self._emf_count(pm_code)
            for i in np.flatnonzero(is_pm):
                read = codes[i, : lens[i]].astype(np.uint8)
                pm_records[int(i)] = perfect_sam_records(
                    opt, bns, self.emf, ref, read,
                    int(pm_code[i]), int(pm_slot[i]),
                    loc0=int(pm_loc[i]))

        from . import native_finalize
        if native_finalize.available():
            # Native record pipeline (dedup/patch + mark_primary +
            # selection + CIGAR/NM/MD + XA in one C call) for every
            # read the fixed shapes fully covered; overflow reads take
            # the Python retry path below, EMF hits are overridden by
            # pm_records either way.
            nat = self._finalize_native(out, pf, codes, lens,
                                        id_offset, read_ids,
                                        pm_records, sam_ctx=sam_ctx)
            if nat is not None:
                return nat
        with PROFILER.phase("fetch_regs"):
            all_regs, overflow = self._regs_from_device(out, codes,
                                                        prefetched=pf)
        if overflow.any():
            with PROFILER.phase("overflow_retry"):
                all_regs = self._apply_overflow_retry(
                    all_regs, overflow, codes, lens)
        queries = []
        finalized = []
        with PROFILER.phase("dedup_primary"):
            for i, regs in enumerate(all_regs):
                query = codes[i, : lens[i]].astype(np.uint8)
                queries.append(query)
                regs = sort_dedup_patch(opt, bns, ref, query, regs)
                rid = (read_ids[i] if read_ids is not None
                       else id_offset + i)
                regs, _ = mark_primary(opt, regs, rid)
                if opt.flag & MEM_F_PRIMARY5:
                    reorder_primary5(opt.T, regs)
                finalized.append(regs)
        fin = BatchFinalizer(opt, self.idx)
        with PROFILER.phase("cigar_begin"):
            state = fin.begin_batch(queries, finalized)
        if sam_ctx is not None:   # full-Python fallback in sam mode
            return ("pysam", (fin, state, pm_records), sam_ctx,
                    codes, lens)
        return (fin, state, pm_records)

    def _finalize_native(self, out, pf, codes, lens, id_offset,
                         read_ids, pm_records, sam_ctx=None):
        """Native-path stage a: returns a ('native', records) handle
        for finalize_stage_b, or None to fall back to Python (arena
        overflow). Overflow reads run the existing Python retry +
        finalize machinery on the side. With sam_ctx, the native path
        composes finished SAM text instead (('sam', bytes_by_idx))."""
        from . import native_finalize
        from .finalize import BatchFinalizer
        from ..utils.profiling import PROFILER
        opt = self.opt
        bns = self.idx.bns
        ref = self.idx.ref_string
        with PROFILER.phase("fetch_pack"):
            if pf is not None:
                pk = pf["packed"]
                meta = pf["meta"]
            else:
                pk = np.asarray(out["packed"])
                meta = np.asarray(out["meta"])
        frac_rep = meta[:, 0]
        overflow = meta[:, 1] > 0.5
        B = codes.shape[0]
        rids_arr = (np.asarray(read_ids, dtype=np.int64)
                    if read_ids is not None
                    else id_offset + np.arange(B, dtype=np.int64))

        with PROFILER.phase("native_finalize"):
            (valid, read, qb_a, qe_a, score_a, truesc_a, w_a,
             seedcov_a, rid_a, seedlen0_a, rb_lo, rb_hi, re_lo,
             re_hi) = pk.T
            keep = (valid & (qe_a > qb_a)).astype(bool)
            rows = {
                "read": read[keep],
                "rb": ((rb_hi[keep].astype(np.int64) << 31)
                       | rb_lo[keep]),
                "re": ((re_hi[keep].astype(np.int64) << 31)
                       | re_lo[keep]),
                "qb": qb_a[keep], "qe": qe_a[keep],
                "rid": rid_a[keep], "score": score_a[keep],
                "truesc": truesc_a[keep], "w": w_a[keep],
                "seedcov": seedcov_a[keep],
                "seedlen0": seedlen0_a[keep],
            }
            proc = np.flatnonzero(~overflow).astype(np.int32)
            want = "raw" if sam_ctx is not None else "aln"
            rec_by_read = native_finalize.finalize_se_rows(
                opt, self.idx, rows, proc, frac_rep, rids_arr,
                codes, lens, want=want)
        if rec_by_read is None:
            return None
        if sam_ctx is not None:
            from ..io.sam import compose_sam_python
            sam_by_read = native_finalize.compose_sam_raw(
                rec_by_read, opt, bns, codes, lens,
                sam_ctx.get("names"), sam_ctx.get("quals"),
                sam_ctx.get("rg_id"))
            if sam_by_read is None:
                return None
            out_lines = [None] * B
            for i in proc.tolist():
                out_lines[i] = sam_by_read.get(i, b"")
            if overflow.any():
                if sam_ctx.get("defer_overflow"):
                    # leave the overflow reads' slots None — the
                    # stream collects them into a retry backlog and
                    # runs the tier ladder on full amortized batches
                    # instead of serializing small retry programs
                    # into every batch cycle
                    pass
                else:
                    by_idx = self._python_finalize_records(
                        codes, lens, overflow, rids_arr)
                    for i, recs in by_idx.items():
                        out_lines[i] = compose_sam_python(
                            opt, bns, codes[i, : lens[i]], recs,
                            sam_ctx, i)
            for i, recs in pm_records.items():
                out_lines[i] = compose_sam_python(
                    opt, bns, codes[i, : lens[i]], recs, sam_ctx, i)
            return ("sam", out_lines, {})
        out_records = [None] * B
        for i in proc.tolist():
            out_records[i] = rec_by_read.get(i)
        if overflow.any():
            for i, recs in self._python_finalize_records(
                    codes, lens, overflow, rids_arr).items():
                out_records[i] = recs
        return ("native", out_records, pm_records)

    def _python_finalize_records(self, codes, lens, overflow,
                                 rids_arr):
        """Overflow reads' records via the Python retry + finalize
        machinery. Returns {batch_idx: [Aln, ...]}."""
        from ..utils.profiling import PROFILER
        B = codes.shape[0]
        with PROFILER.phase("overflow_retry"):
            all_regs = [[] for _ in range(B)]
            all_regs = self._apply_overflow_retry(
                all_regs, overflow, codes, lens)
        return self._records_from_regs(codes, lens, overflow,
                                       all_regs, rids_arr)

    def _records_from_regs(self, codes, lens, which, all_regs,
                           rids_arr):
        """Dedup/primary/records for the reads marked in `which`
        given raw region lists. Returns {batch_idx: [Aln, ...]}."""
        from .finalize import BatchFinalizer
        opt = self.opt
        bns = self.idx.bns
        ref = self.idx.ref_string
        fin = BatchFinalizer(opt, self.idx)
        ov = np.flatnonzero(which)
        queries, finalized = [], []
        for i in ov.tolist():
            query = codes[i, : lens[i]].astype(np.uint8)
            queries.append(query)
            regs = sort_dedup_patch(opt, bns, ref, query,
                                    all_regs[i])
            regs, _ = mark_primary(opt, regs, int(rids_arr[i]))
            if opt.flag & MEM_F_PRIMARY5:
                reorder_primary5(opt.T, regs)
            finalized.append(regs)
        recs = fin.records_for_batch(queries, finalized)
        return {i: recs[j] for j, i in enumerate(ov.tolist())}

    def finalize_stage_b(self, stage):
        from ..utils.profiling import PROFILER
        if stage[0] == "sam":
            return stage[1]
        if stage[0] == "pysam":
            from ..io.sam import compose_sam_python
            _, inner, sam_ctx, codes, lens = stage
            recs = self.finalize_stage_b(inner)
            return [compose_sam_python(self.opt, self.idx.bns,
                                       codes[i, : lens[i]], r,
                                       sam_ctx, i)
                    if r is not None else None
                    for i, r in enumerate(recs)]
        if stage[0] == "native":
            _, out_records, pm_records = stage
            for i, recs in pm_records.items():
                out_records[i] = recs
            return out_records
        fin, state, pm_records = stage
        with PROFILER.phase("cigar_complete"):
            out_records = fin.complete_batch(state)
        for i, recs in pm_records.items():
            out_records[i] = recs
        return out_records

    def align_and_finalize(self, codes: np.ndarray, lens: np.ndarray,
                           id_offset: int = 0):
        """Full SE path to per-read SAM records (batched device
        CIGARs; EMF hits short-circuit via mem_perfect2sam)."""
        return self.finalize_batch(self.dispatch_batch(codes, lens),
                                   id_offset)

    def dispatch_pairs(self, codes: np.ndarray, lens: np.ndarray):
        """PE stage 1: host EMF probe + async extend dispatch.
        codes [2N, L] with mates interleaved (2i, 2i+1)."""
        opt = self.opt
        bns = self.idx.bns
        ref = self.idx.ref_string
        B = codes.shape[0]
        assert B % 2 == 0
        pm_regs = {}
        lens_eff = np.asarray(lens)
        pm = None
        if self.emf is not None and codes.shape[1] >= self.emf.seed_len:
            # host probe (as in the SE stream): a device probe is an
            # extra program + fetch on the serialized execute queue
            from ..index.perfect import emf_lookup_host
            pm = emf_lookup_host(self.emf, ref, codes, lens)
        if pm is not None:
            from .perfect import perfect_regs
            from ..ops.emf import FW_MATCHED, RC_MATCHED
            is_pm = ((pm["code"] == FW_MATCHED)
                     | (pm["code"] == RC_MATCHED))
            self.emf_checked += len(lens)
            self.emf_hits += int(is_pm.sum())
            self._emf_count(pm["code"])
            if is_pm.any():
                lens_eff = np.where(is_pm, 0, lens_eff).astype(np.int32)
                for i in np.flatnonzero(is_pm):
                    read = codes[i, : lens[i]].astype(np.uint8)
                    pm_regs[int(i)] = perfect_regs(
                        opt, bns, self.emf, ref, read,
                        int(pm["code"][i]), int(pm["slot"][i]),
                        loc0=int(pm["loc"][i]))
        handle = self.dispatch_batch(
            codes, np.asarray(lens_eff, dtype=np.int32), skip_emf=True)
        return (codes, lens, pm_regs, handle)

    def fetch_pairs(self, ph):
        """PE stage 2: the extend-result fetch — the device sync
        point. With the native PE pipeline available, the packed
        arrays are kept raw (no per-region Python objects — that
        conversion alone was 24% of PE wall); only overflow reads
        take the Python retry to region lists."""
        import os as _os
        codes, lens, pm_regs, handle = ph
        handle, pf = self._join_prefetch(handle)
        out = handle[3]
        from ..utils.profiling import PROFILER
        from . import native_finalize
        if (native_finalize.available()
                and not _os.environ.get("BWA_TPU_NO_NATIVE_PE")):
            with PROFILER.phase("fetch_pack"):
                if pf is not None:
                    pk, meta = pf["packed"], pf["meta"]
                else:
                    pk = np.asarray(out["packed"])
                    meta = np.asarray(out["meta"])
            overflow = meta[:, 1] > 0.5
            ov_regs = {}
            if overflow.any():
                with PROFILER.phase("overflow_retry"):
                    B = codes.shape[0]
                    tmp = self._apply_overflow_retry(
                        [[] for _ in range(B)], overflow, codes, lens)
                for i in np.flatnonzero(overflow).tolist():
                    ov_regs[i] = tmp[i]
            return ("raw", codes, lens, pm_regs, pk, meta, ov_regs)
        with PROFILER.phase("fetch_regs"):
            all_regs, overflow = self._regs_from_device(out, codes,
                                                        prefetched=pf)
        if overflow.any():
            with PROFILER.phase("overflow_retry"):
                all_regs = self._apply_overflow_retry(
                    all_regs, overflow, codes, lens)
        return (codes, lens, pm_regs, all_regs)

    def pe_post(self, fetched, id_offset: int = 0, sam_ctx=None):
        """PE stage 3 (host-only): pestat, native mate rescue,
        pairing, record composition — overlap with the next batch's
        extend. Mirrors worker_sam's PE flow
        (src/bwamem.cpp:1668-1830). The native pipeline
        (finalize_pe_batch) runs the whole stage in one C call; the
        Python path remains the oracle and fallback. With sam_ctx
        the records come back as finished SAM bytes per read."""
        if isinstance(fetched[0], str) and fetched[0] == "raw":
            out = self._pe_post_native(fetched, id_offset,
                                       sam_ctx=sam_ctx)
            if out is not None:
                return out
            fetched = self._raw_to_python_fetch(fetched)
        records, mates = self._pe_post_python(fetched, id_offset)
        if sam_ctx is not None:
            from ..io.sam import compose_sam_python
            codes, lens = fetched[0], fetched[1]
            records = [compose_sam_python(
                self.opt, self.idx.bns, codes[i, : lens[i]], r,
                sam_ctx, i, mate=mates[i]) if r is not None else None
                for i, r in enumerate(records)]
        return records, mates

    def _raw_to_python_fetch(self, fetched):
        """Materialize the Python (codes, lens, pm_regs, all_regs)
        form from a raw fetch tuple (native-path fallback)."""
        _, codes, lens, pm_regs, pk, meta, ov_regs = fetched
        all_regs, _of = self._regs_from_device(
            None, codes, prefetched={"packed": pk, "meta": meta})
        for i, regs in ov_regs.items():
            all_regs[i] = regs
        return (codes, lens, pm_regs, all_regs)

    def _pe_post_native(self, fetched, id_offset: int, sam_ctx=None):
        """One-call native PE post (finalize_pe_batch). Returns
        (records, mates) or None to fall back to Python. With
        sam_ctx, records are finished SAM bytes per read
        (compose_sam_se in PE mode: mate columns + TLEN)."""
        from . import native_finalize
        from ..utils.profiling import PROFILER
        _, codes, lens, pm_regs, pk, meta, ov_regs = fetched
        B = codes.shape[0]
        n_pairs = B // 2
        with PROFILER.phase("pe_rows"):
            # a writable copy: overflow reads overwrite their entry below
            frac_rep = np.array(meta[:, 0], dtype=np.float32)
            overflow = meta[:, 1] > 0.5
            (valid, read, qb_a, qe_a, score_a, truesc_a, w_a,
             seedcov_a, rid_a, seedlen0_a, rb_lo, rb_hi, re_lo,
             re_hi) = pk.T
            bad = overflow.copy()
            for i in pm_regs:
                bad[i] = True
            keep = (valid & (qe_a > qb_a)).astype(bool) \
                & ~bad[read]
            cols = dict(
                read=read[keep],
                rb=(rb_hi[keep].astype(np.int64) << 31) | rb_lo[keep],
                re=(re_hi[keep].astype(np.int64) << 31) | re_lo[keep],
                qb=qb_a[keep], qe=qe_a[keep], rid=rid_a[keep],
                score=score_a[keep], truesc=truesc_a[keep],
                w=w_a[keep], seedcov=seedcov_a[keep],
                seedlen0=seedlen0_a[keep])
            extra = []
            for src in (pm_regs, ov_regs):
                for i, regs in src.items():
                    for r in regs:
                        extra.append((i, r.rb, r.re, r.qb, r.qe,
                                      r.rid, r.score, r.truesc, r.w,
                                      r.seedcov, r.seedlen0))
                    if src is ov_regs and regs:
                        frac_rep[i] = regs[0].frac_rep
            if extra:
                ex = np.asarray(extra, dtype=np.int64)
                names = ("read", "rb", "re", "qb", "qe", "rid",
                         "score", "truesc", "w", "seedcov",
                         "seedlen0")
                allc = {k: np.concatenate(
                    [np.asarray(cols[k], np.int64), ex[:, j]])
                    for j, k in enumerate(names)}
                order = np.argsort(allc["read"], kind="stable")
                rows = {k: v[order] for k, v in allc.items()}
            else:
                rows = cols
            skip_dedup = np.zeros(B, dtype=np.uint8)
            for i in pm_regs:
                skip_dedup[i] = 1
            read_ids = id_offset + np.arange(B, dtype=np.int64)
        res = native_finalize.finalize_pe_rows(
            self.opt, self.idx, rows, n_pairs, frac_rep, read_ids,
            skip_dedup, codes, lens, pes_in=self.pes,
            want="raw" if sam_ctx is not None else "aln")
        if res is None:
            return None
        if sam_ctx is not None:
            raw, mate_arrs, _pes = res
            sam_by_read = native_finalize.compose_sam_raw(
                raw, self.opt, self.idx.bns, codes, lens,
                sam_ctx.get("names"), sam_ctx.get("quals"),
                sam_ctx.get("rg_id"), mate=mate_arrs)
            if sam_by_read is None:
                return None
            records = [sam_by_read.get(i, b"") for i in range(B)]
            return records, [None] * B
        recs_by_read, mates, _pes = res
        records = [recs_by_read.get(i, []) for i in range(B)]
        return records, mates

    def _pe_post_python(self, fetched, id_offset: int = 0):
        from .pe import (mem_pestat, build_rescue_jobs, run_rescue_jobs,
                         apply_rescues, sam_pe_records)
        opt = self.opt
        bns = self.idx.bns
        ref = self.idx.ref_string
        from ..utils.profiling import PROFILER
        codes, lens, pm_regs, all_regs = fetched
        B = codes.shape[0]
        queries = [codes[i, : lens[i]].astype(np.uint8)
                   for i in range(B)]
        with PROFILER.phase("pe_dedup"):
            for i in range(B):
                if i in pm_regs:
                    all_regs[i] = pm_regs[i]
                else:
                    all_regs[i] = sort_dedup_patch(
                        opt, bns, ref, queries[i], all_regs[i])

        pair_regs = [(all_regs[2 * p], all_regs[2 * p + 1])
                     for p in range(B // 2)]
        pair_seqs = [(queries[2 * p], queries[2 * p + 1])
                     for p in range(B // 2)]
        with PROFILER.phase("pe_pestat"):
            pes = self.pes if self.pes is not None else mem_pestat(
                opt, bns.l_pac, pair_regs,
                log=lambda m: print(m, file=sys.stderr))

        with PROFILER.phase("pe_rescue_plan"):
            jobs = build_rescue_jobs(opt, bns, ref, pes, pair_regs,
                                     pair_seqs)
        with PROFILER.phase("pe_rescue_run"):
            results = run_rescue_jobs(opt, jobs)
            apply_rescues(opt, bns.l_pac, jobs, results, pair_regs)

        from .pe_batch import AlnBatcher
        batcher = AlnBatcher(opt, self.idx, queries)
        records: List[list] = [None] * B
        mates: List[object] = [None] * B
        with PROFILER.phase("pe_records"):
            for p in range(B // 2):
                regs2 = [list(pair_regs[p][0]), list(pair_regs[p][1])]
                q2 = [queries[2 * p], queries[2 * p + 1]]
                recs2, m2 = sam_pe_records(
                    opt, bns, ref, pes, (id_offset >> 1) + p, q2,
                    regs2, batcher=batcher, qidx=(2 * p, 2 * p + 1))
                records[2 * p], records[2 * p + 1] = recs2
                mates[2 * p], mates[2 * p + 1] = m2
        with PROFILER.phase("pe_cigar_resolve"):
            batcher.resolve()
        return records, mates

    def align_pairs_and_finalize(self, codes: np.ndarray,
                                 lens: np.ndarray, id_offset: int = 0):
        """Synchronous PE path: dispatch + fetch + host post in one
        call. The driver pipelines the three stages instead."""
        return self.pe_post(
            self.fetch_pairs(self.dispatch_pairs(codes, lens)),
            id_offset)

    def align_reads_to_sam(self, batch, id_offset: int = 0) -> List[str]:
        codes, lens = batch.padded_codes()
        records_per_read = self.align_and_finalize(
            codes.astype(np.int32), lens, id_offset)
        lines = []
        for read, records in zip(batch.reads, records_per_read):
            for which in range(len(records)):
                lines.append(aln_to_sam_line(self.opt, self.idx.bns, read,
                                             len(records), records, which))
        return lines
