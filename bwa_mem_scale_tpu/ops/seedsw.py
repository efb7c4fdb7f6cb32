"""Device seed-SW validation for the long-read regime.

Device mem_flt_chained_seeds (src/bwamem.cpp:494-526 +
mem_seed_sw src/bwamem.cpp:423-451): every short seed (< 200 bp) of a
kept chain is re-scored by a plain local Smith-Waterman over a small
window (seed +/- 50 bp on both axes); seeds whose window score falls
below the per-read HSP threshold are dropped before extension. Active
only when min_l <= 0.05 * l_query — i.e. reads longer than ~666 bp at
default scoring — so short-read batches never trace this stage.

The SW kernel is score-only affine local alignment with the exact
gap-state semantics of the scalar oracle (ref/chain._local_sw_score,
itself ksw_align2's score): E and F both open from M only, so the
row-wise F recurrence collapses to a closed-form prefix-max
(F[j] = max_{k<j} m[k] - o_ins - e_ins*(j-k)), making each DP row one
vectorized [P, QL] step — no sequential inner loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ref.chain import (MEM_SHORT_EXT, MEM_SHORT_LEN, MEM_HSP_COEF,
                         MEM_MINSC_COEF, MEM_SEEDSW_COEF)


def local_sw_score_batch(q, qlen, t, tlen, mat, o_del: int, e_del: int,
                         o_ins: int, e_ins: int):
    """Max local-SW score per lane.

    q [P, QL] int32 codes (query window), qlen [P], t [P, TL] codes,
    tlen [P], mat [5, 5] scoring matrix. Returns best [P] int32.
    """
    P, QL = q.shape
    TL = t.shape[1]
    mat = jnp.asarray(mat, jnp.int32)
    NEG = jnp.int32(-(1 << 20))
    jcol = jnp.arange(QL, dtype=jnp.int32)[None, :]
    qvalid = jcol < qlen[:, None]
    ei = jnp.int32(e_ins)
    ramp = ei * jnp.arange(QL, dtype=jnp.int32)[None, :]

    def row(i, carry):
        H, E, best = carry                      # H/E: [P, QL] (j=1..QL)
        tb = t[:, i]                            # [P]
        prof = mat[tb[:, None], q]              # [P, QL]
        # H[i-1][j-1]: shift H right by one, 0 in column 0
        Hdiag = jnp.concatenate(
            [jnp.zeros((P, 1), jnp.int32), H[:, :-1]], axis=1)
        m = Hdiag + prof
        h_me = jnp.maximum(jnp.maximum(m, E), 0)
        # F[j] = max_{k<j} (m[k] - o_ins - e_ins*(j-k))
        #      = prefixmax(m[k] + e_ins*k) - e_ins*j - o_ins  (k < j)
        g = jnp.where(qvalid, m, NEG) + ramp
        pm = jax.lax.cummax(g, axis=1)
        pm = jnp.concatenate(
            [jnp.full((P, 1), NEG, jnp.int32), pm[:, :-1]], axis=1)
        F = pm - ramp - jnp.int32(o_ins + e_ins)
        h = jnp.maximum(h_me, F)
        h = jnp.where(qvalid & (i < tlen)[:, None], h, 0)
        E2 = jnp.maximum(m - (o_del + e_del), E - e_del)
        E2 = jnp.maximum(E2, 0)
        E2 = jnp.where(qvalid & (i < tlen)[:, None], E2, 0)
        best = jnp.maximum(best, jnp.max(h, axis=1))
        return h, E2, best

    z = jnp.zeros((P, QL), jnp.int32)
    _, _, best = jax.lax.fori_loop(
        0, TL, row, (z, z, jnp.zeros((P,), jnp.int32)))
    return best


def seed_sw_windows(dbns, lens, qbeg, rbeg, slen):
    """Per-seed SW window bounds (mem_seed_sw, src/bwamem.cpp:423-443).

    All args flat [N] (qbeg/slen int32, rbeg int64). Returns
    (qb, qe, rb, re, eligible): eligible = the seed is short enough
    that a window SW applies; ineligible seeds score -1 ("good
    enough") in the reference.
    """
    l_pac = dbns.l_pac
    l_query = lens
    qb = jnp.maximum(qbeg - MEM_SHORT_EXT, 0)
    qe = jnp.minimum(qbeg + slen + MEM_SHORT_EXT, l_query)
    rb = jnp.maximum(rbeg - MEM_SHORT_EXT, 0)
    re = jnp.minimum(rbeg + slen.astype(rbeg.dtype) + MEM_SHORT_EXT,
                     jnp.int64(l_pac << 1).astype(rbeg.dtype))
    mid = (rbeg + rbeg + slen.astype(rbeg.dtype)) >> 1
    bridging = (rb < l_pac) & (l_pac < re)
    re = jnp.where(bridging & (mid < l_pac), l_pac, re)
    rb = jnp.where(bridging & (mid >= l_pac), l_pac, rb)
    # clamp to the contig containing mid (bns_fetch_seq_v2)
    mid_f, mid_rev = dbns.depos(mid)
    rid = jnp.clip(dbns.pos2rid(mid_f), 0, None).astype(jnp.int32)
    far_beg = dbns.offsets[rid]
    n_off = jnp.concatenate(
        [dbns.offsets, jnp.asarray([l_pac], jnp.int64)])
    far_end = n_off[rid + 1]
    l2 = jnp.int64(l_pac << 1)
    fb = jnp.where(mid_rev, l2 - far_end, far_beg).astype(rb.dtype)
    fe = jnp.where(mid_rev, l2 - far_beg, far_end).astype(rb.dtype)
    rb = jnp.maximum(rb, fb)
    re = jnp.minimum(re, fe)
    eligible = ((slen < MEM_SHORT_LEN)
                & ((qe - qb) < MEM_SHORT_LEN)
                & ((re - rb) < MEM_SHORT_LEN))
    return qb, qe, rb, re, eligible


def seed_sw_filter(fmi, dbns, codes, lens, ch, order, kept, opt,
                   max_sw: int):
    """Apply mem_flt_chained_seeds to the chain seed set on device.

    Returns (seed_live [B, C, S] bool by slot, seed_score [B, C, S]
    updated by slot, overflow [B] bool). For reads where the filter is
    inactive, seed_live is the plain n_seeds prefix and scores are
    unchanged.
    """
    from .smem import compact_indices
    B, C, S = ch.seed_qbeg.shape
    bidx = jnp.arange(B)
    sidx = jnp.arange(S, dtype=jnp.int32)[None, None, :]
    live0 = sidx < ch.n_seeds[:, :, None]          # [B, C, S] by slot

    # per-read activation + thresholds (mem_flt_chained_seeds prologue)
    lq = jnp.maximum(lens, 2).astype(jnp.float32)
    if opt.min_chain_weight:
        min_l = jnp.full_like(lq, MEM_HSP_COEF * opt.min_chain_weight)
    else:
        min_l = MEM_MINSC_COEF * jnp.log(lq)
    active = (min_l <= MEM_SEEDSW_COEF * lens.astype(jnp.float32))
    min_hsp = (opt.a * min_l + 0.499).astype(jnp.int32)

    # kept mask back onto slots: kept is by sorted position over
    # `order` (slot per position)
    kept_slot = jnp.zeros((B, C), dtype=bool).at[
        bidx[:, None], order].max(kept > 0)

    qbeg = ch.seed_qbeg.reshape(B, -1)
    rbeg = ch.seed_rbeg.reshape(B, -1)
    slen = ch.seed_len.reshape(B, -1)
    flat_live = (live0 & kept_slot[:, :, None]
                 & active[:, None, None]).reshape(B, -1)
    lens_b = jnp.broadcast_to(lens[:, None], (B, C * S))
    qb, qe, rb, re, eligible = seed_sw_windows(
        dbns, lens_b, qbeg, rbeg, slen)
    jobs = flat_live & eligible                    # [B, C*S]

    # compact jobs into [max_sw] SW lanes; reads whose jobs fell past
    # the budget are flagged for the overflow retry (their unscored
    # seeds are kept, never dropped — lossy only toward keeping more)
    flat = jobs.reshape(B * C * S)
    pidx, p_valid = compact_indices(flat, max_sw)
    rank = jnp.cumsum(flat.astype(jnp.int32)) - 1
    dropped = flat & (rank >= max_sw)
    overflow = jnp.any(dropped.reshape(B, C * S), axis=1)
    p_read = pidx // (C * S)
    take = lambda x: x.reshape(B * C * S)[pidx]
    p_qb, p_qe = take(qb.reshape(B, -1)), take(qe.reshape(B, -1))
    p_rb, p_re = take(rb.reshape(B, -1)), take(re.reshape(B, -1))
    p_qlen = jnp.where(p_valid, p_qe - p_qb, 0)
    p_tlen = jnp.where(p_valid, (p_re - p_rb).astype(jnp.int32), 0)

    QL = TL = MEM_SHORT_LEN
    L = codes.shape[1]
    qi = jnp.arange(QL, dtype=jnp.int32)[None, :]
    p_q = jnp.take_along_axis(
        codes[p_read], jnp.clip(p_qb[:, None] + qi, 0, L - 1), axis=1)
    from .occ import ref_byte
    ti = jnp.arange(TL, dtype=jnp.int64)[None, :]
    p_t = ref_byte(fmi.ref, p_rb[:, None] + ti, dbns.l_pac)

    scores = local_sw_score_batch(
        p_q.astype(jnp.int32), p_qlen, p_t, p_tlen,
        opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)

    # scatter scores back: default -1 (= "good enough, keep")
    sw_flat = jnp.full((B * C * S,), -1, jnp.int32).at[
        jnp.where(p_valid, pidx, B * C * S)].set(scores, mode="drop")
    sw = sw_flat.reshape(B, C, S)

    applied = (live0 & kept_slot[:, :, None] & active[:, None, None])
    drop = applied & (sw >= 0) & (sw < min_hsp[:, None, None])
    seed_live = live0 & ~drop
    # kept seeds take their SW score; unscored keepers take len*a
    new_score = jnp.where(sw < 0, ch.seed_len * opt.a, sw)
    seed_score = jnp.where(applied & ~drop, new_score, ch.seed_score)
    return seed_live, seed_score, overflow
