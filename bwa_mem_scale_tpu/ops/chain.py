"""Batched seed chaining + chain filtering on device.

Re-design of the reference's B-tree chaining (mem_chain_seeds,
src/bwamem.cpp:789-960) for lockstep execution: per read we keep a
sorted key array (chain anchor = first seed's rbeg) plus an unsorted
slot table holding the chain data, so B-tree lower-bound becomes a
searchsorted over [C] keys and insertion is a masked shift — no pointer
chasing. Seed lists are fixed-capacity appends in arrival order (the
reference's insertion order), so chain weights and the overlap filter
(mem_chain_flt, src/bwamem.cpp:528-646) see seeds exactly as the
reference does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceBns:
    """Contig metadata on device (bns_pos2rid / bns_intv2rid support)."""
    offsets: jax.Array      # int64 [n_seqs]
    is_alt: jax.Array       # bool [n_seqs]
    l_pac: int

    def tree_flatten(self):
        return (self.offsets, self.is_alt), (self.l_pac,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def from_host(cls, bns):
        return cls(offsets=jnp.asarray(bns.offsets),
                   is_alt=jnp.asarray(bns.is_alt),
                   l_pac=bns.l_pac)

    def depos(self, pos):
        is_rev = pos >= self.l_pac
        pos_f = jnp.where(is_rev, (self.l_pac << 1) - 1 - pos, pos)
        return pos_f, is_rev

    def pos2rid(self, pos_f):
        rid = (jnp.searchsorted(self.offsets, pos_f, side="right") - 1
               ).astype(jnp.int32)
        return jnp.where(pos_f >= self.l_pac, -1, rid)

    def intv2rid(self, rb, re):
        rid_b = self.pos2rid(self.depos(rb)[0])
        re1 = jnp.where(rb < re, re - 1, rb)
        rid_e = self.pos2rid(self.depos(re1)[0])
        rid = jnp.where(rid_b == rid_e, rid_b, -1)
        bridging = (rb < self.l_pac) & (re > self.l_pac)
        return jnp.where(bridging, -2, rid)


class Chains(NamedTuple):
    """Per-read chain set (slot-ordered data + key-sorted permutation)."""
    key: jax.Array        # [B, C] sorted anchor rbeg (invalid = +max)
    slot: jax.Array       # [B, C] data slot per sorted position
    n: jax.Array          # [B] number of chains
    rid: jax.Array        # [B, C] by slot
    n_seeds: jax.Array    # [B, C] by slot
    seed_qbeg: jax.Array  # [B, C, S]
    seed_rbeg: jax.Array  # [B, C, S]
    seed_len: jax.Array   # [B, C, S]
    seed_score: jax.Array # [B, C, S]
    overflow: jax.Array   # [B] any chain/seed capacity overflow


def chain_seeds_device(bns: DeviceBns, smems, rbeg, seed_idx, coord_valid,
                       *, w: int, max_chain_gap: int,
                       max_chains: int, max_seeds_per_chain: int) -> Chains:
    """Chain the SA-expanded seeds of a batch.

    smems: SmemBuf (sorted); rbeg/seed_idx/coord_valid: [B, C] from
    expand_and_lookup. Returns Chains.
    """
    B, NC = rbeg.shape
    C = max_chains
    S = max_seeds_per_chain
    pos_dtype = rbeg.dtype
    bidx = jnp.arange(B)
    BIG = jnp.asarray(np.iinfo(np.dtype(pos_dtype)).max // 4,
                      dtype=pos_dtype)

    # one-hot over the small SMEM axis instead of take_along_axis
    # ([B, NC] = 1M rows at bench shapes; see ops/occ._take_c)
    from .occ import _oh_take
    qbeg_all = _oh_take(smems.m, seed_idx)
    n_all = _oh_take(smems.n, seed_idx)
    slen_all = (n_all + 1 - qbeg_all)

    st = Chains(
        key=jnp.full((B, C), BIG, dtype=pos_dtype),
        slot=jnp.zeros((B, C), dtype=jnp.int32),
        n=jnp.zeros((B,), dtype=jnp.int32),
        rid=jnp.full((B, C), -1, dtype=jnp.int32),
        n_seeds=jnp.zeros((B, C), dtype=jnp.int32),
        seed_qbeg=jnp.zeros((B, C, S), dtype=jnp.int32),
        seed_rbeg=jnp.zeros((B, C, S), dtype=pos_dtype),
        seed_len=jnp.zeros((B, C, S), dtype=jnp.int32),
        seed_score=jnp.zeros((B, C, S), dtype=jnp.int32),
        overflow=jnp.zeros((B,), dtype=bool),
    )

    # every per-lane select/update below is one-hot over the small
    # C/S axes (see ops/occ._take_c): `arr[bidx, lslot]`-style indexed
    # reads/writes would be per-lane gathers and scatters; masked
    # one-hot selects are elementwise work. (A layout chosen for the
    # previous accelerator; not yet measured on the GPU.)
    iota_c = jnp.arange(C, dtype=jnp.int32)
    iota_s = jnp.arange(S, dtype=jnp.int32)

    def sel_c(arr, i):                       # arr [B, C] at i [B]
        return jnp.sum(jnp.where(iota_c[None, :] == i[:, None],
                                 arr, 0), axis=1, dtype=arr.dtype)

    def body(c, st):
        take = lambda x: jax.lax.dynamic_index_in_dim(
            x, c, axis=1, keepdims=False)
        valid = take(coord_valid)
        s_rbeg = take(rbeg)
        s_qbeg = take(qbeg_all)
        s_len = take(slen_all)
        rid = bns.intv2rid(s_rbeg, s_rbeg + s_len.astype(pos_dtype))
        valid = valid & (rid >= 0)

        # lower-bound chain: largest key <= rbeg
        pos = jnp.sum(st.key <= s_rbeg[:, None], axis=1).astype(jnp.int32)
        li = pos - 1
        has_lower = valid & (li >= 0)
        lslot = sel_c(st.slot, jnp.clip(li, 0, C - 1))

        # --- test_and_merge (src/bwamem.cpp:379-421) ---
        lsel = iota_c[None, :] == lslot[:, None]          # [B, C]
        ln = jnp.sum(jnp.where(lsel, st.n_seeds, 0), axis=1)
        last_i = jnp.clip(ln - 1, 0, S - 1)
        # the lower chain's seed row per field: [B, S]
        def lrow(arr):
            return jnp.sum(jnp.where(lsel[:, :, None], arr, 0),
                           axis=1, dtype=arr.dtype)
        row_qbeg = lrow(st.seed_qbeg)
        row_rbeg = lrow(st.seed_rbeg)
        row_len = lrow(st.seed_len)
        def at_s(row, i):
            return jnp.sum(jnp.where(iota_s[None, :] == i[:, None],
                                     row, 0), axis=1, dtype=row.dtype)
        last_qbeg = at_s(row_qbeg, last_i)
        last_rbeg = at_s(row_rbeg, last_i)
        last_len = at_s(row_len, last_i)
        first_qbeg = row_qbeg[:, 0]
        first_rbeg = row_rbeg[:, 0]
        qend = last_qbeg + last_len
        rend = last_rbeg + last_len.astype(pos_dtype)
        same_rid = rid == jnp.sum(jnp.where(lsel, st.rid, 0), axis=1)
        contained = (same_rid
                     & (s_qbeg >= first_qbeg) & (s_qbeg + s_len <= qend)
                     & (s_rbeg >= first_rbeg)
                     & (s_rbeg + s_len.astype(pos_dtype) <= rend))
        diff_strand = (((last_rbeg < bns.l_pac) | (first_rbeg < bns.l_pac))
                       & (s_rbeg >= bns.l_pac))
        x = (s_qbeg - last_qbeg).astype(pos_dtype)
        y = s_rbeg - last_rbeg
        growable = (same_rid & ~contained & ~diff_strand
                    & (y >= 0) & (x - y <= w) & (y - x <= w)
                    & (x - last_len < max_chain_gap)
                    & (y - last_len < max_chain_gap))
        grow = has_lower & growable
        merged = has_lower & (contained | growable)

        seed_of = grow & (ln >= S)
        do_app = grow & ~seed_of
        new = valid & ~merged
        chain_of = new & (st.n >= C)
        new_ok = new & ~chain_of
        nslot = st.n

        # ONE merged one-hot write per field: append at (lslot, ln)
        # or start a new chain at (nslot, 0) — mutually exclusive.
        do_w = do_app | new_ok
        wslot = jnp.where(do_app, lslot, nslot)
        wpos = jnp.where(do_app, ln, 0)
        wsel = (do_w[:, None, None]
                & (iota_c[None, :, None] == wslot[:, None, None])
                & (iota_s[None, None, :] == wpos[:, None, None]))
        def put(arr, v):
            return jnp.where(wsel, v[:, None, None].astype(arr.dtype),
                             arr)
        nsel = (new_ok[:, None]
                & (iota_c[None, :] == nslot[:, None]))
        st = st._replace(
            seed_qbeg=put(st.seed_qbeg, s_qbeg),
            seed_rbeg=put(st.seed_rbeg, s_rbeg),
            seed_len=put(st.seed_len, s_len),
            seed_score=put(st.seed_score, s_len),
            n_seeds=jnp.where(
                do_app[:, None] & (iota_c[None, :] == lslot[:, None]),
                st.n_seeds + 1,
                jnp.where(nsel, 1, st.n_seeds)),
            rid=jnp.where(nsel, rid[:, None], st.rid),
            overflow=st.overflow | seed_of | chain_of,
        )

        # sorted insert of (key, slot) at position `pos` (upper bound)
        ins = pos  # insert after all keys <= rbeg
        col = iota_c[None, :]
        shift = new_ok[:, None] & (col > ins[:, None]) & (col <= st.n[:, None])
        key_prev = jnp.concatenate([st.key[:, :1], st.key[:, :-1]],
                                   axis=1)
        slot_prev = jnp.concatenate([st.slot[:, :1], st.slot[:, :-1]],
                                    axis=1)
        key2 = jnp.where(shift, key_prev, st.key)
        slot2 = jnp.where(shift, slot_prev, st.slot)
        isel = new_ok[:, None] & (col == ins[:, None])
        key2 = jnp.where(isel, s_rbeg[:, None], key2)
        slot2 = jnp.where(isel, nslot[:, None], slot2)
        st = st._replace(key=key2, slot=slot2,
                         n=st.n + new_ok.astype(jnp.int32))
        return st

    # Only iterate to the longest coordinate list in the batch — the
    # [B, NC] buffers are sized for the worst case but typical reads
    # fill a small prefix.
    n_coord = jnp.max(jnp.sum(coord_valid.astype(jnp.int32), axis=1))

    def cond(cs):
        return cs[0] < n_coord

    def step(cs):
        c, st = cs
        return c + 1, body(c, st)

    _, st = jax.lax.while_loop(cond, step, (jnp.int32(0), st))
    return st


def frac_rep_device(smems, lens, max_occ: int):
    """Per-read repetitive fraction (mem_chain_seeds prologue,
    src/bwamem.cpp:836-846). smems must be (m, n)-sorted."""
    B, M = smems.m.shape
    valid = jnp.arange(M)[None, :] < smems.cnt[:, None]
    over = valid & (smems.s > max_occ)

    def body(i, carry):
        b, e, l_rep = carry
        sb = smems.m[:, i]
        se = smems.n[:, i] + 1
        act = over[:, i]
        new_seg = act & (sb > e)
        l_rep = jnp.where(new_seg, l_rep + (e - b), l_rep)
        b = jnp.where(new_seg, sb, b)
        e = jnp.where(act, jnp.where(new_seg, se, jnp.maximum(e, se)), e)
        return b, e, l_rep

    z = jnp.zeros((B,), dtype=jnp.int32)
    b, e, l_rep = jax.lax.fori_loop(0, M, body, (z, z, z))
    l_rep = l_rep + (e - b)
    return l_rep.astype(jnp.float32) / jnp.maximum(lens, 1).astype(jnp.float32)


def chain_weights(ch: Chains):
    """Per-chain weight (mem_chain_weight, src/bwamem.cpp:452-471).
    Returns [B, C] int32 by slot."""
    B, C, S = ch.seed_qbeg.shape
    svalid = jnp.arange(S)[None, None, :] < ch.n_seeds[:, :, None]

    def scan_axis(beg, length):
        def body(i, carry):
            end, wsum = carry
            b = beg[:, :, i]
            l = length[:, :, i].astype(b.dtype)
            act = svalid[:, :, i]
            add = jnp.where(
                b >= end, l,
                jnp.where(b + l > end, b + l - end, 0))
            wsum = wsum + jnp.where(act, add, 0)
            end = jnp.where(act, jnp.maximum(end, b + l), end)
            return end, wsum

        z = jnp.zeros((B, C), dtype=beg.dtype)
        _, wsum = jax.lax.fori_loop(0, S, body, (z, z))
        return wsum

    wq = scan_axis(ch.seed_qbeg.astype(jnp.int64), ch.seed_len)
    wr = scan_axis(ch.seed_rbeg.astype(jnp.int64), ch.seed_len)
    w = jnp.minimum(wq, wr)
    return jnp.minimum(w, (1 << 30) - 1).astype(jnp.int32)


def chain_filter_device(ch: Chains, bns: DeviceBns, *, min_chain_weight: int,
                        mask_level: float, max_chain_gap: int,
                        drop_ratio: float, min_seed_len: int,
                        max_chain_extend: int):
    """mem_chain_flt in lockstep. Returns (order [B, C] slot indices in
    weight-sorted kept order, kept_mask [B, C] by sorted position,
    weights [B, C] by slot)."""
    B, C, S = ch.seed_qbeg.shape
    bidx = jnp.arange(B)
    w_by_slot = chain_weights(ch)

    slot_valid = jnp.arange(C)[None, :] < ch.n[:, None]
    heavy = slot_valid & (w_by_slot >= min_chain_weight)
    # Sort by weight descending (invalid last) with a stable sort over
    # the chains in key (b-tree) order, as the oracle does: equal
    # weights — repeat copies — keep reference-position order, not
    # slot (creation) order. slot_k lists the slots in key order, the
    # unused slots after them, so it is a permutation of [0, C).
    sort_w = jnp.where(heavy, w_by_slot, -1)
    iota_c = jnp.arange(C, dtype=jnp.int32)
    slot_k = jnp.where(iota_c[None, :] < ch.n[:, None], ch.slot,
                       iota_c[None, :])
    ko = slot_k[:, :, None] == iota_c[None, None, :]   # [B, Ckey, Cslot]
    w_k = jnp.sum(jnp.where(ko, sort_w[:, None, :], 0), axis=2,
                  dtype=sort_w.dtype)
    ok = jnp.argsort(-w_k, axis=1, stable=True).astype(jnp.int32)
    order = jnp.sum(jnp.where(ok[:, :, None] == iota_c[None, None, :],
                              slot_k[:, None, :], 0), axis=2,
                    dtype=jnp.int32)
    n_valid = heavy.sum(axis=1).astype(jnp.int32)

    # apply the permutation one-hot instead of take_along_axis over
    # [B, C] (see ops/occ._take_c)
    po = order[:, :, None] == iota_c[None, None, :]    # [B, Cpos, Cslot]

    def by_pos(arr):                                   # [B, C] slot maj.
        return jnp.sum(jnp.where(po, arr[:, None, :], 0), axis=2,
                       dtype=arr.dtype)

    w_sorted = by_pos(sort_w)
    ns = by_pos(ch.n_seeds)
    last_i = jnp.clip(ns - 1, 0, S - 1)
    qbeg0 = by_pos(ch.seed_qbeg[:, :, 0])
    iota_s = jnp.arange(S, dtype=jnp.int32)
    lsel = (po[:, :, :, None]
            & (last_i[:, :, None, None] == iota_s[None, None, None, :]))
    lq = jnp.sum(jnp.where(lsel, ch.seed_qbeg[:, None], 0), axis=(2, 3),
                 dtype=ch.seed_qbeg.dtype)
    ll = jnp.sum(jnp.where(lsel, ch.seed_len[:, None], 0), axis=(2, 3),
                 dtype=ch.seed_len.dtype)
    qend = lq + ll
    rid_sorted = by_pos(ch.rid)
    n_alt = bns.is_alt.shape[0]
    alt_oh = (rid_sorted[:, :, None]
              == jnp.arange(n_alt, dtype=jnp.int32)[None, None, :])
    alt = jnp.any(alt_oh & bns.is_alt[None, None, :], axis=2)

    kept = jnp.zeros((B, C), dtype=jnp.int32)
    first = jnp.full((B, C), -1, dtype=jnp.int32)
    kept = kept.at[:, 0].set(jnp.where(n_valid > 0, 3, 0))
    col = jnp.arange(C)[None, :]

    def body(i, carry):
        kept, first = carry
        active = i < n_valid
        bi, ei = qbeg0[:, i], qend[:, i]
        li_len = ei - bi
        # significant overlaps against kept chains j < i (kept order ==
        # ascending sorted position, as in the reference's kept list)
        is_kept_j = (col < i) & (kept > 0)
        b_max = jnp.maximum(qbeg0, bi[:, None])
        e_min = jnp.minimum(qend, ei[:, None])
        alt_ok = (~alt) | alt[:, i][:, None]
        min_l = jnp.minimum(qend - qbeg0, li_len[:, None])
        signif = ((e_min > b_max) & alt_ok & is_kept_j
                  & ((e_min - b_max) >= min_l * mask_level)
                  & (min_l < max_chain_gap))
        # weight-drop break: the first significant j that dominates i
        dom = (signif
               & (w_sorted[:, i][:, None] < w_sorted * drop_ratio)
               & ((w_sorted - w_sorted[:, i][:, None])
                  >= (min_seed_len << 1)))
        drop = jnp.any(dom, axis=1)
        jbreak = jnp.where(drop, jnp.argmax(dom, axis=1), C)
        processed = col <= jbreak[:, None]
        large_ovlp = jnp.any(signif & processed, axis=1)
        # every processed significant j with first unset records i
        set_first = (signif & processed & (first < 0)
                     & active[:, None])
        first = jnp.where(set_first, i, first)
        keep_i = active & ~drop
        kept = jnp.where((col == i) & keep_i[:, None],
                         jnp.where(large_ovlp, 2, 3)[:, None], kept)
        return kept, first

    kept, first = jax.lax.fori_loop(1, C, body, (kept, first))
    # chains referenced by a kept chain's `first` get kept=1
    def body2(i, kept):
        f = jax.lax.dynamic_index_in_dim(first, i, axis=1,
                                         keepdims=False)
        do = (jax.lax.dynamic_index_in_dim(kept, i, axis=1,
                                           keepdims=False) > 0) & (f >= 0)
        return jnp.where((col == f[:, None]) & do[:, None], 1, kept)
    kept = jax.lax.fori_loop(0, C, body2, kept)

    # cap the number of kept==1/2 chains
    is12 = (kept == 1) | (kept == 2)
    rank12 = jnp.cumsum(is12.astype(jnp.int32), axis=1)
    over_cap = is12 & (rank12 >= max_chain_extend) & (kept < 3)
    kept = jnp.where(over_cap, 0, kept)
    return order, kept, w_by_slot
