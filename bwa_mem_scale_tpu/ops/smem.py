"""Batched SMEM search on device — position-parallel formulation.

The reference finds SMEMs per read with a sequential
forward-then-backward sweep per restart position
(getSMEMsAllPosOneThread, src/FMI_search.cpp:1372-1660). A lockstep
port of that control flow serializes thousands of tiny steps; instead
we use the structure of maximal exact matches:

  Let E(p) = exclusive end of the longest valid match starting at p
  (valid = every prefix interval has >= min_intv occurrences).
  E is monotone nondecreasing, so [p, E(p)) is left-maximal iff
  E(p-1) < E(p), and the SMEM set is exactly
      { (p, E(p)-1) : E(p-1) < E(p) or p = 0, E(p)-p >= min_seed_len }.

That makes pass 1 a *single* batched forward-extension sweep over all
(read, position) lanes at once — max-match-length lockstep steps, each
one fused occ gather over B*L lanes, no per-read control flow. The
re-seeding pass runs the same kernel over a compacted (read, midpoint,
min_intv) task list (covering matches = p <= x < E(p)), and the
third-pass seed strategy reuses the sweep's failure records plus an
O(L) pointer chase to replay its restart chain
(bwtSeedStrategyAllPosOneThread, src/FMI_search.cpp:1662-1815).

Outputs are bit-identical to the reference's matchArray after its
final (m, n) sort (verified against the oracle in tests).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .occ import DeviceFMIndex, backward_ext_all4


class SmemBuf(NamedTuple):
    """Per-read SMEM output buffers ([B, M] each) + counts [B]."""
    m: jax.Array
    n: jax.Array
    k: jax.Array
    l: jax.Array
    s: jax.Array
    cnt: jax.Array

    @classmethod
    def empty(cls, B: int, M: int, pos_dtype):
        zi = jnp.zeros((B, M), dtype=jnp.int32)
        zp = jnp.zeros((B, M), dtype=pos_dtype)
        return cls(zi, zi, zp, zp, zp, jnp.zeros((B,), dtype=jnp.int32))

    def emit(self, mask, m, n, k, l, s):
        """Masked append of one record per lane (used by pass 3)."""
        B, M = self.m.shape
        bidx = jnp.arange(B)
        idx = jnp.where(mask, self.cnt, M)
        return SmemBuf(
            self.m.at[bidx, idx].set(m, mode="drop"),
            self.n.at[bidx, idx].set(n, mode="drop"),
            self.k.at[bidx, idx].set(k, mode="drop"),
            self.l.at[bidx, idx].set(l, mode="drop"),
            self.s.at[bidx, idx].set(s, mode="drop"),
            self.cnt + mask.astype(jnp.int32),
        )

    def emit_rows(self, mask, rows, m, n, k, l, s):
        """Masked append with an explicit target row per lane (the
        lane-refill machines own one task/read per lane, so emitting
        lanes always target distinct rows — no scatter collisions)."""
        B, M = self.m.shape
        r = jnp.where(mask, rows, B)           # OOB rows drop
        idx = jnp.where(mask, self.cnt[jnp.clip(rows, 0, B - 1)], M)
        return SmemBuf(
            self.m.at[r, idx].set(m, mode="drop"),
            self.n.at[r, idx].set(n, mode="drop"),
            self.k.at[r, idx].set(k, mode="drop"),
            self.l.at[r, idx].set(l, mode="drop"),
            self.s.at[r, idx].set(s, mode="drop"),
            self.cnt.at[r].add(mask.astype(jnp.int32), mode="drop"),
        )


def compact_indices(flat, T: int):
    """Indices of the first T set lanes of the bool vector `flat`, in
    lane order — the O(n) cumsum+scatter equivalent of
    argsort(where(flat, idx, BIG))[:T] in one pass instead of a
    1M-lane sort. Returns (order [T] int32,
    valid [T] bool); order is 0 on invalid slots."""
    n = flat.shape[0]
    rank = jnp.cumsum(flat.astype(jnp.int32)) - 1
    tgt = jnp.where(flat, rank, T)          # OOB (>= T) lanes drop
    order = jnp.zeros((T,), jnp.int32).at[tgt].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")
    valid = jnp.arange(T, dtype=jnp.int32) < (rank[-1] + 1)
    return order, valid


def _fwd_ext4(fmi, k, l, s, a):
    """Forward extension by base a via the k/l swap
    (src/FMI_search.cpp:1477-1484); shape-polymorphic."""
    k4, l4, s4 = backward_ext_all4(fmi, l, k, s)
    ai = (3 - a)[..., None].astype(jnp.int32)
    take = lambda v: jnp.take_along_axis(v, ai, axis=-1)[..., 0]
    return take(l4), take(k4), take(s4)


def extend_all_positions(fmi: DeviceFMIndex, codes, lens, min_intv,
                         check_initial: bool, want_fail: bool,
                         stop_min_len: int = 0, fma=None,
                         p3_max_intv: int = 0, p3_stop: int = 0,
                         n_pos: int = 0):
    """Forward-extend from every start position of every read at once.

    codes [B, L] int32, lens [B], min_intv [B] (per read/task).
    check_initial: require the 1-bp interval itself to have >= min_intv
    occurrences (pass 1/2 semantics); pass 3 starts unconditionally.

    Returns dict with:
      E [B, L]      exclusive end of the longest valid match from p
      k/l/s [B, L]  bi-interval of [p, E(p))
      (if want_fail) fail_s / fail_k / fail_l / fail_ss [B, L]: whether
      the sweep retired on an interval-size failure at column E(p), and
      that failing interval (pass-3 seeds *include* the failing step).

    With p3_max_intv/p3_stop > 0 (requires check_initial and
    min_intv == 1), the pass-1 sweep additionally records the 3rd-pass
    seed-strategy failure point — the first step of length >= p3_stop
    whose interval drops below p3_max_intv — since both passes walk the
    identical (k, l, s) chain (the lanes pass 3 would zombie-walk past
    an s=0 death carry no recoverable interval and are reconstructed
    analytically in seed_strategy_merged). Adds f3_s/f3_E/f3_k/f3_l/
    f3_ss/died_s outputs and saves an entire sweep vs running
    bwtSeedStrategy separately.
    """
    B, L = codes.shape
    P = n_pos or L   # start columns; no emission can start past
                     # L - min_seed_len, so callers restrict the sweep
    pos_dtype = fmi.pos_dtype
    pcol = jnp.arange(P, dtype=jnp.int32)[None, :]
    mi = min_intv.astype(pos_dtype)[:, None]
    base_ok = (pcol < lens[:, None]) & (codes[:, :P] < 4)

    # FMA fast path: resolve the first K_eff steps from the ladder
    # table (ops/fma.py; the reference's smem-table short-cut,
    # src/FMI_search.cpp:1414-1463). K_eff must stay below the pass-3
    # stop length so no stop/fail can fire inside the window.
    merge_p3 = p3_max_intv > 0 and p3_stop > 0
    died_s = jnp.zeros((B, P), dtype=bool)
    K_eff = 0
    if fma is not None:
        K_eff = fma.K if stop_min_len <= 0 else min(fma.K,
                                                    stop_min_len - 1)
        if merge_p3:
            K_eff = min(K_eff, p3_stop - 1)
    if K_eff >= 2:
        from .fma import fast_forward
        E, k, l, s, active, ff_died = fast_forward(
            fmi, fma, codes, lens, mi, check_initial, K_eff, n_pos=P)
        if merge_p3:
            died_s = ff_died
        off = K_eff - 1
    else:
        K_eff = 0
        off = 0
        a0c = jnp.clip(codes[:, :P], 0, 3)
        k = fmi.count[a0c]
        l = fmi.count[3 - a0c]
        s = fmi.count[a0c + 1] - fmi.count[a0c]
        active = base_ok & (s >= mi) if check_initial else base_ok
        # Lanes whose single base is already invalid have no match.
        E = jnp.where(active, pcol + 1, pcol)
        k = jnp.where(active, k, 0)
        l = jnp.where(active, l, 0)
        s = jnp.where(active, s, 0)

    fail_s = jnp.zeros((B, P), dtype=bool)
    fail_k = jnp.zeros((B, P), dtype=pos_dtype)
    fail_l = jnp.zeros((B, P), dtype=pos_dtype)
    fail_ss = jnp.zeros((B, P), dtype=pos_dtype)
    f3_s = jnp.zeros((B, P), dtype=bool)
    f3_E = jnp.zeros((B, P), dtype=jnp.int32)
    f3_k = jnp.zeros((B, P), dtype=pos_dtype)
    f3_l = jnp.zeros((B, P), dtype=pos_dtype)
    f3_ss = jnp.zeros((B, P), dtype=pos_dtype)

    def cond(st):
        return jnp.any(st[0])

    # All lanes consume the same relative offset each step, so the
    # next-base fetch is one contiguous dynamic slice of a padded copy
    # (a per-lane gather here costs as much as the occ gather itself).
    codes_pad = jnp.pad(codes, ((0, 0), (0, L + 2)), constant_values=4)

    def body(st):
        (act, t, E, k, l, s, fs, fk, fl, fss, ds,
         f3s, f3E, f3k, f3l, f3v) = st
        j = pcol + off + t
        in_range = j < lens[:, None]
        a = jax.lax.dynamic_slice(codes_pad,
                                  (jnp.int32(0), jnp.int32(off) + t),
                                  (B, P))
        is_n = a >= 4
        do = act & in_range & ~is_n
        nk, nl, ns = _fwd_ext4(fmi, k, l, s, jnp.clip(a, 0, 3))
        sfail = do & (ns < mi)
        if stop_min_len > 0:
            # pass-3 rule: only stop once the seed is long enough
            # (bwtSeedStrategy's combined hit condition).
            sfail = sfail & ((j - pcol + 1) >= stop_min_len)
        keep = do & ~sfail
        # retire records: E stays at the last valid exclusive end, which
        # is j for all retirements (s-fail, N, or end-of-read at j).
        E = jnp.where(keep, j + 1, E)
        k = jnp.where(keep, nk, k)
        l = jnp.where(keep, nl, l)
        s = jnp.where(keep, ns, s)
        if want_fail:
            fs = jnp.where(sfail, True, fs)
            fk = jnp.where(sfail, nk, fk)
            fl = jnp.where(sfail, nl, fl)
            fss = jnp.where(sfail, ns, fss)
        if merge_p3:
            ds = ds | sfail
            fire = (do & ~f3s & (ns < p3_max_intv)
                    & ((off + t + 1) >= p3_stop))
            f3s = f3s | fire
            f3E = jnp.where(fire, j, f3E)
            f3k = jnp.where(fire, nk, f3k)
            f3l = jnp.where(fire, nl, f3l)
            f3v = jnp.where(fire, ns, f3v)
        return (keep, t + 1, E, k, l, s, fs, fk, fl, fss, ds,
                f3s, f3E, f3k, f3l, f3v)

    def body2(st):
        # 2-step variant: one fused bigram-row gather extends every
        # lane by TWO bases (ops/occ.backward_ext2; table from
        # index/kstep.py). Lanes whose walk ends mid-stride retire
        # with the embedded single-step result — all boundary
        # bookkeeping (fail records, pass-3 fire, died flags) is
        # evaluated at both depths, so outputs are bit-identical to
        # the 1-step body (tests/test_kstep.py).
        (act, t, E, k, l, s, fs, fk, fl, fss, ds,
         f3s, f3E, f3k, f3l, f3v) = st
        j = pcol + off + t
        a = jax.lax.dynamic_slice(codes_pad,
                                  (jnp.int32(0), jnp.int32(off) + t),
                                  (B, P))
        b = jax.lax.dynamic_slice(
            codes_pad, (jnp.int32(0), jnp.int32(off) + t + 1), (B, P))
        do1 = act & (j < lens[:, None]) & (a < 4)
        from .occ import forward_ext2
        (k1, l1, s1), (k2, l2, s2) = forward_ext2(
            fmi, k, l, s, jnp.clip(a, 0, 3), jnp.clip(b, 0, 3))
        sfail1 = do1 & (s1 < mi)
        if stop_min_len > 0:
            sfail1 = sfail1 & ((j - pcol + 1) >= stop_min_len)
        keep1 = do1 & ~sfail1
        do2 = keep1 & ((j + 1) < lens[:, None]) & (b < 4)
        sfail2 = do2 & (s2 < mi)
        if stop_min_len > 0:
            sfail2 = sfail2 & ((j - pcol + 2) >= stop_min_len)
        keep2 = do2 & ~sfail2

        E = jnp.where(keep2, j + 2, jnp.where(keep1, j + 1, E))
        k = jnp.where(keep2, k2, jnp.where(keep1, k1, k))
        l = jnp.where(keep2, l2, jnp.where(keep1, l1, l))
        s = jnp.where(keep2, s2, jnp.where(keep1, s1, s))
        if want_fail:
            hit = sfail1 | sfail2
            fs = fs | hit
            fk = jnp.where(sfail1, k1, jnp.where(sfail2, k2, fk))
            fl = jnp.where(sfail1, l1, jnp.where(sfail2, l2, fl))
            fss = jnp.where(sfail1, s1, jnp.where(sfail2, s2, fss))
        if merge_p3:
            ds = ds | sfail1 | sfail2
            fire1 = (do1 & ~f3s & (s1 < p3_max_intv)
                     & ((off + t + 1) >= p3_stop))
            fire2 = (do2 & ~(f3s | fire1) & (s2 < p3_max_intv)
                     & ((off + t + 2) >= p3_stop))
            f3s = f3s | fire1 | fire2
            f3E = jnp.where(fire1, j, jnp.where(fire2, j + 1, f3E))
            f3k = jnp.where(fire1, k1, jnp.where(fire2, k2, f3k))
            f3l = jnp.where(fire1, l1, jnp.where(fire2, l2, f3l))
            f3v = jnp.where(fire1, s1, jnp.where(fire2, s2, f3v))
        return (keep2, t + 2, E, k, l, s, fs, fk, fl, fss, ds,
                f3s, f3E, f3k, f3l, f3v)

    st = (active, jnp.int32(1), E, k, l, s, fail_s, fail_k, fail_l,
          fail_ss, died_s, f3_s, f3_E, f3_k, f3_l, f3_ss)
    use2 = getattr(fmi, "cp2_fused", None) is not None
    (_, _, E, k, l, s, fail_s, fail_k, fail_l, fail_ss, died_s,
     f3_s, f3_E, f3_k, f3_l, f3_ss) = \
        jax.lax.while_loop(cond, body2 if use2 else body, st)
    out = dict(E=E, k=k, l=l, s=s, valid=base_ok)
    if want_fail:
        out.update(fail_s=fail_s, fail_k=fail_k, fail_l=fail_l,
                   fail_ss=fail_ss)
    if merge_p3:
        out.update(f3_s=f3_s, f3_E=f3_E, f3_k=f3_k, f3_l=f3_l,
                   f3_ss=f3_ss, died_s=died_s)
    return out


def _emit_compact(mask, cols_m, cols_n, k, l, s, out: SmemBuf,
                  rows=None):
    """Scatter all masked lane records into per-read slots at once.

    mask/values [B, L] (or [T, L] with rows = task->read). Slot index =
    running count + within-row rank, in column order.
    """
    B, M = out.m.shape
    T, L = mask.shape
    rank = jnp.cumsum(mask.astype(jnp.int32), axis=1) - 1
    if rows is None:
        row_idx = jnp.arange(T)[:, None] * jnp.ones((1, L), jnp.int32)
        base = out.cnt[:, None]
        counts_add = mask.sum(axis=1).astype(jnp.int32)
        new_cnt = out.cnt + counts_add
    else:
        # Tasks are sorted by read; give each task a base offset equal
        # to the emissions of earlier tasks of the same read.
        row_idx = rows[:, None] * jnp.ones((1, L), jnp.int32)
        counts_t = mask.sum(axis=1).astype(jnp.int32)
        csum_ex = jnp.cumsum(counts_t) - counts_t
        first_csum = jnp.full((B,), jnp.int32(1 << 30)).at[rows].min(
            csum_ex)
        base = (out.cnt[rows] + csum_ex - first_csum[rows])[:, None]
        counts_add = jnp.zeros((B,), jnp.int32).at[rows].add(counts_t)
        new_cnt = out.cnt + counts_add
    col = jnp.where(mask, base + rank, M)
    col = jnp.minimum(col, M)  # overflow rows drop
    return SmemBuf(
        out.m.at[row_idx, col].set(cols_m, mode="drop"),
        out.n.at[row_idx, col].set(cols_n, mode="drop"),
        out.k.at[row_idx, col].set(k, mode="drop"),
        out.l.at[row_idx, col].set(l, mode="drop"),
        out.s.at[row_idx, col].set(s, mode="drop"),
        new_cnt,
    )


def smems_all_pos(fmi: DeviceFMIndex, codes, lens, min_intv,
                  min_seed_len: int, max_out: int, fma=None) -> SmemBuf:
    """Pass 1: all SMEMs of every read, in one parallel sweep."""
    B, L = codes.shape
    ext = extend_all_positions(fmi, codes, lens, min_intv,
                               check_initial=True, want_fail=False,
                               fma=fma)
    E = ext["E"]
    pcol = jnp.arange(L, dtype=jnp.int32)[None, :]
    E_prev = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), E[:, :-1]], axis=1)
    left_max = (pcol == 0) | (E_prev < E)
    mask = left_max & ((E - pcol) >= min_seed_len)
    out = SmemBuf.empty(B, max_out, fmi.pos_dtype)
    return _emit_compact(mask, pcol * jnp.ones((B, 1), jnp.int32),
                         E - 1, ext["k"], ext["l"], ext["s"], out)


def smems_reseed(fmi: DeviceFMIndex, codes, lens, pass1: SmemBuf,
                 split_len: int, split_width: int, min_seed_len: int,
                 max_out: int, max_tasks: int = 0, fma=None,
                 n_pos: int = 0):
    """Pass 2: re-seed at midpoints of long low-occ pass-1 SMEMs.

    Each qualifying SMEM becomes a (read, x, min_intv=s+1) task; tasks
    are compacted across the batch and run through the same parallel
    sweep, emitting the valid-maximal matches covering x.
    """
    B, L = codes.shape
    M1 = pass1.m.shape[1]
    # ~1.5 reseed candidates/read is typical at 1-3% error; 2 per
    # read keeps drops (and the resulting overflow retries) rare
    T = max_tasks or 2 * B
    valid = jnp.arange(M1)[None, :] < pass1.cnt[:, None]
    cand = (valid
            & ((pass1.n + 1 - pass1.m) >= split_len)
            & (pass1.s <= split_width))
    flat = cand.reshape(B * M1)
    order, t_valid = compact_indices(flat, T)
    # per-read: did the task budget T drop any of THIS read's reseed
    # tasks? (consumed by the collectors: affected reads get their
    # SMEM count saturated so the overflow-retry machinery re-runs
    # them at larger shapes — work is never silently dropped,
    # src/bwamem.cpp:740-763 reseeds unconditionally)
    rank = jnp.cumsum(flat, dtype=jnp.int32) - 1
    dropped = flat & (rank >= T)
    overflow = jnp.any(dropped.reshape(B, M1), axis=1)
    t_read = (order // M1).astype(jnp.int32)
    t_slot = order % M1
    t_m = pass1.m[t_read, t_slot]
    t_n = pass1.n[t_read, t_slot]
    t_s = pass1.s[t_read, t_slot]
    t_x = ((t_n + 1 + t_m) >> 1).astype(jnp.int32)
    t_min_intv = jnp.where(t_valid, t_s + 1, jnp.asarray(1, t_s.dtype))

    codes_t = jnp.where(t_valid[:, None], codes[t_read],
                        jnp.int32(4))
    lens_t = jnp.where(t_valid, lens[t_read], 0)

    P = n_pos or L
    ext = extend_all_positions(fmi, codes_t, lens_t,
                               t_min_intv.astype(jnp.int32),
                               check_initial=True, want_fail=False,
                               fma=fma, n_pos=P)
    E = ext["E"]
    pcol = jnp.arange(P, dtype=jnp.int32)[None, :]
    E_prev = jnp.concatenate(
        [jnp.zeros((T, 1), jnp.int32), E[:, :-1]], axis=1)
    left_max = (pcol == 0) | (E_prev < E)
    mask = (t_valid[:, None] & left_max
            & (pcol <= t_x[:, None]) & (E > t_x[:, None])
            & ((E - pcol) >= min_seed_len))
    out = SmemBuf.empty(B, max_out, fmi.pos_dtype)
    out = _emit_compact(mask, pcol * jnp.ones((T, 1), jnp.int32),
                        E - 1, ext["k"], ext["l"], ext["s"], out,
                        rows=t_read)
    return out, overflow


def smems_seed_strategy(fmi: DeviceFMIndex, codes, lens, max_intv: int,
                        min_seed_len: int, max_out: int,
                        fma=None) -> SmemBuf:
    """Pass 3: restart-chain seed strategy. The per-position sweep
    precomputes every start's outcome; an O(L) chase replays the
    reference's next_x chain (bwtSeedStrategyAllPosOneThread)."""
    B, L = codes.shape
    mi = jnp.full((B,), max_intv, dtype=jnp.int32)
    ext = extend_all_positions(fmi, codes, lens, mi,
                               check_initial=False, want_fail=True,
                               stop_min_len=min_seed_len, fma=fma)
    E = ext["E"]
    pcol = jnp.arange(L, dtype=jnp.int32)[None, :]
    in_read = pcol < lens[:, None]
    start_ok = in_read & (codes < 4)
    # Emission at the failing step j = E(p): seed [p, E(p)] inclusive.
    emit = (start_ok & ext["fail_s"] & (ext["fail_ss"] > 0)
            & ((E - pcol + 1) >= min_seed_len))
    # next_x chain: s-fail or N-stop at j -> j + 1; end-of-read -> len;
    # invalid start -> p + 1.
    hit_n = start_ok & ~ext["fail_s"] & (E < lens[:, None])
    nxt = jnp.where(start_ok & (ext["fail_s"] | hit_n), E + 1,
                    jnp.where(start_ok, lens[:, None], pcol + 1))
    nxt = jnp.maximum(nxt, pcol + 1)

    out = SmemBuf.empty(B, max_out, fmi.pos_dtype)
    bidx = jnp.arange(B)

    def body(t, st):
        pos, out = st
        act = pos < lens
        pc = jnp.minimum(pos, L - 1)
        em = act & emit[bidx, pc]
        out = out.emit(em, pos, E[bidx, pc],
                       ext["fail_k"][bidx, pc],
                       ext["fail_l"][bidx, pc],
                       ext["fail_ss"][bidx, pc])
        pos = jnp.where(act, nxt[bidx, pc], pos)
        return pos, out

    pos0 = jnp.zeros((B,), dtype=jnp.int32)
    _, out = jax.lax.fori_loop(0, L, body, (pos0, out))
    return out


def smems_seed_strategy_merged(fmi: DeviceFMIndex, codes, lens, ext,
                               max_intv: int, stop_min_len: int,
                               max_out: int, n_pos: int = 0) -> SmemBuf:
    """Pass 3 reconstructed from the pass-1 sweep's merged f3 records
    (see extend_all_positions). Lanes whose chain died at s=0 before
    reaching stop_min_len are zombie-walked analytically: pass 3 keeps
    stepping with an empty interval until the stop length, an N, or
    the read end — none of which can emit a seed."""
    B, L = codes.shape
    P = n_pos or L
    pcol = jnp.arange(P, dtype=jnp.int32)[None, :]
    in_read = pcol < lens[:, None]
    base_ok = in_read & (codes[:, :P] < 4)

    # first invalid offset at/after p: limit = that index - p
    # (scanned over the FULL read, then restricted to start columns)
    iota = jnp.arange(L, dtype=jnp.int32)[None, :]
    inv = (codes >= 4) | (iota >= lens[:, None])
    first_inv = jax.lax.cummin(jnp.where(inv, iota, L), axis=1,
                               reverse=True)[:, :P]
    limit = first_inv - pcol                       # [B, P] >= 0

    a0c = jnp.clip(codes[:, :P], 0, 3)
    s1 = fmi.count[a0c + 1] - fmi.count[a0c]
    died = ext["died_s"] | (base_ok & (s1 == 0))
    f3 = ext["f3_s"]
    zombie = base_ok & died & ~f3
    zfail = zombie & (stop_min_len <= limit)
    E3 = jnp.where(f3, ext["f3_E"],
                   jnp.where(zfail, pcol + stop_min_len - 1,
                             jnp.where(zombie, pcol + limit,
                                       ext["E"])))
    emit_col = base_ok & f3 & (ext["f3_ss"] > 0)
    fail3 = f3 | zfail
    hit_n = base_ok & ~fail3 & (E3 < lens[:, None])
    nxt = jnp.where(base_ok & (fail3 | hit_n), E3 + 1,
                    jnp.where(base_ok, lens[:, None], pcol + 1))
    nxt = jnp.maximum(nxt, pcol + 1)

    out = SmemBuf.empty(B, max_out, fmi.pos_dtype)
    bidx = jnp.arange(B)

    # the chase can stop once past the last possible start column
    def cond(st):
        return jnp.any((st[0] < lens) & (st[0] < P))

    def body(st):
        pos, out = st
        act = (pos < lens) & (pos < P)
        pc = jnp.minimum(pos, P - 1)
        em = act & emit_col[bidx, pc]
        out = out.emit(em, pos, E3[bidx, pc],
                       ext["f3_k"][bidx, pc],
                       ext["f3_l"][bidx, pc],
                       ext["f3_ss"][bidx, pc])
        pos = jnp.where(act, nxt[bidx, pc], pos)
        return pos, out

    pos0 = jnp.zeros((B,), dtype=jnp.int32)
    _, out = jax.lax.while_loop(cond, body, (pos0, out))
    return out


def concat_smems(*bufs: SmemBuf) -> SmemBuf:
    return SmemBuf(
        jnp.concatenate([b.m for b in bufs], axis=1),
        jnp.concatenate([b.n for b in bufs], axis=1),
        jnp.concatenate([b.k for b in bufs], axis=1),
        jnp.concatenate([b.l for b in bufs], axis=1),
        jnp.concatenate([b.s for b in bufs], axis=1),
        sum(b.cnt for b in bufs),
    )


def collect_smems_device(fmi: DeviceFMIndex, codes, lens, *,
                         min_seed_len: int, split_len: int,
                         split_width: int, max_mem_intv: int,
                         max_out: int = None, fma=None):
    """All three seeding passes + final (m, n) sort
    (mem_collect_smem, src/bwamem.cpp:648-795). Pass 1 and pass 3
    share a single sweep (merged f3 records); only the re-seed pass
    runs its own sweep over the compacted task list."""
    B, L = codes.shape
    M = max_out or L
    # no SMEM can start past L - min_seed_len: skip those sweep lanes
    P = int(np.clip(L - min_seed_len + 1, 1, L))
    ones = jnp.ones((B,), dtype=jnp.int32)
    merge = max_mem_intv > 0
    ext = extend_all_positions(
        fmi, codes, lens, ones, check_initial=True, want_fail=False,
        fma=fma,
        p3_max_intv=max_mem_intv if merge else 0,
        p3_stop=(min_seed_len + 1) if merge else 0, n_pos=P)
    # pass-1 emission from the shared sweep
    E = ext["E"]
    pcol = jnp.arange(P, dtype=jnp.int32)[None, :]
    E_prev = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), E[:, :-1]], axis=1)
    left_max = (pcol == 0) | (E_prev < E)
    mask = left_max & ((E - pcol) >= min_seed_len)
    p1 = _emit_compact(mask, pcol * jnp.ones((B, 1), jnp.int32),
                       E - 1, ext["k"], ext["l"], ext["s"],
                       SmemBuf.empty(B, M, fmi.pos_dtype))
    p2, reseed_of = smems_reseed(fmi, codes, lens, p1, split_len,
                                 split_width, min_seed_len, M, fma=fma,
                                 n_pos=P)
    parts = [p1, p2]
    if merge:
        parts.append(smems_seed_strategy_merged(
            fmi, codes, lens, ext, max_mem_intv, min_seed_len + 1, M,
            n_pos=P))
    combined = concat_smems(*parts)
    valid = jnp.concatenate(
        [jnp.arange(b.m.shape[1])[None, :] < b.cnt[:, None]
         for b in parts], axis=1)
    # int32 key: m, n < 2^15 for any supported read length
    key = (combined.m << 16) | combined.n
    key = jnp.where(valid, key, jnp.int32(2 ** 30))
    order = jnp.argsort(key, axis=1)
    take = lambda arr: jnp.take_along_axis(arr, order, axis=1)
    # reseed-task overflow -> saturate the count: the aligner's
    # smem_of check flags the read for the larger-shape retry
    cnt = jnp.where(reseed_of, combined.m.shape[1], combined.cnt)
    return SmemBuf(take(combined.m), take(combined.n), take(combined.k),
                   take(combined.l), take(combined.s), cnt)
