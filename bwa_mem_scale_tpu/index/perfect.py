"""EMF — Exact Match Filter ("perfect match") table: build + host side.

The reference hashes every genome window of `seed_len` bp under a
canonical min(fw, rc) key into an open-addressed table whose entries
hold only *locations* (matching is done by comparing the read against
the reference bytes at the candidate location), with per-key
multi-location lists split into fw/rc sub-lists
(src/perfect.h:93-186, builder src/perfect_index.cpp:1317-1437,
probe src/perfect_map.cpp:583-629).

Device formulation: the table is four flat arrays (location,
32-bit hash fingerprint, canonical-orientation bit, location count)
under linear probing, so the device lookup is a handful of row
gathers + one reference-window compare per read (ops/emf.py).
Multi-location lists live host-side (they are only consulted for the
rare multi-hit reads when composing extra SAM records / PE regions).

Construction is vectorized NumPy over all genome positions: canonical
packing, 64-bit mixing, identical-seed grouping via lexicographic row
sort, and round-based vectorized linear-probe insertion (each round,
every still-unplaced group attempts its next probe slot; first
claimant in scan order wins — equivalent to sequential insertion in
position order, matching the reference's first-location-wins entry
layout, src/perfect_index.cpp:1166).

Deviation from the reference (documented): windows crossing contig
boundaries are excluded (the reference hashes the raw concatenated
pac and can emit positions that overrun a contig).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

DEFAULT_SEED_LEN = 151
_M1 = np.uint64(0xFF51AFD7ED558CCD)
_M2 = np.uint64(0xC4CEB9FE1A85EC53)
_MG = np.uint64(0x9E3779B97F4A7C15)


def fmix64(k: np.ndarray) -> np.ndarray:
    """MurmurHash3 finalizer (public domain), same constants as the
    reference (src/perfect.h:497-510)."""
    k = k.astype(np.uint64, copy=True)
    k ^= k >> np.uint64(33)
    k *= _M1
    k ^= k >> np.uint64(33)
    k *= _M2
    k ^= k >> np.uint64(33)
    return k


def pack_words(win: np.ndarray) -> np.ndarray:
    """Pack base codes [N, S] (values 0..3) into big-endian 2-bit words
    [N, ceil(S/32)] uint64."""
    N, S = win.shape
    W = (S + 31) // 32
    padded = np.zeros((N, W * 32), dtype=np.uint64)
    padded[:, :S] = win
    shifts = np.uint64(2) * (np.uint64(31) - np.arange(32, dtype=np.uint64))
    return (padded.reshape(N, W, 32) << shifts[None, None, :]).sum(
        axis=2, dtype=np.uint64)


def hash_words(words: np.ndarray, seed_len: int) -> np.ndarray:
    """Chained word mix; must match ops/emf.py bit for bit."""
    h = np.full(words.shape[0], np.uint64(seed_len), dtype=np.uint64)
    for j in range(words.shape[1]):
        h = fmix64((h ^ words[:, j]) * _MG)
    return h


@dataclasses.dataclass
class PerfectTable:
    """Host EMF artifact (the reference's .perfect.<seed_len> file)."""

    seed_len: int
    l_pac: int
    max_probe: int
    loc: np.ndarray       # int64 [ncap]; -1 = empty slot
    fp: np.ndarray        # uint32 [ncap] hash fingerprint (h >> 32)
    fwless: np.ndarray    # uint8 [ncap] canonical orientation at loc
    cnt: np.ndarray       # int32 [ncap] total locations of this seed
    mlidx: np.ndarray     # int32 [ncap]; -1 = single location
    ml_off: np.ndarray    # int64 [nml + 1] offsets into ml_locs
    ml_nfw: np.ndarray    # int32 [nml] fw-sublist length
    ml_locs: np.ndarray   # int64 [total] fw locs asc, then rc locs asc

    @property
    def ncap(self) -> int:
        return len(self.loc)

    def locations(self, slot: int):
        """(fw_locs, rc_locs) of the entry at `slot`, relative to the
        entry's canonical orientation; the entry's own location is a
        member of fw_locs."""
        if self.mlidx[slot] < 0:
            return np.array([self.loc[slot]], dtype=np.int64), \
                np.empty(0, dtype=np.int64)
        m = int(self.mlidx[slot])
        lo, hi = int(self.ml_off[m]), int(self.ml_off[m + 1])
        nfw = int(self.ml_nfw[m])
        return self.ml_locs[lo: lo + nfw], self.ml_locs[lo + nfw: hi]


def _group_canonical(seq, win, pos, S: int):
    """(fwless, hash, group id, n_groups) per window; native grouper
    (native/emf.cpp) when available, vectorized NumPy otherwise."""
    import subprocess
    try:
        from . import native_emf
        return native_emf.group_windows(seq, pos, S)
    except (ImportError, OSError, AttributeError,
            subprocess.CalledProcessError):
        pass  # fall back to the NumPy path (rep/cnt computed below)
    W = (S + 31) // 32
    P = len(pos)
    canon = np.empty((P, W), dtype=np.uint64)
    fwless = np.empty(P, dtype=bool)
    CH = 1 << 18
    for lo in range(0, P, CH):
        hi = min(lo + CH, P)
        w = win[pos[lo:hi]]
        fw_words = pack_words(w)
        rc_words = pack_words((3 - w[:, ::-1]).astype(np.uint8))
        fl = np.ones(hi - lo, dtype=bool)
        decided = np.zeros(hi - lo, dtype=bool)
        for j in range(W):
            d = ~decided & (fw_words[:, j] != rc_words[:, j])
            fl[d] = fw_words[d, j] < rc_words[d, j]
            decided |= d
        fwless[lo:hi] = fl
        canon[lo:hi] = np.where(fl[:, None], fw_words, rc_words)
    order = np.lexsort(tuple(canon[:, j] for j in range(W - 1, -1, -1)))
    cs = canon[order]
    new_grp = np.ones(P, dtype=bool)
    if P > 1:
        new_grp[1:] = (cs[1:] != cs[:-1]).any(axis=1)
    gid_sorted = np.cumsum(new_grp) - 1
    gid = np.empty(P, dtype=np.int64)
    gid[order] = gid_sorted
    n_grp = int(gid_sorted[-1]) + 1 if P else 0
    rep = np.full(n_grp, np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(rep, gid, pos)
    cnt = np.bincount(gid, minlength=n_grp)
    return fwless, hash_words(canon, S), gid, n_grp, rep, cnt


def build_perfect_table(idx, seed_len: int = DEFAULT_SEED_LEN,
                        slack: float = 1.6) -> PerfectTable:
    """Vectorized builder over every in-contig genome window.

    (The reference builds with a pthread producer/consumer pipeline,
    src/perfect_index.cpp:1317-1437; vectorized NumPy covers
    bacterial-scale genomes in seconds — genome-scale builds should go
    through the same math in native code or on device, chunked.)
    """
    S = seed_len
    bns = idx.bns
    seq = np.asarray(idx.ref_string[: bns.l_pac], dtype=np.uint8)
    if bns.l_pac < S:
        raise ValueError("genome shorter than seed_len")

    win = np.lib.stride_tricks.sliding_window_view(seq, S)  # [P, S]
    npos = win.shape[0]
    # exclude windows that cross a contig boundary (per-contig slice
    # writes — a genome-length searchsorted measured 100+ s at 46 Mbp)
    ok = np.zeros(npos, dtype=bool)
    for a in bns.anns:
        if a.length >= S:
            ok[a.offset: a.offset + a.length - S + 1] = True
    pos = np.flatnonzero(ok).astype(np.int64)

    (fwless, h_all, gid, n_grp, rep,
     grp_cnt64) = _group_canonical(seq, win, pos, S)
    grp_cnt = grp_cnt64.astype(np.int32)
    # entry orientation/hash from the representative location
    grp_h = np.zeros(n_grp, dtype=np.uint64)
    grp_h[gid] = h_all                     # all members share the hash
    # rep holds POSITIONS drawn from pos; map back to indices with a
    # direct inverse array instead of a 46M-in-46M binary search
    inv = np.zeros(npos, dtype=np.int64)
    inv[pos] = np.arange(len(pos), dtype=np.int64)
    rep_idx = inv[rep]
    rep_fwless = fwless[rep_idx].astype(np.uint8)

    # linear-probe insertion (native sequential insert when built,
    # else round-vectorized NumPy; both layouts satisfy the
    # probe-until-empty lookup invariant)
    ncap = 1 << max(4, int(np.ceil(np.log2(max(n_grp, 1) * slack))))
    mask = np.uint64(ncap - 1)
    tab = np.full(ncap, -1, dtype=np.int64)      # group id per slot
    max_probe = 1
    try:
        from . import native_emf
        max_probe = native_emf.insert_table(grp_h, ncap, tab)
    except (ImportError, OSError, AttributeError):
        remaining = np.arange(n_grp, dtype=np.int64)
        r = np.uint64(0)
        while len(remaining):
            s = ((grp_h[remaining] + r) & mask).astype(np.int64)
            empty = tab[s] < 0
            uniq, first = np.unique(s, return_index=True)
            claim = np.zeros(len(s), dtype=bool)
            claim[first] = True
            winr = empty & claim
            tab[s[winr]] = remaining[winr]
            remaining = remaining[~winr]
            r += np.uint64(1)
            max_probe = max(max_probe, int(r))

    filled = tab >= 0
    g = tab[filled]
    loc = np.full(ncap, -1, dtype=np.int64)
    loc[filled] = rep[g]
    fp = np.zeros(ncap, dtype=np.uint32)
    fp[filled] = (grp_h[g] >> np.uint64(32)).astype(np.uint32)
    out_fwless = np.zeros(ncap, dtype=np.uint8)
    out_fwless[filled] = rep_fwless[g]
    cnt = np.zeros(ncap, dtype=np.int32)
    cnt[filled] = grp_cnt[g]

    # multi-location lists (fw = same orientation as the entry)
    multi = grp_cnt > 1
    nml = int(multi.sum())
    ml_id = np.full(n_grp, -1, dtype=np.int64)
    ml_id[multi] = np.arange(nml)
    mlidx = np.full(ncap, -1, dtype=np.int32)
    mlidx[filled] = ml_id[g]
    ml_nfw = np.zeros(nml, dtype=np.int32)
    ml_off = np.zeros(nml + 1, dtype=np.int64)
    ml_locs = np.empty(0, dtype=np.int64)
    if nml:
        in_multi = multi[gid]
        mg = ml_id[gid[in_multi]]
        mpos = pos[in_multi]
        same_ori = fwless[in_multi] == rep_fwless[gid[in_multi]]
        # order: (group, rc-sublist flag, position)
        o = np.lexsort((mpos, ~same_ori, mg))
        ml_locs = mpos[o]
        per = np.bincount(mg, minlength=nml).astype(np.int64)
        ml_off[1:] = np.cumsum(per)
        np.add.at(ml_nfw, mg[same_ori], 1)

    return PerfectTable(seed_len=S, l_pac=bns.l_pac,
                        max_probe=max_probe, loc=loc, fp=fp,
                        fwless=out_fwless, cnt=cnt, mlidx=mlidx,
                        ml_off=ml_off, ml_nfw=ml_nfw, ml_locs=ml_locs)


def build_perfect_table_chunked(idx, seed_len: int = DEFAULT_SEED_LEN,
                                slack: float = 1.6,
                                chunk: int = 48 << 20,
                                budget_bytes: Optional[int] = None,
                                log=None) -> PerfectTable:
    """Genome-scale EMF build: stream position chunks through the
    native grouper + streaming table insert (native/emf.cpp
    emf_insert_chunk), never materializing all windows at once — the
    counterpart of the reference's producer/consumer builder
    (src/perfect_index.cpp:1317-1437).

    `budget_bytes` caps the table (the MEMSCALE partial-EMF analogue,
    src/bwa_shm.cpp:1585-1770): when set, the slot count shrinks to
    fit and only the earliest-genome-position seeds get entries;
    later seeds miss the filter and take the normal seeding path
    (output-identical, just less accelerated).

    Bit-compatible with build_perfect_table's lookup contract (same
    PerfectTable layout); slot assignment differs (position-order
    chunked insertion vs hash-order one-shot) but lookups only rely
    on the probe-until-empty invariant.
    """
    from . import native_emf

    S = seed_len
    bns = idx.bns
    seq = np.ascontiguousarray(idx.ref_string[: bns.l_pac],
                               dtype=np.uint8)
    if bns.l_pac < S:
        raise ValueError("genome shorter than seed_len")
    say = log or (lambda *_: None)

    npos = sum(max(a.length - S + 1, 0) for a in bns.anns)
    cap = 1 << max(4, int(np.ceil(np.log2(max(npos, 1) * slack))))
    if budget_bytes is not None:
        # resident bytes/slot: loc 8 + fp 4 + cnt 4 + fwless 1 +
        # mlidx 4 = 21
        max_cap = max(1 << 10, int(budget_bytes) // 21)
        while cap > max_cap:
            cap >>= 1
    budget_entries = int(cap / slack)
    say(f"[emf] {npos:,} windows, cap 2^{int(np.log2(cap))} slots "
        f"({21 * cap / 1e9:.1f} GB), budget {budget_entries:,} "
        f"entries")

    loc = np.full(cap, -1, dtype=np.int64)
    fp = np.zeros(cap, dtype=np.uint32)
    fwl = np.zeros(cap, dtype=np.uint8)
    cnt = np.zeros(cap, dtype=np.int32)
    state = np.zeros(2, dtype=np.int64)   # [n_entries, max_probe]
    logs = []

    # in-contig window starts, streamed per contig in position order
    import time as _time
    t0 = _time.time()
    done = 0
    for a in bns.anns:
        if a.length < S:
            continue
        lo, hi = a.offset, a.offset + a.length - S + 1
        for c0 in range(lo, hi, chunk):
            c1 = min(c0 + chunk, hi)
            pos = np.arange(c0, c1, dtype=np.int64)
            (pos_fwless, h, gid, n_grp, rep,
             gcnt) = native_emf.group_windows(seq, pos, S)
            order = np.argsort(rep[:n_grp], kind="stable")
            memb_idx = np.argsort(gid, kind="stable")
            memb_off = np.zeros(n_grp + 1, dtype=np.int64)
            memb_off[1:] = np.cumsum(gcnt[:n_grp])
            grp_h = np.zeros(n_grp, dtype=np.uint64)
            grp_h[gid] = h
            mlog = native_emf.insert_chunk(
                seq, S, pos, pos_fwless.astype(np.uint8), grp_h,
                rep[:n_grp], gcnt[:n_grp], order.astype(np.int64),
                memb_idx.astype(np.int64), memb_off,
                loc, fp, fwl, cnt, budget_entries, state)
            if len(mlog[0]):
                logs.append(mlog)
            done += c1 - c0
            say(f"[emf] {done:,}/{npos:,} windows "
                f"({done / max(_time.time() - t0, 1e-9) / 1e6:.1f} "
                f"M/s), {state[0]:,} entries, maxprobe {state[1]}")

    # ---- multi-location lists from the merge log ----
    filled = loc >= 0
    multi = filled & (cnt > 1)
    slots_multi = np.flatnonzero(multi)
    nml = len(slots_multi)
    mlidx = np.full(cap, -1, dtype=np.int32)
    mlidx[slots_multi] = np.arange(nml, dtype=np.int32)
    if logs:
        lg_slot = np.concatenate([x[0] for x in logs])
        lg_pos = np.concatenate([x[1] for x in logs])
        lg_same = np.concatenate([x[2] for x in logs])
    else:
        lg_slot = np.empty(0, np.int64)
        lg_pos = np.empty(0, np.int64)
        lg_same = np.empty(0, bool)
    # add each multi entry's own stored location (same-orientation by
    # construction) to its list
    lg_slot = np.concatenate([lg_slot, slots_multi])
    lg_pos = np.concatenate([lg_pos, loc[slots_multi]])
    lg_same = np.concatenate([lg_same, np.ones(nml, bool)])
    keep = multi[lg_slot]     # merge-log rows of single entries drop
    lg_slot, lg_pos, lg_same = (lg_slot[keep], lg_pos[keep],
                                lg_same[keep])
    mg = mlidx[lg_slot].astype(np.int64)
    o = np.lexsort((lg_pos, ~lg_same, mg))
    ml_locs = lg_pos[o]
    per = np.bincount(mg, minlength=nml).astype(np.int64)
    ml_off = np.zeros(nml + 1, dtype=np.int64)
    ml_off[1:] = np.cumsum(per)
    ml_nfw = np.zeros(nml, dtype=np.int32)
    np.add.at(ml_nfw, mg[lg_same], 1)

    say(f"[emf] done: {state[0]:,} entries, {nml:,} multi, "
        f"{len(ml_locs):,} listed locations, "
        f"maxprobe {state[1]}, {(_time.time() - t0) / 60:.1f} min")
    return PerfectTable(seed_len=S, l_pac=bns.l_pac,
                        max_probe=int(max(state[1], 1)), loc=loc,
                        fp=fp, fwless=fwl, cnt=cnt, mlidx=mlidx,
                        ml_off=ml_off, ml_nfw=ml_nfw, ml_locs=ml_locs)


def emf_lookup_host(pt: PerfectTable, ref: np.ndarray,
                    codes: np.ndarray, lens: np.ndarray):
    """NumPy twin of ops/emf.emf_lookup, used by the streaming driver
    so the EMF probe never synchronizes the device queue (a device
    fetch would drain the in-flight extend batch). Must match the
    device kernel's results exactly."""
    B, L = codes.shape
    S = pt.seed_len
    lens = np.asarray(lens)
    iota = np.arange(L)
    in_len = iota[None, :] < lens[:, None]
    has_n = np.any(in_len & (codes >= 4), axis=1)
    too_short = lens < S

    fw = np.clip(codes[:, :S], 0, 3).astype(np.uint8)
    rcs = (3 - fw[:, ::-1]).astype(np.uint8)
    ridx = np.clip(lens[:, None] - 1 - iota[None, :], 0, L - 1)
    rcr = 3 - np.clip(np.take_along_axis(codes, ridx, axis=1), 0, 3)

    neq = fw != rcs
    first = np.argmax(neq, axis=1)
    any_neq = neq.any(axis=1)
    bidx = np.arange(B)
    fwle = np.where(any_neq, fw[bidx, first] < rcs[bidx, first], True)
    canon = np.where(fwle[:, None], fw, rcs)

    words = pack_words(canon)
    h = hash_words(words, S)
    fpq = (h >> np.uint64(32)).astype(np.uint32)
    ncap = len(pt.loc)
    mask = np.uint64(ncap - 1)
    P = max(pt.max_probe, 1)
    slots = ((h[:, None] + np.arange(P, dtype=np.uint64)[None, :])
             & mask).astype(np.int64)
    # Probe in rounds with early exit: a budgeted genome-scale table
    # can carry max_probe in the hundreds (hg38 -g 40: 175), but
    # almost every read resolves in the first couple of slots —
    # fetching all B*P slots up front touches ~100x more random pages
    # of the (mmap'd, tens-of-GB) table than the probe needs.
    loc_p = np.full((B, P), -1, dtype=pt.loc.dtype)
    fp_p = np.zeros((B, P), dtype=pt.fp.dtype)
    CH = 4
    row_alive = np.ones(B, dtype=bool)
    for c0 in range(0, P, CH):
        c1 = min(c0 + CH, P)
        rows = np.flatnonzero(row_alive)
        if not len(rows):
            break
        sl = slots[rows, c0:c1]
        lp = pt.loc[sl]
        fp = pt.fp[sl]
        loc_p[rows, c0:c1] = lp
        fp_p[rows, c0:c1] = fp
        # stop at the first empty slot or fingerprint candidate (the
        # argmax below picks the first candidate regardless)
        row_alive[rows] &= ((lp >= 0).all(axis=1)
                            & ~(fp == fpq[rows, None]).any(axis=1))
    alive = np.cumprod(loc_p >= 0, axis=1).astype(bool)
    cand = alive & (fp_p == fpq[:, None])
    sel = np.argmax(cand, axis=1)
    has_cand = cand.any(axis=1)
    slot = slots[bidx, sel]
    loc = np.where(has_cand, loc_p[bidx, sel], 0)

    pos_rc = loc - (lens - S).astype(np.int64)
    okf = loc + lens <= pt.l_pac
    okr = pos_rc >= 0
    l2 = len(ref)
    reff = ref[np.clip(loc[:, None] + iota[None, :], 0, l2 - 1)]
    refr = ref[np.clip(pos_rc[:, None] + iota[None, :], 0, l2 - 1)]
    fwm = has_cand & okf & np.all(~in_len | (reff == codes), axis=1)
    rcm = has_cand & okr & np.all(~in_len | (refr == rcr), axis=1)

    # multi-location rescue (seedmatch_further's list scan,
    # src/perfect_map.cpp:528-570) — must mirror ops/emf.emf_lookup
    mi0 = np.where(has_cand, pt.mlidx[np.clip(slot, 0, None)], -1)
    need = (has_cand & (lens > S) & ~fwm & ~rcm & (mi0 >= 0)
            & ~has_n & ~too_short)
    for i in np.flatnonzero(need):
        sl = int(slot[i])
        mi_ = int(pt.mlidx[sl])
        lo2, hi2 = int(pt.ml_off[mi_]), int(pt.ml_off[mi_ + 1])
        nfw = int(pt.ml_nfw[mi_])
        Lr = int(lens[i])
        read = codes[i, :Lr]
        rc = rcr[i, :Lr]
        is_rev0 = bool(pt.fwless[sl] != 0) != bool(fwle[i])
        for k in range(lo2, hi2):
            loc_c = int(pt.ml_locs[k])
            isrev = is_rev0 if (k - lo2) < nfw else (not is_rev0)
            if not isrev:
                if (loc_c + Lr <= pt.l_pac
                        and np.array_equal(ref[loc_c: loc_c + Lr],
                                           read)):
                    fwm[i] = True
                    loc[i] = loc_c
                    break
            else:
                p0 = loc_c - (Lr - S)
                if (p0 >= 0
                        and np.array_equal(ref[p0: p0 + Lr], rc)):
                    rcm[i] = True
                    loc[i] = loc_c
                    break

    code = np.where(too_short, 0,
                    np.where(has_n, 1,
                             np.where(fwm, 3, np.where(rcm, 4, 2))))
    return dict(code=code.astype(np.int32), slot=slot.astype(np.int32),
                loc=np.where(fwm | rcm, loc, -1),
                n_loc=np.where(has_cand, pt.cnt[slot], 0))


def save_perfect_table(pt: PerfectTable, prefix: str) -> str:
    path = f"{prefix}.emf{pt.seed_len}.npz"
    np.savez(path, seed_len=np.int64(pt.seed_len),
             l_pac=np.int64(pt.l_pac), max_probe=np.int64(pt.max_probe),
             loc=pt.loc, fp=pt.fp, fwless=pt.fwless, cnt=pt.cnt,
             mlidx=pt.mlidx, ml_off=pt.ml_off, ml_nfw=pt.ml_nfw,
             ml_locs=pt.ml_locs)
    return path


def load_perfect_table(path: str) -> PerfectTable:
    from ..utils.npzmap import load_npz_mmap
    z = load_npz_mmap(path)
    return PerfectTable(
        seed_len=int(z["seed_len"]), l_pac=int(z["l_pac"]),
        max_probe=int(z["max_probe"]), loc=z["loc"], fp=z["fp"],
        fwless=z["fwless"], cnt=z["cnt"], mlidx=z["mlidx"],
        ml_off=z["ml_off"], ml_nfw=z["ml_nfw"], ml_locs=z["ml_locs"])
