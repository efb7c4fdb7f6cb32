"""Scatter-free (one-hot) SMEM machines — a rebuild of
ops/smem_rl.py that replaces its ~15 per-lane gathers and scatters
per tick with one-hot masked selects and writes over a [T, L] panel
(elementwise work). The previous accelerator lowered per-lane
indexed ops to serial loops; on the GPU the trade is not yet
measured.

So this machine keeps exactly ONE per-lane-indexed op per tick — the
fused checkpoint-row gather (backward extension, the irreducible
dependent fetch) — and expresses everything else one-hot:

  - per-lane read codes:  a [T, L] panel gathered ONCE at start,
    per-tick column reads as masked reductions;
  - interval stacks:      two [T, L] buffers + a per-lane `which`
    bit; reads are masked reductions over both (select by bit),
    pushes are one-hot writes, and the round epilogue (prev <- curr,
    src/FMI_search.cpp:1557 prev.reverse() analogue) flips the bit
    instead of copying 8 [T, L] arrays;
  - emissions:            one-hot appends into the lane's own output
    row (machines run one lane per task, so lane == output row).

Control flow and emission order replicate ops/smem_rl.py tick for
tick (same phases, same quirks: double push of the failing forward
interval, first-hit break, distinct-s tail, next_x = j on failure —
getSMEMsOnePosOneThread, src/FMI_search.cpp:1372-1660); output is
bit-identical (tests/test_smem_oh.py asserts equality against the
readlane machine and transitively against the oracle).

The K-step fold (index/kstep.py bigram/trigram tables) is supported:
wider checkpoint rows (160/672 B vs 32 B) for fewer ticks. It lost on
the previous accelerator and is off by default; on the GPU it is not
measured (bench.py keeps the A/B harness behind BENCH_KSTEP).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .occ import (DeviceFMIndex, backward_ext_all4, _take_c,
                  backward_ext_steps_and_1)
import os

from .smem import SmemBuf, concat_smems, compact_indices

P_INIT = 0
P_FWD = 1
P_BSCAN = 2
P_BTAIL = 3
P_DONE = 4


def _oh_read(arr, i):
    """arr[t, i[t]] as a masked reduction. arr [T, L], i [T]."""
    L = arr.shape[1]
    iota = jnp.arange(L, dtype=jnp.int32)[None, :]
    i = jnp.clip(i, 0, L - 1).astype(jnp.int32)
    return jnp.sum(jnp.where(iota == i[:, None], arr, 0), axis=1,
                   dtype=arr.dtype)


def _oh_write(arr, i, v, do):
    """arr[t, i[t]] = v[t] where do[t] (drop when i out of range)."""
    L = arr.shape[1]
    iota = jnp.arange(L, dtype=jnp.int32)[None, :]
    idx = jnp.where(do, i.astype(jnp.int32), L)
    return jnp.where(iota == idx[:, None],
                     v[:, None].astype(arr.dtype), arr)


def _sel_small(table, i):
    """table[i] for a tiny (<=8) 1-D table — one-hot, no gather."""
    W = table.shape[0]
    iota = jnp.arange(W, dtype=jnp.int32)
    sel = iota == i[:, None].astype(jnp.int32)
    return jnp.sum(jnp.where(sel, table[None, :], 0), axis=1,
                   dtype=table.dtype)


def _emit_oh(out: SmemBuf, mask, m, n, k, l, s):
    """Masked append, lane t -> row t (one-hot; cnt may exceed M to
    signal overflow exactly like SmemBuf.emit_rows's drop mode)."""
    B, M = out.m.shape
    iota = jnp.arange(M, dtype=jnp.int32)[None, :]
    idx = jnp.where(mask, out.cnt, M)
    sel = iota == idx[:, None]
    w = lambda arr, v: jnp.where(sel, v[:, None].astype(arr.dtype), arr)
    return SmemBuf(w(out.m, m), w(out.n, n), w(out.k, k), w(out.l, l),
                   w(out.s, s), out.cnt + mask.astype(jnp.int32))


class _Stacks:
    """Two interval stacks (prev=A / curr=B) as double buffers with a
    per-lane `which` bit: A is buf[wA], B is buf[1-wA]. No copies at
    round turnover — the bit flips (the readlane machine's tree_map
    where-copy cost ~8 full [T, L] rewrites per tick).

    The two buffers live as a TUPLE per field (not a stacked [2,T,L]
    array): a per-push jnp.stack would materialize an extra full copy
    of both buffers per entry per field — pure HBM traffic with no
    compute. The `n` field (a column index < L) is int16: half the
    write traffic of the int32 it replaces."""

    FIELDS = ("k", "l", "s", "n")

    def __init__(self, st):
        self.st = st

    @staticmethod
    def init(T, SD, pos_dtype):
        z = lambda dt: (jnp.zeros((T, SD), dt), jnp.zeros((T, SD), dt))
        return dict(k=z(pos_dtype), l=z(pos_dtype), s=z(pos_dtype),
                    n=z(jnp.int16), wA=jnp.zeros((T,), bool))

    @staticmethod
    def read_a(st, f, i):
        """A-stack field f at per-lane index i."""
        v0 = _oh_read(st[f][0], i)
        v1 = _oh_read(st[f][1], i)
        v = jnp.where(st["wA"], v1, v0)
        return v.astype(jnp.int32) if f == "n" else v

    @staticmethod
    def push_rows(st, to_a, entries, cnt):
        """Ordered one-hot pushes of `entries` = [(do, k, l, s, n)...]
        into the A (to_a=True) or B stack at cnt, advancing cnt per
        `do` (exactly push3/push of the readlane machine).

        All entries are combined into ONE masked write per field per
        buffer: each active entry targets a distinct column (cnt
        advances per `do`), so the per-entry one-hot selects are
        collision-free and their sum-select equals the sequential
        write order. The naive per-entry form emitted 2*E fused
        kernels per field per tick."""
        st = dict(st)
        SD = st["k"][0].shape[1]
        iota = jnp.arange(SD, dtype=jnp.int32)[None, :]
        tgt1 = st["wA"] if to_a else ~st["wA"]       # buffer 1?
        c = cnt
        sels = []                                    # (sel0, sel1) per entry
        for do, k, l, s, n in entries:
            idx = jnp.where(do, c.astype(jnp.int32), SD)
            sel = iota == idx[:, None]               # [T, SD]
            sels.append((sel & ~tgt1[:, None], sel & tgt1[:, None]))
            c = c + do.astype(jnp.int32)
        vals = [dict(k=k, l=l, s=s, n=n)
                for (do, k, l, s, n) in entries]
        for f in _Stacks.FIELDS:
            b0, b1 = st[f]
            dt = b0.dtype
            acc0 = jnp.zeros_like(b0)
            acc1 = jnp.zeros_like(b1)
            any0 = jnp.zeros(b0.shape, bool)
            any1 = jnp.zeros(b1.shape, bool)
            for (s0, s1), v in zip(sels, vals):
                vv = v[f][:, None].astype(dt)
                acc0 = jnp.where(s0, vv, acc0)
                acc1 = jnp.where(s1, vv, acc1)
                any0 = any0 | s0
                any1 = any1 | s1
            st[f] = (jnp.where(any0, acc0, b0),
                     jnp.where(any1, acc1, b1))
        return st, c


def one_pos_machine_oh(fmi: DeviceFMIndex, codes, lens, t_read, t_x,
                       t_mi, t_valid, chain_restarts: bool,
                       min_seed_len: int, max_out: int,
                       out: SmemBuf, with_ticks: bool = False,
                       stack_depth: int = None):
    """One lane per task; lane t emits into out row t (callers pass
    per-task buffers; one_pos_machine's out_rows indirection is
    applied by the caller afterwards where needed). Contract and
    output match ops/smem_rl.one_pos_machine(lanes=None,
    out_rows=arange) bit for bit.

    `stack_depth` < L shrinks the interval stacks from the provably-
    sufficient [T, L] to [T, SD]: per-tick stack traffic is the
    machine's largest HBM term, and measured occupancy is a fraction
    of L. A lane whose stack would overflow is latched and its output
    row's cnt forced past the buffer width, which the caller's
    existing capacity check converts into an overflow retry at full
    shapes — dropped pushes therefore never reach emitted output."""
    N = t_read.shape[0]
    T = N
    B, L = codes.shape
    codes = jnp.asarray(codes)
    lens = jnp.asarray(lens)
    t_read = jnp.asarray(t_read).astype(jnp.int32)
    t_valid = jnp.asarray(t_valid)
    pos_dtype = fmi.pos_dtype
    use2 = getattr(fmi, "cp2_fused", None) is not None
    ksteps = (3 if getattr(fmi, "count3", None) is not None
              else 2) if use2 else 1
    tail3 = ksteps >= 3

    t_x = jnp.asarray(t_x).astype(jnp.int32)
    t_mi_p = jnp.asarray(t_mi).astype(pos_dtype)
    SD = stack_depth or L

    # one-time panel gather: the lane's read codes (no refill — each
    # lane owns exactly one task). int8: the per-tick column reads are
    # [T, L] masked reductions — byte lanes quarter their HBM traffic.
    panel0 = codes[jnp.clip(t_read, 0, B - 1)].astype(jnp.int8)

    len0 = jnp.where(t_valid, lens[jnp.clip(t_read, 0, B - 1)], 0
                     ).astype(jnp.int32)

    st0 = dict(
        orow=jnp.arange(T, dtype=jnp.int32),
        phase=jnp.full((T,), P_INIT, jnp.int32),
        len=len0,
        mi=t_mi_p,
        x=t_x,
        nx=t_x + 1,
        j=jnp.zeros((T,), jnp.int32),
        ck=jnp.zeros((T,), pos_dtype),
        cl=jnp.zeros((T,), pos_dtype),
        cs=jnp.zeros((T,), pos_dtype),
        cn=jnp.zeros((T,), jnp.int32),
        of=jnp.zeros((T,), bool),
        stk=_Stacks.init(T, SD, pos_dtype),
        cntA=jnp.zeros((T,), jnp.int32),
        cntB=jnp.zeros((T,), jnp.int32),
        mA=jnp.zeros((T,), jnp.int32),
        p=jnp.zeros((T,), jnp.int32),
        rev=jnp.zeros((T,), bool),
        curr_s=jnp.full((T,), -1, pos_dtype),
        kept=jnp.zeros((T,), bool),
        tick=jnp.zeros((), jnp.int32),
        out=out,
    )
    if with_ticks:
        st0["done_at"] = jnp.full((T,), -1, jnp.int32)
        st0["phase_ticks"] = jnp.zeros((5,), jnp.int64)

    def cond(st):
        return jnp.any(st["phase"] != P_DONE)

    def mk_body(panel):
      def body(st):
        phase = st["phase"]
        is_init = phase == P_INIT
        is_fwd = phase == P_FWD
        is_bs = phase == P_BSCAN
        is_bt = phase == P_BTAIL

        lens_t = st["len"]
        mi = st["mi"]
        stk = st["stk"]

        # ----- panel column reads (one-hot; INIT x, FWD j..j+K-1)
        xa = _oh_read(panel, st["x"]).astype(jnp.int32)
        a_j = _oh_read(panel, st["j"]).astype(jnp.int32)
        step_cs = [_oh_read(panel, st["j"] + d).astype(jnp.int32)
                   for d in range(1, ksteps)]
        x_ok = (st["x"] < lens_t) & (xa < 4)
        xac = jnp.clip(xa, 0, 3)
        ik = _sel_small(fmi.count, xac)
        il = _sel_small(fmi.count, 3 - xac)
        is_ = _sel_small(fmi.count, xac + 1) - ik

        # ----- stack reads for the backward lanes -----
        scan_i = jnp.where(st["rev"], st["cntA"] - 1 - st["p"], st["p"])
        ra = lambda f, i: _Stacks.read_a(stk, f, i)
        pk, pl, ps, pn = (ra("k", scan_i), ra("l", scan_i),
                          ra("s", scan_i), ra("n", scan_i))
        if use2:
            nsl = 3 if tail3 else 2
            si2 = jnp.where(st["rev"], st["cntA"] - 2 - st["p"],
                            st["p"] + 1)
            pk2, pl2, ps2, pn2 = (ra("k", si2), ra("l", si2),
                                  ra("s", si2), ra("n", si2))
            if tail3:
                si3 = jnp.where(st["rev"], st["cntA"] - 3 - st["p"],
                                st["p"] + 2)
                pk3, pl3, ps3, pn3 = (ra("k", si3), ra("l", si3),
                                      ra("s", si3), ra("n", si3))
        pm = st["mA"]
        ext_k = jnp.where(is_fwd, st["ck"], pk)
        ext_l = jnp.where(is_fwd, st["cl"], pl)
        ext_s = jnp.where(is_fwd, st["cs"], ps)
        ac = jnp.clip(a_j, 0, 3)
        sel1 = jnp.where(is_fwd, 3 - ac, ac)

        if use2:
            sels = [sel1] + [
                jnp.where(is_fwd, 3 - jnp.clip(cd, 0, 3), jnp.int32(0))
                for cd in step_cs]
            kk = jnp.where(is_fwd, ext_l, ext_k)
            ll = jnp.where(is_fwd, ext_k, ext_l)
            sides = [(pk3, pl3, ps3, ac)] if tail3 else []
            res = backward_ext_steps_and_1(
                fmi, kk, ll, ext_s, tuple(sels), pk2, pl2, ps2, ac,
                sides=sides)
            if tail3:
                (nkC, nlC, nsC) = res[-1]
                res = res[:-1]
            fsteps, (nkB, nlB, nsB) = res[:-1], res[-1]
            (K1, L1, S1) = fsteps[0]
            nk = jnp.where(is_fwd, L1, K1)
            nl = jnp.where(is_fwd, K1, L1)
            ns = S1
            fw_steps = [(t[1], t[0], t[2]) for t in fsteps]
        else:
            kk = jnp.where(is_fwd, ext_l, ext_k)
            ll = jnp.where(is_fwd, ext_k, ext_l)
            k4, l4, s4 = backward_ext_all4(fmi, kk, ll, ext_s)
            nk = jnp.where(is_fwd, _take_c(l4, sel1), _take_c(k4, sel1))
            nl = jnp.where(is_fwd, _take_c(k4, sel1), _take_c(l4, sel1))
            ns = _take_c(s4, sel1)

        out_b = st["out"]
        cntA, cntB = st["cntA"], st["cntB"]

        # ================= FWD transition =================
        j_in = st["j"] < lens_t
        a_ok = a_j < 4
        f_run = is_fwd & j_in & a_ok
        if not use2:
            s_changed = f_run & (ns != st["cs"])
            s_fail = f_run & (ns < mi)
            f_cont = f_run & ~s_fail
            f_end = is_fwd & (~j_in | ~a_ok | s_fail)
            entries = [
                (s_changed, st["ck"], st["cl"], st["cs"], st["cn"]),
                (f_end & (st["cs"] >= mi), st["ck"], st["cl"],
                 st["cs"], st["cn"]),
            ]
            stk, cntA = _Stacks.push_rows(stk, True, entries, cntA)
            mA = jnp.where(f_end, st["x"], st["mA"])
            nx = jnp.where(is_fwd & j_in, st["j"] + 1, st["nx"])
            nx = jnp.where(s_fail, st["j"], nx)
            ck = jnp.where(f_cont, nk, st["ck"])
            cl = jnp.where(f_cont, nl, st["cl"])
            cs = jnp.where(f_cont, ns, st["cs"])
            cn = jnp.where(f_cont, st["j"], st["cn"])
            j = jnp.where(f_cont, st["j"] + 1, st["j"])
        else:
            prev_int = (st["ck"], st["cl"], st["cs"], st["cn"])
            ek, el, es, en = prev_int
            entries = []
            nx = st["nx"]
            gate = is_fwd
            cont_d = is_fwd
            for d in range(ksteps):
                jd = st["j"] + d
                cd = a_j if d == 0 else step_cs[d - 1]
                run_d = gate & (jd < lens_t) & (cd < 4)
                sk, sl, ss_ = fw_steps[d]
                ch_d = run_d & (ss_ != prev_int[2])
                fail_d = run_d & (ss_ < mi)
                cont_d = run_d & ~fail_d
                entries.append((ch_d,) + prev_int)
                nx = jnp.where(gate & (jd < lens_t), jd + 1, nx)
                nx = jnp.where(fail_d, jd, nx)
                ek = jnp.where(cont_d, sk, ek)
                el = jnp.where(cont_d, sl, el)
                es = jnp.where(cont_d, ss_, es)
                en = jnp.where(cont_d, jd, en)
                prev_int = (sk, sl, ss_, jd)
                gate = cont_d
            f_end = is_fwd & ~cont_d
            entries.append((f_end & (es >= mi), ek, el, es, en))
            stk, cntA = _Stacks.push_rows(stk, True, entries, cntA)
            mA = jnp.where(f_end, st["x"], st["mA"])
            ck, cl, cs, cn = ek, el, es, en
            j = jnp.where(cont_d, st["j"] + ksteps, st["j"])

        phase2 = jnp.where(f_end, P_BSCAN, phase)
        j = jnp.where(f_end, st["x"] - 1, j)
        rev = jnp.where(f_end, True, st["rev"])
        p = jnp.where(f_end, 0, st["p"])
        curr_s = jnp.where(f_end, jnp.asarray(-1, pos_dtype),
                           st["curr_s"])
        kept = jnp.where(f_end, False, st["kept"])
        cntB = jnp.where(f_end, 0, cntB)

        # ============ BACKWARD round prologue checks ============
        round_start = is_bs & (st["p"] == 0)
        b_dead = round_start & ((st["j"] < 0) | (a_j >= 4)
                                | (st["cntA"] == 0))
        emit0 = b_dead & (st["cntA"] > 0) \
            & ((pn - pm + 1) >= min_seed_len)

        # ================= BSCAN transition =================
        bs_run = is_bs & ~b_dead
        die = bs_run & (ns < mi)
        emit_sc = die & ((pn - pm + 1) >= min_seed_len)
        keep_sc = bs_run & ~die & (ns != st["curr_s"])
        hit = emit_sc | keep_sc
        if use2:
            nb_ok = (st["p"] + 1) < st["cntA"]
            cont_scan = bs_run & ~hit & nb_ok
            die2 = cont_scan & (nsB < mi)
            emit_sc2 = die2 & ((pn2 - pm + 1) >= min_seed_len)
            keep_sc2 = cont_scan & ~die2 & (nsB != st["curr_s"])
            hit2 = emit_sc2 | keep_sc2
            cs_mid_s = jnp.where(keep_sc, ns, st["curr_s"])
            keep_tl2s = (bs_run & hit & nb_ok & (nsB >= mi)
                         & (nsB != cs_mid_s))
        else:
            hit2 = jnp.zeros_like(hit)
            emit_sc2 = keep_sc2 = keep_tl2s = hit2
        if use2:
            e2 = emit_sc2
            out_b = _emit_oh(out_b, emit0 | emit_sc | e2, pm,
                             jnp.where(e2, pn2, pn),
                             jnp.where(e2, pk2, pk),
                             jnp.where(e2, pl2, pl),
                             jnp.where(e2, ps2, ps))
        else:
            out_b = _emit_oh(out_b, emit0 | emit_sc, pm, pn, pk, pl, ps)
        kept = kept | hit | hit2
        phase2 = jnp.where(hit | hit2, P_BTAIL, phase2)

        # ================= BTAIL transition =================
        bt_run = is_bt
        keep_tl = bt_run & (st["p"] < st["cntA"]) & (ns >= mi) \
            & (ns != st["curr_s"])
        keep_b = keep_sc | keep_tl
        if use2:
            cs_mid = jnp.where(keep_b, ns, st["curr_s"])
            keep_tl2 = (bt_run & (st["p"] + 1 < st["cntA"])
                        & (nsB >= mi) & (nsB != cs_mid))
            keep2 = keep_tl2 | keep_sc2 | keep_tl2s
            entries_b = [(keep_b, nk, nl, ns, pn),
                         (keep2, nkB, nlB, nsB, pn2)]
            curr_s2 = jnp.where(keep2, nsB,
                                jnp.where(keep_b, ns, curr_s))
            if tail3:
                keep_tl3 = (bt_run & (st["p"] + 2 < st["cntA"])
                            & (nsC >= mi) & (nsC != curr_s2))
                entries_b.append((keep_tl3, nkC, nlC, nsC, pn3))
                curr_s2 = jnp.where(keep_tl3, nsC, curr_s2)
            stk, cntB = _Stacks.push_rows(stk, False, entries_b, cntB)
            curr_s = curr_s2
        else:
            stk, cntB = _Stacks.push_rows(
                stk, False, [(keep_b, nk, nl, ns, pn)], cntB)
            curr_s = jnp.where(keep_b, ns, curr_s)

        # stack-overflow latch: cnt past SD means a push was dropped
        # by _oh_write's range mask — taken before the epilogue can
        # reset the counters
        of = st["of"] | (cntA > SD) | (cntB > SD)

        b_any = bs_run | bt_run
        if use2:
            bt_adv = 3 if tail3 else 2
            badv = jnp.where(bt_run, bt_adv,
                             jnp.where(bs_run & nb_ok, 2, 1))
        else:
            badv = jnp.int32(1)
        p = jnp.where(b_any, st["p"] + badv, p)
        scan_out = bs_run & ~(hit | hit2) \
            & (st["p"] + badv >= st["cntA"])
        tail_out = bt_run & (st["p"] + badv >= st["cntA"])
        if use2:
            tail_out = tail_out | (bs_run & (hit | hit2)
                                   & (st["p"] + badv >= st["cntA"]))
        round_over = scan_out | tail_out

        # round epilogue: prev <- curr by flipping the which-bit (no
        # copy; the new curr buffer's stale slots are never read and
        # get overwritten in order by the next round's pushes)
        stk = dict(stk)
        stk["wA"] = stk["wA"] ^ round_over
        cntA = jnp.where(round_over, cntB, cntA)
        cntB = jnp.where(round_over, 0, cntB)
        mA = jnp.where(round_over, st["j"], mA)
        j = jnp.where(round_over, st["j"] - 1, j)
        rev = jnp.where(round_over, False, rev)
        p = jnp.where(round_over, 0, p)
        curr_s = jnp.where(round_over, jnp.asarray(-1, pos_dtype),
                           curr_s)
        phase2 = jnp.where(round_over, P_BSCAN, phase2)
        kept = jnp.where(round_over, False, kept)

        # ================= position end -> INIT/finish ============
        pos_end = b_dead
        if chain_restarts:
            x2 = jnp.where(pos_end, jnp.maximum(st["nx"], st["x"] + 1),
                           st["x"])
            fin_pos = pos_end & (x2 >= lens_t)
            phase2 = jnp.where(pos_end & ~fin_pos, P_INIT, phase2)
        else:
            x2 = st["x"]
            fin_pos = pos_end

        # ================= INIT transition =================
        init_bad = is_init & ~x_ok
        if chain_restarts:
            xb = jnp.where(init_bad, st["x"] + 1, x2)
            fin_init = init_bad & (xb >= lens_t)
            phase2 = jnp.where(init_bad & ~fin_init, P_INIT, phase2)
            x2 = xb
        else:
            fin_init = init_bad
        init_go = is_init & x_ok
        ck = jnp.where(init_go, ik, ck)
        cl = jnp.where(init_go, il, cl)
        cs = jnp.where(init_go, is_, cs)
        cn = jnp.where(init_go, st["x"], cn)
        j = jnp.where(init_go, st["x"] + 1, j)
        nx = jnp.where(is_init, st["x"] + 1, nx)
        cntA = jnp.where(init_go, 0, cntA)
        phase2 = jnp.where(init_go, P_FWD, phase2)

        # task finished -> DONE (no refill: one lane per task)
        fin = (fin_pos | fin_init) & (phase != P_DONE)
        phase2 = jnp.where(fin, P_DONE, phase2)

        st2 = dict(orow=st["orow"], phase=phase2, len=st["len"],
                   mi=mi, x=x2, nx=nx,
                   j=j, ck=ck, cl=cl, cs=cs, cn=cn, stk=stk, of=of,
                   cntA=cntA, cntB=cntB, mA=mA, p=p, rev=rev,
                   curr_s=curr_s, kept=kept, tick=st["tick"] + 1,
                   out=out_b)
        if with_ticks:
            st2["done_at"] = jnp.where(
                (st["done_at"] < 0) & (phase2 == P_DONE),
                st["tick"] + 1, st["done_at"])
            st2["phase_ticks"] = st["phase_ticks"] + jnp.bincount(
                phase, length=5).astype(jnp.int64)
        return st2
      return body

    # ---- staged narrowing (the lockstep-tail fix) -----------------
    # Lockstep machines pay the SLOWEST lane's tick count at full
    # width: measured 54% (E. coli) to 80% (hg38) of lane-ticks were
    # DONE-lane idle. Stages run the full-width machine only until
    # the active count fits the next (halved) width, then compact
    # every per-lane state row (cheap [W]-index row gathers) and
    # continue narrow. Done lanes flush their lane-local emissions to
    # the output rows once, at stage end (one [W]-index row scatter
    # per field). Bit-identical: tasks never migrate mid-flight and
    # per-task emission order is preserved.
    stages_env = os.environ.get("BWATPU_SEED_STAGES", "auto")
    if with_ticks or stages_env == "0":
        widths = []
    elif stages_env == "auto":
        # halve until 256 lanes: at bench width the unstaged machine
        # idles ~2/3 of its lane-ticks in the DONE tail; stage
        # transitions are cheap [W]-row gathers
        widths = []
        w = T // 2
        while w >= 256:
            widths.append(w)
            w //= 2
    else:
        widths = [int(w) for w in stages_env.split(",")
                  if 0 < int(w) < T]

    glob = out
    OUTB = glob.m.shape[0]
    M_out = glob.m.shape[1]
    st0["out"] = SmemBuf.empty(T, M_out, pos_dtype)

    def flush(glob, st):
        done = st["phase"] == P_DONE
        rows = jnp.where(done, st["orow"], OUTB)
        lo = st["out"]
        # stack-overflowed lanes report cnt >= capacity so the
        # caller's capacity check routes the read to the retry ladder
        cnt = jnp.where(st["of"], jnp.int32(M_out + 1),
                        lo.cnt.astype(jnp.int32))
        return SmemBuf(
            glob.m.at[rows].set(lo.m, mode="drop"),
            glob.n.at[rows].set(lo.n, mode="drop"),
            glob.k.at[rows].set(lo.k, mode="drop"),
            glob.l.at[rows].set(lo.l, mode="drop"),
            glob.s.at[rows].set(lo.s, mode="drop"),
            glob.cnt.at[rows].set(cnt, mode="drop"))

    st, pan = st0, panel0
    for W2 in widths:
        body = mk_body(pan)
        st = jax.lax.while_loop(
            lambda s: jnp.sum(s["phase"] != P_DONE) > W2, body, st)
        glob = flush(glob, st)
        perm, valid = compact_indices(st["phase"] != P_DONE, W2)
        g = lambda a: a[perm]
        st2 = {k: g(st[k]) for k in
               ("len", "mi", "x", "nx", "j", "ck", "cl", "cs", "cn",
                "cntA", "cntB", "mA", "p", "rev", "curr_s", "kept",
                "of")}
        st2["phase"] = jnp.where(valid, g(st["phase"]),
                                 jnp.int32(P_DONE))
        st2["orow"] = jnp.where(valid, g(st["orow"]),
                                jnp.int32(OUTB))
        stk2 = {f: (st["stk"][f][0][perm], st["stk"][f][1][perm])
                for f in _Stacks.FIELDS}
        stk2["wA"] = g(st["stk"]["wA"])
        st2["stk"] = stk2
        lo = st["out"]
        st2["out"] = SmemBuf(lo.m[perm], lo.n[perm], lo.k[perm],
                             lo.l[perm], lo.s[perm], g(lo.cnt))
        st2["tick"] = st["tick"]
        st, pan = st2, pan[perm]

    body = mk_body(pan)
    stf = jax.lax.while_loop(cond, body, st)
    if with_ticks:
        # unstaged by construction: lane == task row throughout
        return stf["out"], (stf["tick"], stf["done_at"],
                            stf["phase_ticks"])
    return flush(glob, stf)


def seed_strategy_machine_oh(fmi: DeviceFMIndex, codes, lens,
                             max_intv: int, min_seed_len: int,
                             max_out: int, with_ticks: bool = False):
    """Pass 3 (bwtSeedStrategyAllPosOneThread,
    src/FMI_search.cpp:1662-1730) — one lane per read, scatter-free.
    Output bit-identical to ops/smem_rl.seed_strategy_machine."""
    B, L = codes.shape
    T = B
    pos_dtype = fmi.pos_dtype
    codes = jnp.asarray(codes)
    lens = jnp.asarray(lens)
    use2 = getattr(fmi, "cp2_fused", None) is not None
    mx = jnp.asarray(max_intv, pos_dtype)
    panel = codes.astype(jnp.int8)           # lane t == read t

    st0 = dict(
        phase=jnp.full((T,), P_INIT, jnp.int32),
        len=lens.astype(jnp.int32),
        x=jnp.zeros((T,), jnp.int32),
        j=jnp.zeros((T,), jnp.int32),
        ck=jnp.zeros((T,), pos_dtype),
        cl=jnp.zeros((T,), pos_dtype),
        cs=jnp.zeros((T,), pos_dtype),
        tick=jnp.zeros((), jnp.int32),
        out=SmemBuf.empty(B, max_out, pos_dtype),
    )

    def cond(st):
        return jnp.any(st["phase"] != P_DONE)

    def body(st):
        phase = st["phase"]
        is_init = phase == P_INIT
        is_fwd = phase == P_FWD
        lens_t = st["len"]

        xa = _oh_read(panel, st["x"]).astype(jnp.int32)
        a_j = _oh_read(panel, st["j"]).astype(jnp.int32)
        x_ok = (st["x"] < lens_t) & (xa < 4)
        xac = jnp.clip(xa, 0, 3)
        ac = jnp.clip(a_j, 0, 3)
        j_in = st["j"] < lens_t
        a_ok = a_j < 4
        msl_at = lambda col: (col - st["x"] + 1) >= min_seed_len

        if use2:
            b_j = _oh_read(panel, st["j"] + 1).astype(jnp.int32)
            bc = jnp.clip(b_j, 0, 3)
            from .occ import forward_ext2
            (nk, nl, ns), (nk2, nl2, ns2) = forward_ext2(
                fmi, st["ck"], st["cl"], st["cs"], ac, bc)
            r1 = is_fwd & j_in & a_ok
            hit1 = r1 & (ns < mx) & msl_at(st["j"])
            cont1 = r1 & ~hit1
            j2_in = (st["j"] + 1) < lens_t
            b_ok = b_j < 4
            r2 = cont1 & j2_in & b_ok
            hit2 = r2 & (ns2 < mx) & msl_at(st["j"] + 1)
            cont2 = r2 & ~hit2
            do_emit = (hit1 & (ns > 0)) | (hit2 & (ns2 > 0))
            out = _emit_oh(st["out"], do_emit, st["x"],
                           jnp.where(hit1, st["j"], st["j"] + 1),
                           jnp.where(hit1, nk, nk2),
                           jnp.where(hit1, nl, nl2),
                           jnp.where(hit1, ns, ns2))
            f_end = is_fwd & ~cont2
            ck = jnp.where(cont2, nk2, st["ck"])
            cl = jnp.where(cont2, nl2, st["cl"])
            cs = jnp.where(cont2, ns2, st["cs"])
            j = jnp.where(cont2, st["j"] + 2, st["j"])
            nx = jnp.where(cont1,
                           jnp.where(j2_in, st["j"] + 2, st["j"] + 1),
                           jnp.where(j_in, st["j"] + 1, st["j"]))
        else:
            k4, l4, s4 = backward_ext_all4(fmi, st["cl"], st["ck"],
                                           st["cs"])
            sel = 3 - ac
            nk, nl, ns = (_take_c(l4, sel), _take_c(k4, sel),
                          _take_c(s4, sel))
            f_run = is_fwd & j_in & a_ok
            hit = f_run & (ns < mx) & msl_at(st["j"])
            do_emit = hit & (ns > 0)
            out = _emit_oh(st["out"], do_emit, st["x"], st["j"],
                           nk, nl, ns)
            f_end = is_fwd & (~j_in | ~a_ok | hit)
            f_cont = f_run & ~hit
            ck = jnp.where(f_cont, nk, st["ck"])
            cl = jnp.where(f_cont, nl, st["cl"])
            cs = jnp.where(f_cont, ns, st["cs"])
            j = jnp.where(f_cont, st["j"] + 1, st["j"])
            nx = jnp.where(j_in, st["j"] + 1, st["j"])
        nx = jnp.where(is_init, st["x"] + 1, nx)
        x2 = jnp.where(f_end, nx, st["x"])
        fin_f = f_end & (x2 >= lens_t)
        phase2 = jnp.where(f_end & ~fin_f, P_INIT, phase)

        init_bad = is_init & ~x_ok
        xb = jnp.where(init_bad, st["x"] + 1, x2)
        fin_i = init_bad & (xb >= lens_t)
        phase2 = jnp.where(init_bad & ~fin_i, P_INIT, phase2)
        init_go = is_init & x_ok
        ck = jnp.where(init_go, _sel_small(fmi.count, xac), ck)
        cl = jnp.where(init_go, _sel_small(fmi.count, 3 - xac), cl)
        cs = jnp.where(init_go,
                       _sel_small(fmi.count, xac + 1)
                       - _sel_small(fmi.count, xac), cs)
        j = jnp.where(init_go, st["x"] + 1, j)
        phase2 = jnp.where(init_go, P_FWD, phase2)

        fin = (fin_f | fin_i) & (phase != P_DONE)
        phase2 = jnp.where(fin, P_DONE, phase2)

        return dict(phase=phase2, len=st["len"], x=xb, j=j, ck=ck,
                    cl=cl, cs=cs, tick=st["tick"] + 1, out=out)

    stf = jax.lax.while_loop(cond, body, st0)
    if with_ticks:
        return stf["out"], stf["tick"]
    return stf["out"]


def collect_smems_oh(fmi: DeviceFMIndex, codes, lens, *,
                     min_seed_len: int, split_len: int,
                     split_width: int, max_mem_intv: int,
                     max_out: int = None, emit_depth: int = None,
                     stack_depth: int = None, reseed_factor: int = 2):
    """Three-pass SMEM collection on the one-hot machines; output is
    bit-identical to collect_smems_rl / collect_smems_device
    (mem_collect_smem, src/bwamem.cpp:648-795).

    `emit_depth` / `stack_depth` shrink the per-lane emission buffers
    and interval stacks below the provably-sufficient L (measured
    occupancy at E. coli/chr21 scale: cnt max 4-5 of 101 slots — the
    oversize was pure HBM traffic every tick). A read that exceeds
    either budget in ANY pass reports cnt >= capacity, which
    seed_chain_extend's capacity check routes into the overflow-retry
    ladder at full shapes — output stays exactly equal to the
    full-size machine."""
    from .smem import _emit_compact, compact_indices

    B, L = codes.shape
    M = max_out or L
    Me = min(emit_depth, M) if emit_depth else M
    RF = reseed_factor
    bidx = jnp.arange(B, dtype=jnp.int32)
    zi = jnp.zeros((B,), jnp.int32)

    p1 = one_pos_machine_oh(
        fmi, codes, lens, bidx, zi, jnp.ones((B,), jnp.int32),
        lens > 0, True, min_seed_len, Me,
        SmemBuf.empty(B, Me, fmi.pos_dtype), stack_depth=stack_depth)
    p1_of = p1.cnt >= Me

    M1 = p1.m.shape[1]
    valid = jnp.arange(M1)[None, :] < p1.cnt[:, None]
    cand = (valid
            & ((p1.n + 1 - p1.m) >= split_len)
            & (p1.s <= split_width))
    flat = cand.reshape(B * M1)
    # reseed lane budget: candidates past T force the read into the
    # overflow-retry ladder (reseed_of). Demand is ~1.3/read on
    # normal batches but retry tiers carry repeat monsters with tens
    # of candidates each — they pass a larger factor.
    T = RF * B
    order, t_valid = compact_indices(flat, T)
    rank = jnp.cumsum(flat, dtype=jnp.int32) - 1
    reseed_of = jnp.any((flat & (rank >= T)).reshape(B, M1), axis=1)
    t_read = (order // M1).astype(jnp.int32)
    t_slot = order % M1
    t_x = ((p1.n[t_read, t_slot] + 1 + p1.m[t_read, t_slot]) >> 1)
    t_mi = jnp.where(t_valid, p1.s[t_read, t_slot] + 1, 1)
    p2t = one_pos_machine_oh(
        fmi, codes, lens, t_read, t_x.astype(jnp.int32),
        t_mi.astype(jnp.int32), t_valid, False, min_seed_len, Me,
        SmemBuf.empty(T, Me, fmi.pos_dtype), stack_depth=stack_depth)
    p2_of = jnp.zeros((B,), bool).at[
        jnp.where(t_valid, t_read, B)].max(
        (p2t.cnt >= Me) & t_valid, mode="drop")
    tmask = (jnp.arange(Me)[None, :] < p2t.cnt[:, None]) \
        & t_valid[:, None]
    p2 = _emit_compact(tmask, p2t.m, p2t.n, p2t.k, p2t.l, p2t.s,
                       SmemBuf.empty(B, Me, fmi.pos_dtype),
                       rows=t_read)

    parts = [p1, p2]
    pass_of = p1_of | p2_of | reseed_of
    if max_mem_intv > 0:
        p3 = seed_strategy_machine_oh(
            fmi, codes, lens, max_mem_intv, min_seed_len + 1, Me)
        parts.append(p3)
        pass_of = pass_of | (p3.cnt >= Me)
    combined = concat_smems(*parts)
    valid = jnp.concatenate(
        [jnp.arange(b.m.shape[1])[None, :] < b.cnt[:, None]
         for b in parts], axis=1)
    key = (combined.m << 16) | combined.n
    key = jnp.where(valid, key, jnp.int32(2 ** 30))
    # variadic sort: payloads ride the comparator network instead of
    # an argsort + 5x take_along_axis
    _, m_, n_, k_, l_, s_ = jax.lax.sort(
        (key, combined.m, combined.n, combined.k, combined.l,
         combined.s), dimension=1, num_keys=1)
    cnt = jnp.where(pass_of, combined.m.shape[1], combined.cnt)
    return SmemBuf(m_, n_, k_, l_, s_, cnt)
