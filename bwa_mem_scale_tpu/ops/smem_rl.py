"""Read-per-lane SMEM machine — the reference's forward/backward walk
in lockstep micro-ops.

The position-parallel sweep (ops/smem.py) pays two occ row-gathers
over B*L lanes per step; on this hardware a gather's cost scales with
lane count well above ~4k lanes, so the sweep's perfect parallelism
overshoots the chip. This module runs ONE lane per read/task, each
lane executing exactly one FM extension per tick of a lockstep state
machine that replicates getSMEMsOnePosOneThread's control flow
(src/FMI_search.cpp:1372-1660) including its quirks (the double push
of the failing forward interval; the backward scan's first-hit break
and distinct-s tail; next_x = j on interval failure). Per-read
FM-op counts are the reference's own (~2-4 L).

State per lane: phase, x (restart), j (column), the forward interval,
two interval stacks (prev/curr as structure-of-arrays), scan index
and direction, plus the distinct-s tracker. Stack direction flips
after the first backward round (the reference reverses `prev` once);
we scan the forward stack top-down and subsequent stacks bottom-up
instead of reversing.

Emissions append to a SmemBuf; pass-1 restarts chain through next_x,
pass-2 runs one task per lane, and the forward-only third pass has
its own tiny machine. Outputs are bit-identical to ops/smem.py after
the final (m, n) sort (tested).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .occ import DeviceFMIndex, backward_ext_all4
from .smem import SmemBuf, concat_smems

# phases
P_INIT = 0    # start a new position x (computes 1-base interval inline)
P_FWD = 1     # forward extension of `cur` by q[j]
P_BSCAN = 2   # backward scan over prev (first-hit break)
P_BTAIL = 3   # backward tail over remaining prev entries
P_DONE = 4


def _ext_all4(fmi, k, l, s, fwd):
    """One extension for every lane; fwd lanes use the k/l swap."""
    kk = jnp.where(fwd, l, k)
    ll = jnp.where(fwd, k, l)
    k4, l4, s4 = backward_ext_all4(fmi, kk, ll, s)
    return k4, l4, s4


def one_pos_machine(fmi: DeviceFMIndex, codes, lens, t_read, t_x,
                    t_mi, t_valid, chain_restarts: bool,
                    min_seed_len: int, max_out: int,
                    out: SmemBuf, with_ticks: bool = False,
                    lanes: int = None, out_rows=None):
    """Run getSMEMsOnePos for a backlog of (read, x, min_intv) tasks.

    chain_restarts=True makes each lane loop x -> next_x until the
    read end (pass 1); False runs a single position (pass 2).
    with_ticks=True returns (buf, n_ticks) for perf diagnostics.

    `lanes` (default: one lane per task) sets the worker-lane count:
    with lanes < n_tasks, a lane that finishes its task pulls the next
    unassigned one from the backlog — the lockstep equivalent of kt_for's
    dynamic scheduling (src/kthread.cpp:41-77). Lockstep machines
    otherwise pay the slowest lane's tick count for the whole batch
    (measured p50 249 / max 619 ticks at B=4096, i.e. ~60% idle
    lanes); refill converts that tail into throughput. Results are
    bit-identical for any `lanes`: each task is owned by exactly one
    lane start-to-finish, and emission order within a task is the
    sequential order.

    Emissions land in rows `out_rows[task]` of `out` (default: the
    task's read, giving per-READ slots). Pass 2 passes
    out_rows=arange so multi-task reads keep per-task buffers (its
    slot-order remap needs them; two live tasks of one read would
    otherwise collide in a scatter).

    NOTE on FMA: an INIT-phase ladder fast-forward (the reference's
    smem-table, src/FMI_search.cpp:1414-1463) was evaluated and
    rejected for this machine: in a lockstep loop the jump logic's
    ~8 extra gather/scatter ops execute EVERY tick (~+20%/tick) to
    save only ~10 ticks per restart — a net wash. The sweep engine
    (ops/smem.py) does use the table, where the fast-forward
    amortizes over all positions at once.
    """
    N = t_read.shape[0]              # backlog size (tasks)
    T = int(lanes) if lanes else N   # worker lanes
    B, L = codes.shape
    codes = jnp.asarray(codes)
    lens = jnp.asarray(lens)
    t_read = jnp.asarray(t_read)
    t_valid = jnp.asarray(t_valid)
    pos_dtype = fmi.pos_dtype
    use2 = getattr(fmi, "cp2_fused", None) is not None
    ksteps = (3 if getattr(fmi, "count3", None) is not None
              else 2) if use2 else 1
    tail3 = ksteps >= 3      # BTAIL consumes three entries per tick
    tidx = jnp.arange(T)
    if out_rows is None:
        out_rows = t_read
    out_rows = jnp.asarray(out_rows, jnp.int32)
    OUT_B = out.m.shape[0]

    t_x = t_x.astype(jnp.int32)
    t_mi_p = t_mi.astype(pos_dtype)

    # initial assignment: lane i takes task i
    ti0 = jnp.minimum(tidx.astype(jnp.int32), N)
    safe0 = jnp.clip(ti0, 0, N - 1)
    live0 = ti0 < N

    # stacks: prev (A) and curr (B); entries (k, l, s, n). m is NOT
    # stored per entry: every entry of one stack generation shares it
    # (x for the forward pushes, the round's j for backward keeps), so
    # it lives in a per-lane scalar mA.
    # Four separate [T, L] columns; the [T, L, 4] array-of-structs
    # layout below is kept behind `aos` (not measured on the GPU).
    aos = False

    def stack():
        if aos:
            return jnp.zeros((T, L, 4), jnp.int32)
        return dict(k=jnp.zeros((T, L), pos_dtype),
                    l=jnp.zeros((T, L), pos_dtype),
                    s=jnp.zeros((T, L), pos_dtype),
                    n=jnp.zeros((T, L), jnp.int32))

    len0 = jnp.where(live0 & t_valid[safe0],
                     lens[t_read[safe0]], 0).astype(jnp.int32)
    st0 = dict(
        phase=jnp.where(live0, P_INIT, P_DONE).astype(jnp.int32),
        ti=ti0,                                # assigned task
        rd=t_read[safe0].astype(jnp.int32),    # its read
        len=len0,                              # its (valid) length
        mi=t_mi_p[safe0],                      # its min_intv
        row=out_rows[safe0],                   # its output row
        nexti=jnp.asarray(min(T, N), jnp.int32),
        x=t_x[safe0],
        nx=t_x[safe0] + 1,                     # next_x accumulator
        j=jnp.zeros((T,), jnp.int32),
        ck=jnp.zeros((T,), pos_dtype),         # forward interval
        cl=jnp.zeros((T,), pos_dtype),
        cs=jnp.zeros((T,), pos_dtype),
        cn=jnp.zeros((T,), jnp.int32),
        A=stack(), cntA=jnp.zeros((T,), jnp.int32),
        Bs=stack(), cntB=jnp.zeros((T,), jnp.int32),
        mA=jnp.zeros((T,), jnp.int32),         # shared m of A entries
        p=jnp.zeros((T,), jnp.int32),          # scan index (0-based)
        rev=jnp.zeros((T,), bool),             # scan A top-down?
        curr_s=jnp.full((T,), -1, pos_dtype),
        kept=jnp.zeros((T,), bool),            # emitted_or_kept
        tick=jnp.zeros((), jnp.int32),
        out=out,
    )
    if with_ticks:
        st0["done_at"] = jnp.where(live0, jnp.int32(-1),
                                   jnp.zeros((T,), jnp.int32))
        # lane-ticks spent per phase (INIT/FWD/BSCAN/BTAIL/DONE) —
        # the planning signal for which phase to attack next
        st0["phase_ticks"] = jnp.zeros((5,), jnp.int64)

    def push(stk, cnt, do, k, l, s, n):
        i = jnp.where(do, cnt, L)
        if aos:
            vals = jnp.stack([k, l, s, n.astype(jnp.int32)], axis=-1)
            return (stk.at[tidx, i].set(vals, mode="drop"),
                    cnt + do.astype(jnp.int32))
        return (dict(k=stk["k"].at[tidx, i].set(k, mode="drop"),
                     l=stk["l"].at[tidx, i].set(l, mode="drop"),
                     s=stk["s"].at[tidx, i].set(s, mode="drop"),
                     n=stk["n"].at[tidx, i].set(n, mode="drop")),
                cnt + do.astype(jnp.int32))

    def push3(stk, cnt, entries):
        """Up to three ordered pushes per lane in ONE scatter per
        stack column (the 2-step FWD tick can retire with a changed
        interval at each depth plus the end-of-walk push)."""
        idxs, cols = [], {f: [] for f in ("k", "l", "s", "n")}
        c = cnt
        for do, k, l, s, n in entries:
            idxs.append(jnp.where(do, c, L))
            cols["k"].append(k)
            cols["l"].append(l)
            cols["s"].append(s)
            cols["n"].append(n)
            c = c + do.astype(jnp.int32)
        idx = jnp.stack(idxs, axis=-1)               # [T, 3]
        stk = dict(
            (f, stk[f].at[tidx[:, None], idx].set(
                jnp.stack(cols[f], axis=-1).astype(stk[f].dtype),
                mode="drop"))
            for f in ("k", "l", "s", "n"))
        return stk, c

    def at(stk, i):
        i = jnp.clip(i, 0, L - 1)
        if aos:
            row = stk[tidx, i]                 # [T, 4] one gather
            return row[:, 0], row[:, 1], row[:, 2], row[:, 3]
        return (stk["k"][tidx, i], stk["l"][tidx, i],
                stk["s"][tidx, i], stk["n"][tidx, i])

    def emit(o, mask, rows, m, n, k, l, s):
        return o.emit_rows(mask, rows, m, n, k, l, s)

    def cond(st):
        return jnp.any(st["phase"] != P_DONE)

    def body(st):
        phase = st["phase"]
        is_init = phase == P_INIT
        is_fwd = phase == P_FWD
        is_bs = phase == P_BSCAN
        is_bt = phase == P_BTAIL

        lens_t = st["len"]
        mi = st["mi"]

        # ----- INIT: build the 1-base interval at x (no ext needed);
        # lanes then fall through to FWD on the NEXT tick with j=x+1.
        # one fused codes gather serves every column the tick needs
        # (x for INIT lanes, j for everyone, j+1.. for K-step FWD)
        ncols = 1 + ksteps
        cols2 = [jnp.clip(st["x"], 0, L - 1)]
        for d in range(ksteps):
            cols2.append(jnp.clip(st["j"] + d, 0, L - 1))
        codes2 = codes[jnp.tile(st["rd"], ncols),
                       jnp.concatenate(cols2)]
        xa = codes2[:T]
        x_ok = (st["x"] < lens_t) & (xa < 4)
        xac = jnp.clip(xa, 0, 3)
        ik = fmi.count[xac]
        il = fmi.count[3 - xac]
        is_ = fmi.count[xac + 1] - fmi.count[xac]

        # ----- pick the extension operands per lane -----
        # FWD: extend cur forward by a=q[j]; BSCAN/BTAIL: extend
        # prev[scan(p)] backward by a=q[j]. With the bigram table the
        # BTAIL lanes also fetch/extend entry p+1 in the same tick
        # (one fused stack gather, one fused checkpoint gather).
        scan_i = jnp.where(st["rev"], st["cntA"] - 1 - st["p"], st["p"])
        if use2:
            nsl = 3 if tail3 else 2
            sis = [jnp.clip(scan_i, 0, L - 1)]
            for d in range(1, nsl):
                sis.append(jnp.clip(
                    jnp.where(st["rev"], st["cntA"] - 1 - d - st["p"],
                              st["p"] + d), 0, L - 1))
            ii = jnp.concatenate(sis)
            tt = jnp.tile(tidx, nsl)
            pr = {f: st["A"][f][tt, ii] for f in ("k", "l", "s", "n")}
            pk, pl, ps, pn = (pr["k"][:T], pr["l"][:T], pr["s"][:T],
                              pr["n"][:T])
            pk2, pl2, ps2, pn2 = (pr["k"][T:2 * T], pr["l"][T:2 * T],
                                  pr["s"][T:2 * T], pr["n"][T:2 * T])
            if tail3:
                pk3, pl3, ps3, pn3 = (pr["k"][2 * T:], pr["l"][2 * T:],
                                      pr["s"][2 * T:], pr["n"][2 * T:])
        else:
            pk, pl, ps, pn = at(st["A"], scan_i)
        pm = st["mA"]
        a_j = codes2[T: 2 * T]
        ext_k = jnp.where(is_fwd, st["ck"], pk)
        ext_l = jnp.where(is_fwd, st["cl"], pl)
        ext_s = jnp.where(is_fwd, st["cs"], ps)
        ac = jnp.clip(a_j, 0, 3)
        sel1 = jnp.where(is_fwd, 3 - ac, ac)
        if use2:
            # K-step tick: ONE fused k-gram-row gather (ops/occ.py
            # backward_ext_steps_and_1) serves the FWD lanes' K
            # extensions AND the backward lanes' single step (the row
            # embeds occ1). Backward lanes pass dummy deeper chars
            # and read only the first-step result.
            step_cs = [codes2[(1 + d) * T: (2 + d) * T]
                       for d in range(1, ksteps)]
            sels = [sel1] + [
                jnp.where(is_fwd, 3 - jnp.clip(cd, 0, 3), jnp.int32(0))
                for cd in step_cs]
            kk = jnp.where(is_fwd, ext_l, ext_k)
            ll = jnp.where(is_fwd, ext_k, ext_l)
            from .occ import backward_ext_steps_and_1
            sides = [(pk3, pl3, ps3, ac)] if tail3 else []
            res = backward_ext_steps_and_1(
                fmi, kk, ll, ext_s, tuple(sels), pk2, pl2, ps2, ac,
                sides=sides)
            if tail3:
                (nkC, nlC, nsC) = res[-1]
                res = res[:-1]
            fsteps, (nkB, nlB, nsB) = res[:-1], res[-1]
            # swap back for fwd lanes; step 1 is shared with backward
            (K1, L1, S1) = fsteps[0]
            nk = jnp.where(is_fwd, L1, K1)
            nl = jnp.where(is_fwd, K1, L1)
            ns = S1
            # fwd-lane view of every step: (k, l, s) swapped
            fw_steps = [(t[1], t[0], t[2]) for t in fsteps]
        else:
            k4, l4, s4 = _ext_all4(fmi, ext_k, ext_l, ext_s, is_fwd)
            take = lambda v: jnp.take_along_axis(
                v, sel1[:, None], axis=-1)[..., 0]
            nk = jnp.where(is_fwd, take(l4), take(k4))
            nl = jnp.where(is_fwd, take(k4), take(l4))
            ns = take(s4)

        out_b = st["out"]
        A, cntA = st["A"], st["cntA"]
        Bs, cntB = st["Bs"], st["cntB"]

        # ================= FWD transition =================
        j_in = st["j"] < lens_t
        a_ok = a_j < 4
        f_run = is_fwd & j_in & a_ok
        s_changed = f_run & (ns != st["cs"])
        s_fail = f_run & (ns < mi)
        f_cont = f_run & ~s_fail
        if not use2:
            # push old interval when s changed (before the fail check)
            A, cntA = push(A, cntA, s_changed, st["ck"], st["cl"],
                           st["cs"], st["cn"])
            # forward end: N/end-of-read (no ext applied) or s-fail
            f_end = is_fwd & (~j_in | ~a_ok | s_fail)
            # post-loop push: smem if s >= mi (old interval on any end)
            A, cntA = push(A, cntA, f_end & (st["cs"] >= mi), st["ck"],
                           st["cl"], st["cs"], st["cn"])
            # all forward-phase A entries share m = x
            mA = jnp.where(f_end, st["x"], st["mA"])
            # next_x = j + 1 is set before the N check in the reference
            nx = jnp.where(is_fwd & j_in, st["j"] + 1, st["nx"])
            nx = jnp.where(s_fail, st["j"], nx)      # next_x = j
            # continue forward
            ck = jnp.where(f_cont, nk, st["ck"])
            cl = jnp.where(f_cont, nl, st["cl"])
            cs = jnp.where(f_cont, ns, st["cs"])
            cn = jnp.where(f_cont, st["j"], st["cn"])
            j = jnp.where(f_cont, st["j"] + 1, st["j"])
        else:
            # K single-step transitions folded into one tick; the
            # fold replays the 1-step machine's exact sequence at
            # every depth (incl. its double-push quirk on an
            # interval-size failure) — bit-identical output
            # (tests/test_kstep.py::test_machine_*step*).
            prev_int = (st["ck"], st["cl"], st["cs"], st["cn"])
            ek, el, es, en = prev_int    # end-of-walk interval
            entries = []
            nx = st["nx"]
            gate = is_fwd                # may this depth run?
            cont_d = is_fwd
            for d in range(ksteps):
                jd = st["j"] + d
                cd = a_j if d == 0 else step_cs[d - 1]
                run_d = gate & (jd < lens_t) & (cd < 4)
                sk, sl, ss_ = fw_steps[d]
                ch_d = run_d & (ss_ != prev_int[2])
                fail_d = run_d & (ss_ < mi)
                cont_d = run_d & ~fail_d
                # push the superseded interval on s-change (before
                # the fail check, as the 1-step machine does)
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
            A, cntA = push3(A, cntA, entries)
            mA = jnp.where(f_end, st["x"], st["mA"])
            ck, cl, cs, cn = ek, el, es, en
            j = jnp.where(cont_d, st["j"] + ksteps, st["j"])

        # after forward end -> enter backward at j = x - 1 with the
        # stack scanned top-down (the reference's prev.reverse())
        phase2 = jnp.where(f_end, P_BSCAN, phase)
        j = jnp.where(f_end, st["x"] - 1, j)
        rev = jnp.where(f_end, True, st["rev"])
        p = jnp.where(f_end, 0, st["p"])
        curr_s = jnp.where(f_end, jnp.asarray(-1, pos_dtype),
                           st["curr_s"])
        kept = jnp.where(f_end, False, st["kept"])
        cntB = jnp.where(f_end, 0, cntB)

        # ============ BACKWARD round prologue checks ============
        # (handled when entering a round: j < 0 or q[j] invalid ends
        # the position; checked for lanes in BSCAN with p == 0)
        round_start = is_bs & (st["p"] == 0)
        b_dead = round_start & ((st["j"] < 0) | (a_j >= 4)
                                | (st["cntA"] == 0))
        # position end: emit scan-order entry 0 of prev if long enough.
        # b_dead implies p == 0, where the scan fetch (pk..pn) IS
        # scan-order entry 0 — no separate stack fetch needed.
        emit0 = b_dead & (st["cntA"] > 0) \
            & ((pn - pm + 1) >= min_seed_len)

        # ================= BSCAN transition =================
        bs_run = is_bs & ~b_dead
        # emit the unextended entry when its extension dies and it is
        # long enough (then switch to the tail)
        die = bs_run & (ns < mi)
        emit_sc = die & ((pn - pm + 1) >= min_seed_len)
        keep_sc = bs_run & ~die & (ns != st["curr_s"])
        hit = emit_sc | keep_sc
        if use2:
            # entry p+1, same tick: a tail entry if p hit, else the
            # scan continues into it (first-hit-break order preserved)
            nb_ok = (st["p"] + 1) < st["cntA"]
            cont_scan = bs_run & ~hit & nb_ok
            die2 = cont_scan & (nsB < mi)
            emit_sc2 = die2 & ((pn2 - pm + 1) >= min_seed_len)
            keep_sc2 = cont_scan & ~die2 & (nsB != st["curr_s"])
            hit2 = emit_sc2 | keep_sc2
            # scan entry p hit -> p+1 opens the tail in the same tick
            cs_mid_s = jnp.where(keep_sc, ns, st["curr_s"])
            keep_tl2s = (bs_run & hit & nb_ok & (nsB >= mi)
                         & (nsB != cs_mid_s))
        else:
            hit2 = jnp.zeros_like(hit)
            emit_sc2 = keep_sc2 = keep_tl2s = hit2
        # emit0/emit_sc/emit_sc2 are mutually exclusive -> one scatter
        if use2:
            e2 = emit_sc2
            out_b = emit(out_b, emit0 | emit_sc | e2, st["row"], pm,
                         jnp.where(e2, pn2, pn),
                         jnp.where(e2, pk2, pk),
                         jnp.where(e2, pl2, pl),
                         jnp.where(e2, ps2, ps))
        else:
            out_b = emit(out_b, emit0 | emit_sc, st["row"], pm, pn,
                         pk, pl, ps)
        kept = kept | hit | hit2
        phase2 = jnp.where(hit | hit2, P_BTAIL, phase2)

        # ================= BTAIL transition =================
        bt_run = is_bt
        # a tail entered past the end (hit on the last scan entry)
        # must not touch the stale slot at p == cntA
        keep_tl = bt_run & (st["p"] < st["cntA"]) & (ns >= mi) \
            & (ns != st["curr_s"])
        # BSCAN and BTAIL are mutually exclusive phases pushing the
        # same values -> one scatter for both
        keep_b = keep_sc | keep_tl
        if use2:
            # second entry resolved in the same tick, against the
            # (possibly just-updated) distinct-s tracker; three
            # sources, identical values: tail entry p+1, scan
            # continuation keep, post-hit first tail entry
            cs_mid = jnp.where(keep_b, ns, st["curr_s"])
            keep_tl2 = (bt_run & (st["p"] + 1 < st["cntA"])
                        & (nsB >= mi) & (nsB != cs_mid))
            keep2 = keep_tl2 | keep_sc2 | keep_tl2s
            entries_b = [(keep_b, nk, nl, ns, pn),
                         (keep2, nkB, nlB, nsB, pn2)]
            curr_s2 = jnp.where(keep2, nsB,
                                jnp.where(keep_b, ns, curr_s))
            if tail3:
                # third tail entry, BTAIL lanes only (scan lanes stay
                # at two — their second entry may open the tail)
                keep_tl3 = (bt_run & (st["p"] + 2 < st["cntA"])
                            & (nsC >= mi) & (nsC != curr_s2))
                entries_b.append((keep_tl3, nkC, nlC, nsC, pn3))
                curr_s2 = jnp.where(keep_tl3, nsC, curr_s2)
            Bs, cntB = push3(Bs, cntB, entries_b)
            curr_s = curr_s2
        else:
            Bs, cntB = push(Bs, cntB, keep_b, nk, nl, ns, pn)
            curr_s = jnp.where(keep_b, ns, curr_s)

        # common backward advance (two entries/tick on the bigram
        # path, except a scan whose own entry was the last)
        b_any = bs_run | bt_run
        if use2:
            bt_adv = 3 if tail3 else 2
            badv = jnp.where(bt_run, bt_adv,
                             jnp.where(bs_run & nb_ok, 2, 1))
        else:
            badv = jnp.int32(1)
        p = jnp.where(b_any, st["p"] + badv, p)
        # round over: scan exhausted without any hit, tail consumed,
        # or (bigram path) this tick's hit had no entries left for
        # its tail
        scan_out = bs_run & ~(hit | hit2) \
            & (st["p"] + badv >= st["cntA"])
        tail_out = bt_run & (st["p"] + badv >= st["cntA"])
        if use2:
            tail_out = tail_out | (bs_run & (hit | hit2)
                                   & (st["p"] + badv >= st["cntA"]))
        round_over = scan_out | tail_out

        # round epilogue: prev <- curr, j -= 1, bottom-up scan. B keeps
        # its (now stale) content — slots past the reset cntB are never
        # read, and the next round's pushes overwrite them in order.
        A = jax.tree_util.tree_map(
            lambda xa, xb: jnp.where(
                round_over.reshape((T,) + (1,) * (xa.ndim - 1)),
                xb, xa),
            A, Bs)
        cntA = jnp.where(round_over, cntB, cntA)
        cntB = jnp.where(round_over, 0, cntB)
        # every entry kept this round shares m = the round's j
        mA = jnp.where(round_over, st["j"], mA)
        j = jnp.where(round_over, st["j"] - 1, j)
        rev = jnp.where(round_over, False, rev)
        p = jnp.where(round_over, 0, p)
        curr_s = jnp.where(round_over, jnp.asarray(-1, pos_dtype),
                           curr_s)
        phase2 = jnp.where(round_over, P_BSCAN, phase2)
        kept = jnp.where(round_over, False, kept)

        # ================= position end -> INIT/finish =================
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
        # (uses no extension; costs one bubble tick per restart)
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

        # ============ task finished -> pull from the backlog ============
        fin = (fin_pos | fin_init) & (phase != P_DONE)
        rank = jnp.cumsum(fin, dtype=jnp.int32) - 1
        ti2 = st["nexti"] + rank
        has = fin & (ti2 < N)
        safe = jnp.clip(ti2, 0, N - 1)
        new_rd = t_read[safe].astype(jnp.int32)
        ti = jnp.where(fin, jnp.where(has, ti2, N), st["ti"])
        rd = jnp.where(has, new_rd, st["rd"])
        len2 = jnp.where(has,
                         jnp.where(t_valid[safe], lens[new_rd], 0),
                         st["len"]).astype(jnp.int32)
        mi2 = jnp.where(has, t_mi_p[safe], st["mi"])
        row2 = jnp.where(has, out_rows[safe], st["row"])
        x2 = jnp.where(has, t_x[safe], x2)
        # an invalid/zero-length task still enters INIT and finishes
        # on its next tick (so mid-backlog invalid tasks — e.g. reads
        # the EMF already resolved — cost one tick, not a dead lane)
        phase2 = jnp.where(fin, jnp.where(has, P_INIT, P_DONE), phase2)
        nexti = st["nexti"] + jnp.sum(fin, dtype=jnp.int32)

        st2 = dict(phase=phase2, ti=ti, rd=rd, len=len2, mi=mi2,
                   row=row2, nexti=nexti, x=x2, nx=nx, j=j, ck=ck,
                   cl=cl, cs=cs, cn=cn, A=A, cntA=cntA, Bs=Bs,
                   cntB=cntB, mA=mA, p=p, rev=rev, curr_s=curr_s,
                   kept=kept, tick=st["tick"] + 1, out=out_b)
        if with_ticks:
            st2["done_at"] = jnp.where(
                (st["done_at"] < 0) & (phase2 == P_DONE),
                st["tick"] + 1, st["done_at"])
            st2["phase_ticks"] = st["phase_ticks"] + jnp.bincount(
                phase, length=5).astype(jnp.int64)
        return st2

    # per-iteration unroll (A/B knob): each while iteration pays a
    # cond reduction and state threading; DONE lanes no-op, so extra
    # sub-ticks are safe.
    import os as _os
    _unroll = max(int(_os.environ.get("BWATPU_MACHINE_UNROLL", 1)), 1)

    def _body_u(s):
        for _ in range(_unroll):
            s = body(s)
        return s

    stf = jax.lax.while_loop(cond, _body_u, st0)
    ob = stf["out"]
    if with_ticks:
        return ob, (stf["tick"], stf["done_at"], stf["phase_ticks"])
    return ob


def seed_strategy_machine(fmi: DeviceFMIndex, codes, lens,
                          max_intv: int, min_seed_len: int,
                          max_out: int, with_ticks: bool = False,
                          lanes: int = None):
    """Pass 3 as a read-per-lane forward-only machine
    (bwtSeedStrategyAllPosOneThread, src/FMI_search.cpp:1662-1730):
    restart-chained forward walks emitting the first seed whose
    interval drops below max_intv at length >= min_seed_len (the
    emitted seed includes the failing step; s == 0 seeds dropped).
    `lanes` < B enables backlog refill as in one_pos_machine."""
    B, L = codes.shape
    T = int(lanes) if lanes else B
    pos_dtype = fmi.pos_dtype
    tidx = jnp.arange(T)
    codes = jnp.asarray(codes)
    lens = jnp.asarray(lens)
    use2 = getattr(fmi, "cp2_fused", None) is not None
    mx = jnp.asarray(max_intv, pos_dtype)

    rd0 = jnp.minimum(tidx.astype(jnp.int32), B)
    safe0 = jnp.clip(rd0, 0, B - 1)
    live0 = rd0 < B
    st0 = dict(
        phase=jnp.where(live0, P_INIT, P_DONE).astype(jnp.int32),
        rd=safe0,
        len=jnp.where(live0, lens[safe0], 0).astype(jnp.int32),
        nextr=jnp.asarray(min(T, B), jnp.int32),
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

        ncols = 3 if use2 else 2
        cols2 = [jnp.clip(st["x"], 0, L - 1),
                 jnp.clip(st["j"], 0, L - 1)]
        if use2:
            cols2.append(jnp.clip(st["j"] + 1, 0, L - 1))
        codes2 = codes[jnp.tile(st["rd"], ncols),
                       jnp.concatenate(cols2)]
        xa = codes2[:T]
        x_ok = (st["x"] < lens_t) & (xa < 4)
        xac = jnp.clip(xa, 0, 3)

        a_j = codes2[T: 2 * T]
        ac = jnp.clip(a_j, 0, 3)
        j_in = st["j"] < lens_t
        a_ok = a_j < 4
        msl_at = lambda col: (col - st["x"] + 1) >= min_seed_len
        if use2:
            # forward-only 2-step (same contract as one_pos_machine's
            # FWD section; at most one hit per tick since the second
            # step only runs when the first missed)
            b_j = codes2[2 * T:]
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
            out = st["out"].emit_rows(
                do_emit, st["rd"], st["x"],
                jnp.where(hit1, st["j"], st["j"] + 1),
                jnp.where(hit1, nk, nk2), jnp.where(hit1, nl, nl2),
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
            k4, l4, s4 = _ext_all4(fmi, st["ck"], st["cl"], st["cs"],
                                   jnp.ones((T,), bool))
            sel = (3 - ac)[:, None]
            take = lambda v: jnp.take_along_axis(v, sel,
                                                 axis=-1)[..., 0]
            nk, nl, ns = take(l4), take(k4), take(s4)

            f_run = is_fwd & j_in & a_ok
            # seed hit: s dropped below max_intv at sufficient length
            hit = f_run & (ns < mx) & msl_at(st["j"])
            do_emit = hit & (ns > 0)
            out = st["out"].emit_rows(do_emit, st["rd"], st["x"],
                                      st["j"], nk, nl, ns)
            f_end = is_fwd & (~j_in | ~a_ok | hit)
            f_cont = f_run & ~hit

            ck = jnp.where(f_cont, nk, st["ck"])
            cl = jnp.where(f_cont, nl, st["cl"])
            cs = jnp.where(f_cont, ns, st["cs"])
            j = jnp.where(f_cont, st["j"] + 1, st["j"])

            # next_x = j + 1 (set before the N check)
            nx = jnp.where(j_in, st["j"] + 1, st["j"])
        nx = jnp.where(is_init, st["x"] + 1, nx)
        x2 = jnp.where(f_end, nx, st["x"])
        fin_f = f_end & (x2 >= lens_t)
        phase2 = jnp.where(f_end & ~fin_f, P_INIT, phase)

        # INIT: 1-base interval, then forward from x + 1
        init_bad = is_init & ~x_ok
        xb = jnp.where(init_bad, st["x"] + 1, x2)
        fin_i = init_bad & (xb >= lens_t)
        phase2 = jnp.where(init_bad & ~fin_i, P_INIT, phase2)
        init_go = is_init & x_ok
        ck = jnp.where(init_go, fmi.count[xac], ck)
        cl = jnp.where(init_go, fmi.count[3 - xac], cl)
        cs = jnp.where(init_go, fmi.count[xac + 1] - fmi.count[xac], cs)
        j = jnp.where(init_go, st["x"] + 1, j)
        phase2 = jnp.where(init_go, P_FWD, phase2)

        # read finished -> pull the next from the backlog
        fin = (fin_f | fin_i) & (phase != P_DONE)
        rank = jnp.cumsum(fin, dtype=jnp.int32) - 1
        r2 = st["nextr"] + rank
        has = fin & (r2 < B)
        safe = jnp.clip(r2, 0, B - 1)
        rd = jnp.where(has, safe, st["rd"])
        len2 = jnp.where(has, lens[safe], st["len"]).astype(jnp.int32)
        xb = jnp.where(has, 0, xb)
        phase2 = jnp.where(fin, jnp.where(has, P_INIT, P_DONE), phase2)
        nextr = st["nextr"] + jnp.sum(fin, dtype=jnp.int32)

        return dict(phase=phase2, rd=rd, len=len2, nextr=nextr,
                    x=xb, j=j, ck=ck, cl=cl, cs=cs,
                    tick=st["tick"] + 1, out=out)

    # per-iteration unroll (A/B knob): each while iteration pays a
    # cond reduction and state threading; DONE lanes no-op, so extra
    # sub-ticks are safe.
    import os as _os
    _unroll = max(int(_os.environ.get("BWATPU_MACHINE_UNROLL", 1)), 1)

    def _body_u(s):
        for _ in range(_unroll):
            s = body(s)
        return s

    stf = jax.lax.while_loop(cond, _body_u, st0)
    ob = stf["out"]
    if with_ticks:
        return ob, stf["tick"]
    return ob


def collect_smems_rl(fmi: DeviceFMIndex, codes, lens, *,
                     min_seed_len: int, split_len: int,
                     split_width: int, max_mem_intv: int,
                     max_out: int = None, lanes: int = None):
    """Three-pass SMEM collection on read-per-lane machines; output is
    bit-identical to collect_smems_device (mem_collect_smem,
    src/bwamem.cpp:648-795). Pass 2 needs no covers-x filter: the
    onePos walk inherently only finds matches through x.

    `lanes` (< B) runs each pass with that many worker lanes pulling
    reads/tasks from the backlog (see one_pos_machine): fewer lanes
    mean cheaper ticks and less lockstep-tail waste, at more ticks —
    the sweet spot is hardware-dependent (tune via
    PipelineConfig.seed_lanes / BENCH_SEED_LANES)."""
    from .smem import _emit_compact

    B, L = codes.shape
    M = max_out or L
    bidx = jnp.arange(B, dtype=jnp.int32)
    zi = jnp.zeros((B,), jnp.int32)

    p1 = one_pos_machine(
        fmi, codes, lens, bidx, zi, jnp.ones((B,), jnp.int32),
        lens > 0, True, min_seed_len, M,
        SmemBuf.empty(B, M, fmi.pos_dtype), lanes=lanes)

    # pass-2 task extraction (same recipe as smems_reseed)
    M1 = p1.m.shape[1]
    valid = jnp.arange(M1)[None, :] < p1.cnt[:, None]
    cand = (valid
            & ((p1.n + 1 - p1.m) >= split_len)
            & (p1.s <= split_width))
    from .smem import compact_indices
    flat = cand.reshape(B * M1)
    T = 2 * B          # see smems_reseed: ~1.5 tasks/read typical
    order, t_valid = compact_indices(flat, T)
    # per-read reseed-task overflow (see smems_reseed): saturate the
    # final count so the aligner's smem_of retry machinery fires
    rank = jnp.cumsum(flat, dtype=jnp.int32) - 1
    reseed_of = jnp.any((flat & (rank >= T)).reshape(B, M1), axis=1)
    t_read = (order // M1).astype(jnp.int32)
    t_slot = order % M1
    t_x = ((p1.n[t_read, t_slot] + 1 + p1.m[t_read, t_slot]) >> 1)
    t_mi = jnp.where(t_valid, p1.s[t_read, t_slot] + 1, 1)
    p2t = one_pos_machine(
        fmi, codes, lens, t_read, t_x.astype(jnp.int32),
        t_mi.astype(jnp.int32), t_valid, False, min_seed_len, M,
        SmemBuf.empty(T, M, fmi.pos_dtype), lanes=lanes,
        out_rows=jnp.arange(T, dtype=jnp.int32))
    # remap task rows -> read rows (tasks are read-sorted)
    tmask = (jnp.arange(M)[None, :] < p2t.cnt[:, None]) \
        & t_valid[:, None]
    p2 = _emit_compact(tmask, p2t.m, p2t.n, p2t.k, p2t.l, p2t.s,
                       SmemBuf.empty(B, M, fmi.pos_dtype),
                       rows=t_read)

    parts = [p1, p2]
    if max_mem_intv > 0:
        parts.append(seed_strategy_machine(
            fmi, codes, lens, max_mem_intv, min_seed_len + 1, M,
            lanes=lanes))
    combined = concat_smems(*parts)
    valid = jnp.concatenate(
        [jnp.arange(b.m.shape[1])[None, :] < b.cnt[:, None]
         for b in parts], axis=1)
    # int32 key: m, n < 2^15 for any supported read length
    key = (combined.m << 16) | combined.n
    key = jnp.where(valid, key, jnp.int32(2 ** 30))
    order = jnp.argsort(key, axis=1)
    take = lambda arr: jnp.take_along_axis(arr, order, axis=1)
    cnt = jnp.where(reseed_of, combined.m.shape[1], combined.cnt)
    return SmemBuf(take(combined.m), take(combined.n), take(combined.k),
                   take(combined.l), take(combined.s), cnt)
