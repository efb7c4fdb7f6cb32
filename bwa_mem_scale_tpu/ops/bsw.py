"""Batched banded Smith-Waterman extension on device.

Array formulation of the reference's BSW kernel family
(scalarBandedSWA spec src/bandedSWA.cpp:116-238; AVX512 inter-sequence
kernels :713+): one alignment pair per vector lane, the DP row loop
vectorized across both the pair axis and the query axis. The row-wise
F-dependency (a running max with gap-extension decay) is computed with a
prefix-max scan instead of the sequential inner loop, so each target row
is pure [P, Q] VPU work:

    t_j   = max(M_j - oe_ins, 0)
    f_j   = max_{k<j}(t_k - (j-1-k) * e_ins)
          = cummax(t_k + k*e_ins) - (j-1)*e_ins

All semantics match the scalar reference exactly, including the
h0-seeded first row, z-drop, per-row adaptive band shrink (which reads
the *shifted* H row, as the reference does), the stale-cell behaviour at
band edges, and the (score, qle, tle, gtle, gscore, max_off) outputs.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class BswBatchResult(NamedTuple):
    score: jax.Array
    qle: jax.Array
    tle: jax.Array
    gtle: jax.Array
    gscore: jax.Array
    max_off: jax.Array


def banded_swa_batch(qs, q_lens, ts, t_lens, h0, w: int,
                     o_del: int, e_del: int, o_ins: int, e_ins: int,
                     zdrop: int, mat, end_bonus: int = 0
                     ) -> BswBatchResult:
    """Batched banded extension.

    qs [P, QL] int32 query codes (pad arbitrary), q_lens [P],
    ts [P, TL] int32 target codes, t_lens [P], h0 [P] int32.
    Returns int32 result arrays [P].
    """
    P, QL = qs.shape
    TL = ts.shape[1]
    i32 = jnp.int32
    q_lens = q_lens.astype(i32)
    t_lens = t_lens.astype(i32)
    h0 = h0.astype(i32)
    qs = qs.astype(i32)
    ts = ts.astype(i32)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    # The scoring matrix is always bwa's fill_scmat shape (match a on
    # the diagonal, -b off it, -1 vs N; src/bwa.cpp:98-110) — compute
    # the query profile arithmetically instead of a [P, QL] table
    # gather per row.
    import numpy as _np
    mat_np = _np.asarray(mat)
    mx = int(mat_np.max())
    sc_match = int(mat_np[0, 0])
    sc_mis = int(mat_np[0, 1])
    sc_n = int(mat_np[0, 4])

    colq = jnp.arange(QL + 1, dtype=jnp.int32)[None, :]        # [1, QL+1] (eh row index)
    q_codes = jnp.clip(qs, 0, 4)

    # -- first row (h0 ramp) -----------------------------------------------
    # eh_h[0] = h0; eh_h[1] = max(h0-oe_ins, 0); eh_h[j] = eh_h[j-1]-e_ins
    # while > e_ins... exactly: fill while previous > e_ins.
    h_of_1 = jnp.maximum(h0 - oe_ins, 0)
    ramp = h_of_1[:, None] - e_ins * (colq[:, 2:] - 1)   # j >= 2 candidate
    # valid while eh[j-1] > e_ins  <=>  ramp value at j-1 > e_ins
    prev_val = jnp.concatenate([h_of_1[:, None], ramp[:, :-1]], axis=1)
    ramp = jnp.where(prev_val > e_ins, jnp.maximum(ramp, 0), 0)
    # cut the ramp after the first failure
    ok = prev_val > e_ins
    ok = jnp.cumprod(ok.astype(i32), axis=1).astype(bool)
    ramp = jnp.where(ok, ramp, 0)
    eh_h = jnp.concatenate([h0[:, None].astype(i32), h_of_1[:, None].astype(i32), ramp.astype(i32)], axis=1)
    eh_h = jnp.where(colq <= q_lens[:, None], eh_h, 0)
    eh_h = jnp.concatenate(
        [eh_h, jnp.zeros((P, 1), dtype=i32)], axis=1)     # [P, QL+2]
    eh_e = jnp.zeros((P, QL + 2), dtype=i32)

    # -- clamp w per pair (C-truncation integer division) -------------------
    def _trunc_div(n, d):
        return jnp.where(n >= 0, n // d, -((-n) // d))

    max_ins = _trunc_div(q_lens.astype(i32) * mx + end_bonus - o_ins, e_ins) + 1
    max_del = _trunc_div(q_lens.astype(i32) * mx + end_bonus - o_del, e_del) + 1
    w_p = jnp.minimum(jnp.asarray(w, i32),
                      jnp.minimum(jnp.maximum(max_ins, 1),
                                  jnp.maximum(max_del, 1))).astype(i32)

    colj = jnp.arange(QL, dtype=jnp.int32)[None, :]            # DP column index j

    class _St(NamedTuple):
        i: jax.Array
        eh_h: jax.Array
        eh_e: jax.Array
        beg: jax.Array
        end: jax.Array
        max_sc: jax.Array
        max_i: jax.Array
        max_j: jax.Array
        max_ie: jax.Array
        gscore: jax.Array
        max_off: jax.Array
        alive: jax.Array

    def cond(st: _St):
        return jnp.any(st.alive)

    def body(st: _St):
        i = st.i                       # scalar row index (lockstep)
        alive = st.alive & (i < t_lens)
        tb = jax.lax.dynamic_slice(ts, (jnp.int32(0), i),
                                   (P, 1))[:, 0]
        tb = jnp.clip(tb, 0, 4)
        is_n = (tb[:, None] == 4) | (q_codes == 4)
        qprof = jnp.where(is_n, sc_n,
                          jnp.where(tb[:, None] == q_codes,
                                    sc_match, sc_mis)).astype(i32)

        beg = jnp.maximum(st.beg, i - w_p)
        end = jnp.minimum(jnp.minimum(st.end, i + w_p + 1), q_lens)
        h1_first = jnp.where(beg == 0,
                             jnp.maximum(h0 - (o_del + e_del * (i + 1)), 0),
                             0)

        in_band = (colj >= beg[:, None]) & (colj < end[:, None])
        Hprev = st.eh_h[:, :QL]         # eh_h[j] = H(i-1, j-1)
        Eprev = st.eh_e[:, :QL]         # eh_e[j] = E(i, j)
        M = jnp.where(Hprev != 0, Hprev + qprof, 0)
        pre = jnp.maximum(M, Eprev)

        # F via prefix-max with decay; f at column beg is 0.
        t_ins = jnp.maximum(M - oe_ins, 0)
        keyed = jnp.where(in_band, t_ins + e_ins * colj, -(1 << 30))
        run = jax.lax.cummax(keyed, axis=1)
        # f_j uses t up to j-1: shift right by one.
        run_shift = jnp.concatenate(
            [jnp.full((P, 1), -(1 << 30), i32), run[:, :-1]], axis=1)
        f = run_shift - e_ins * (colj - 1)
        f = jnp.maximum(f, 0)  # f is never negative (t >= 0, f0 = 0)
        f = jnp.where(colj == beg[:, None], 0, f)

        H = jnp.maximum(pre, f)
        H = jnp.where(in_band, H, 0)

        # row max and its LAST attaining column (mj moves on ties)
        Hm = jnp.where(in_band, H, -1)
        mrow = jnp.max(Hm, axis=1)
        mrow = jnp.maximum(mrow, 0)
        rev = Hm[:, ::-1]
        mj_last = QL - 1 - jnp.argmax(rev, axis=1).astype(i32)
        mj = jnp.where(mrow > 0, mj_last, -1)
        # m == 0 case: reference keeps mj = -1 and breaks anyway.

        E_next = jnp.maximum(jnp.maximum(M - oe_del, 0), Eprev - e_del)

        # Write back the shifted row: eh_h[j] = H(i, j-1) on [beg, end],
        # eh_e[j] = E(i+1, j) on [beg, end), eh_e[end] = 0.
        Hshift = jnp.concatenate(
            [jnp.zeros((P, 1), i32), H], axis=1)           # [P, QL+1]
        upd_h = (colq >= beg[:, None] + 1) & (colq <= end[:, None])
        new_h = jnp.where(upd_h, Hshift, st.eh_h[:, : QL + 1])
        new_h = jnp.where(colq == beg[:, None], h1_first[:, None], new_h)
        upd_e = (colq >= beg[:, None]) & (colq < end[:, None])
        new_e = jnp.where(upd_e, jnp.concatenate(
            [E_next, jnp.zeros((P, 1), i32)], axis=1)[:, : QL + 1],
            st.eh_e[:, : QL + 1])
        # per-lane end-column writes as masked selects, not scatters
        end_c = jnp.clip(end, 0, QL)
        at_end = colq == end_c[:, None]
        new_e = jnp.where(at_end, 0, new_e)
        # h at index `end` = H(i, end-1) = h1 after loop
        h1_last = jnp.sum(jnp.where(at_end, Hshift, 0), axis=1,
                          dtype=i32)
        h1_last = jnp.where(end > beg, h1_last, h1_first)
        new_h = jnp.where(at_end, h1_last[:, None], new_h)

        eh_h2 = jnp.where(alive[:, None],
                          jnp.concatenate([new_h, st.eh_h[:, QL + 1:]],
                                          axis=1), st.eh_h)
        eh_e2 = jnp.where(alive[:, None],
                          jnp.concatenate([new_e, st.eh_e[:, QL + 1:]],
                                          axis=1), st.eh_e)

        # gscore update when the band reached the query end
        reach = alive & (end == q_lens)
        gupd = reach & (st.gscore <= h1_last)
        gscore = jnp.where(gupd, h1_last, st.gscore)
        max_ie = jnp.where(gupd, i, st.max_ie)

        # break on zero row
        brk0 = alive & (mrow == 0)

        better = alive & ~brk0 & (mrow > st.max_sc)
        off = jnp.abs(mj - i)
        max_off = jnp.where(better, jnp.maximum(st.max_off, off),
                            st.max_off)
        # z-drop check for non-improving rows
        diag_i = i - st.max_i
        diag_j = mj - st.max_j
        del_side = diag_i > diag_j
        zdelta = jnp.where(
            del_side,
            st.max_sc - mrow - (diag_i - diag_j) * e_del,
            st.max_sc - mrow - (diag_j - diag_i) * e_ins)
        brkz = (alive & ~brk0 & ~better & (zdrop > 0)
                & (zdelta > zdrop))

        max_sc = jnp.where(better, mrow, st.max_sc)
        max_i = jnp.where(better, i, st.max_i)
        max_j = jnp.where(better, mj, st.max_j)

        # adaptive band shrink on the *new* eh arrays
        zero = (new_h == 0) & (new_e == 0)                 # [P, QL+1]
        cand = ~zero & (colq >= beg[:, None]) & (colq < end[:, None])
        any_lead = jnp.any(cand, axis=1)
        beg2 = jnp.where(any_lead, jnp.argmax(cand, axis=1).astype(i32), end)
        cand2 = ~zero & (colq >= beg2[:, None]) & (colq <= end[:, None])
        any_tail = jnp.any(cand2, axis=1)
        last_nz = QL - jnp.argmax(cand2[:, ::-1], axis=1).astype(i32)
        jpos = jnp.where(any_tail, last_nz, beg2 - 1)
        end2 = jnp.minimum(jpos + 2, q_lens)

        alive2 = alive & ~brk0 & ~brkz
        beg3 = jnp.where(alive, beg2, st.beg)
        end3 = jnp.where(alive, end2, st.end)
        return _St(i + 1, eh_h2, eh_e2, beg3, end3, max_sc, max_i,
                   max_j, max_ie, gscore, max_off, alive2)

    st0 = _St(
        i=jnp.int32(0),
        eh_h=eh_h, eh_e=eh_e,
        beg=jnp.zeros((P,), i32), end=q_lens.astype(i32),
        max_sc=h0.astype(i32),
        max_i=jnp.full((P,), -1, i32), max_j=jnp.full((P,), -1, i32),
        max_ie=jnp.full((P,), -1, i32),
        gscore=jnp.full((P,), -1, i32),
        max_off=jnp.zeros((P,), i32),
        alive=(t_lens > 0) & (q_lens > 0),
    )
    # Note: i is per-pair but advances in lockstep; alive lanes with
    # shorter targets retire early via the (i < t_lens) mask.
    #
    # Several target rows per loop iteration (a pure unroll: every
    # row update is alive-masked, so extra sub-steps after a lane
    # retires are no-ops). This kernel serves the CPU; the GPU runs
    # ops/bsw_pallas.py.
    def body_u(s):
        for _ in range(4):
            s = body(s)
        return s

    stf = jax.lax.while_loop(cond, body_u, st0)

    return BswBatchResult(score=stf.max_sc, qle=stf.max_j + 1,
                          tle=stf.max_i + 1, gtle=stf.max_ie + 1,
                          gscore=stf.gscore, max_off=stf.max_off)
