"""Batched banded global alignment with traceback (device CIGAR kernel).

Batched formulation of ksw_global2 (src/ksw.cpp:558-672): the DP runs one
pair per lane with the query axis vectorized (same prefix-max F trick as
ops/bsw.py but with -inf semantics and strict-inequality direction
bits); the direction matrix is banked per row in HBM and a lockstep
traceback walk emits per-step ops, which the host run-length encodes
into CIGARs (bwa_gen_cigar2's NM/MD wrapper stays host-side, it is
string work).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

NEG_INF = -(1 << 29)


class KswgResult(NamedTuple):
    score: jax.Array      # [P] int32
    ops: jax.Array        # [P, S] int8 traceback ops (0=M,1=I,2=D), -1 pad
    n_ops: jax.Array      # [P] int32 number of recorded steps
    tail_del: jax.Array   # [P] leading deletion run length
    tail_ins: jax.Array   # [P] leading insertion run length


@partial(jax.jit, static_argnames=("o_del", "e_del", "o_ins",
                                    "e_ins"))
def ksw_global_batch(qs, q_lens, ts, t_lens, w_p,
                     o_del: int, e_del: int, o_ins: int, e_ins: int,
                     mat) -> KswgResult:
    """Banded global DP + traceback for a batch of pairs.

    qs [P, QL], ts [P, TL] int32 codes; q_lens/t_lens/w_p [P] int32.
    The caller guarantees w_p >= |tlen - qlen| (bwa_gen_cigar2 does).
    """
    P, QL = qs.shape
    TL = ts.shape[1]
    i32 = jnp.int32
    q_lens = q_lens.astype(i32)
    t_lens = t_lens.astype(i32)
    w_p = w_p.astype(i32)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    mat = jnp.asarray(mat, dtype=i32)
    q_codes = jnp.clip(qs, 0, 4).astype(i32)

    colq = jnp.arange(QL + 1, dtype=i32)[None, :]
    colj = jnp.arange(QL, dtype=i32)[None, :]
    bpx = jnp.arange(P)

    # first row: eh_h[0]=0; eh_h[j]=-(o_ins+e_ins*j) for 1<=j<=w; else -inf
    first = -(o_ins + e_ins * colq)
    eh_h = jnp.where(colq == 0, 0,
                     jnp.where((colq <= w_p[:, None])
                               & (colq <= q_lens[:, None]), first, NEG_INF)
                     ).astype(i32)
    eh_h = jnp.concatenate([eh_h, jnp.full((P, 1), NEG_INF, i32)], axis=1)
    eh_e = jnp.full((P, QL + 2), NEG_INF, dtype=i32)

    z = jnp.zeros((P, TL, QL), dtype=jnp.uint8)

    def row(i, carry):
        eh_h, eh_e, z = carry
        alive = i < t_lens
        tb = jnp.clip(ts[:, jnp.minimum(i, TL - 1)], 0, 4)
        # arithmetic query profile (bwa_fill_scmat structure) instead
        # of a per-element table gather
        is_n = (tb[:, None] == 4) | (q_codes == 4)
        qprof = jnp.where(is_n, mat[0, 4],
                          jnp.where(tb[:, None] == q_codes,
                                    mat[0, 0], mat[0, 1])).astype(i32)

        beg = jnp.maximum(i - w_p, 0)
        end = jnp.minimum(i + w_p + 1, q_lens)
        h1_first = jnp.where(beg == 0, -(o_del + e_del * (i + 1)),
                             NEG_INF).astype(i32)

        in_band = (colj >= beg[:, None]) & (colj < end[:, None])
        Hprev = eh_h[:, :QL]
        Eprev = eh_e[:, :QL]
        M = Hprev + qprof
        M = jnp.maximum(M, NEG_INF)

        d_h = jnp.where(M >= Eprev, 0, 1).astype(jnp.uint8)
        pre = jnp.maximum(M, Eprev)

        # F scan with -inf base; strict bit f_cur - e_ins > m - oe_ins.
        t_ins = jnp.maximum(M - oe_ins, NEG_INF)
        keyed = jnp.where(in_band, t_ins + e_ins * colj, NEG_INF)
        run = jax.lax.cummax(keyed, axis=1)
        run_shift = jnp.concatenate(
            [jnp.full((P, 1), NEG_INF, i32), run[:, :-1]], axis=1)
        f = jnp.maximum(run_shift - e_ins * (colj - 1), NEG_INF)
        f = jnp.where(colj == beg[:, None], NEG_INF, f)

        d_h = jnp.where(pre >= f, d_h, 2).astype(jnp.uint8)
        H = jnp.maximum(pre, f)

        t_del = jnp.maximum(M - oe_del, NEG_INF)
        e_bit = (Eprev - e_del) > t_del
        E_next = jnp.maximum(Eprev - e_del, t_del)
        # F bit (value 2 in bits [4:6]): decayed running F beats opening.
        f_bit = (f - e_ins) > t_ins

        d = (d_h | (e_bit.astype(jnp.uint8) << 2)
             | (f_bit.astype(jnp.uint8) << 5))
        # bank the row at absolute columns (the z buffer is the full
        # rectangle anyway; saves the band-shift gathers on both ends)
        drow = jnp.where(in_band, d, 0)
        z = jax.lax.dynamic_update_slice(
            z, jnp.where(alive[:, None], drow, z[:, i, :])[:, None, :],
            (0, i, 0))

        # shifted write-back
        Hshift = jnp.concatenate([jnp.full((P, 1), NEG_INF, i32), H], axis=1)
        upd_h = (colq >= beg[:, None] + 1) & (colq <= end[:, None])
        new_h = jnp.where(upd_h, Hshift, eh_h[:, : QL + 1])
        new_h = jnp.where(colq == beg[:, None], h1_first[:, None], new_h)
        upd_e = (colq >= beg[:, None]) & (colq < end[:, None])
        new_e = jnp.where(upd_e, jnp.concatenate(
            [E_next, jnp.full((P, 1), NEG_INF, i32)], axis=1)[:, : QL + 1],
            eh_e[:, : QL + 1])
        at_end = colq == jnp.clip(end, 0, QL)[:, None]
        new_e = jnp.where(at_end, NEG_INF, new_e)
        h1_last = jnp.sum(jnp.where(at_end, Hshift, 0), axis=1,
                          dtype=i32)
        h1_last = jnp.where(end > beg, h1_last, h1_first)
        new_h = jnp.where(at_end, h1_last[:, None], new_h)

        eh_h = jnp.where(alive[:, None],
                         jnp.concatenate([new_h, eh_h[:, QL + 1:]], axis=1),
                         eh_h)
        eh_e = jnp.where(alive[:, None],
                         jnp.concatenate([new_e, eh_e[:, QL + 1:]], axis=1),
                         eh_e)
        return eh_h, eh_e, z

    eh_h, eh_e, z = jax.lax.fori_loop(0, TL, row, (eh_h, eh_e, z))
    score = jnp.sum(
        jnp.where(jnp.arange(QL + 2, dtype=i32)[None, :]
                  == jnp.clip(q_lens, 0, QL + 1)[:, None], eh_h, 0),
        axis=1, dtype=i32)

    # ---------------- lockstep traceback ----------------
    S = QL + TL + 2
    ops = jnp.full((P, S), -1, dtype=jnp.int8)

    i0 = t_lens - 1
    k0 = jnp.minimum(i0 + w_p + 1, q_lens) - 1

    def tb_cond(st):
        i, k, which, sc, ops = st
        return jnp.any((i >= 0) & (k >= 0))

    def tb_body(st):
        i, k, which, sc, ops = st
        active = (i >= 0) & (k >= 0)
        d = z[bpx, jnp.clip(i, 0, TL - 1),
              jnp.clip(k, 0, QL - 1)].astype(i32)
        which_new = (d >> (which << 1)) & 3
        which = jnp.where(active, which_new, which)
        op = jnp.where(which == 0, 0,
                       jnp.where(which == 1, 2, 1)).astype(jnp.int8)
        ops = ops.at[bpx, jnp.where(active, sc, S)].set(op, mode="drop")
        sc = sc + active.astype(i32)
        di = jnp.where(active & (which != 2), 1, 0)
        dk = jnp.where(active & (which != 1), 1, 0)
        return i - di, k - dk, which, sc, ops

    st0 = (i0, k0, jnp.zeros((P,), i32), jnp.zeros((P,), i32), ops)
    i_f, k_f, _, n_ops, ops = jax.lax.while_loop(tb_cond, tb_body, st0)

    return KswgResult(score=score, ops=ops, n_ops=n_ops,
                      tail_del=jnp.maximum(i_f + 1, 0),
                      tail_ins=jnp.maximum(k_f + 1, 0))


def rle_cigar(ops_row, n_ops: int, tail_del: int, tail_ins: int):
    """Host helper: recorded traceback -> cigar [(len, op)] list.

    The recorded sequence is alignment-end-first; leading D/I runs are
    appended then the whole list reversed (push_cigar semantics,
    src/ksw.cpp:655-668)."""
    seq = list(ops_row[:n_ops])
    seq.extend([2] * tail_del)
    seq.extend([1] * tail_ins)
    seq.reverse()
    out = []
    for op in seq:
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + 1, op)
        else:
            out.append((1, int(op)))
    return out
