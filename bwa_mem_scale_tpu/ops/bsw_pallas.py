"""Pallas kernel (Triton route) for batched banded Smith-Waterman
extension on an NVIDIA GPU.

Same semantics as ops/bsw.banded_swa_batch, bit for bit; the scalar
spec for both is the reference's scalarBandedSWA
(src/bandedSWA.cpp:116-238), ported in ref/bsw.scalar_banded_swa.

The jnp kernel runs one `lax.while_loop` iteration per target row over
[P, QL] H and E planes: XLA cannot fuse across iterations, so every
row re-reads and re-writes both planes from device memory in several
kernel launches. Here one program owns a block of BP pairs, one pair
per lane (bwa-mem2's inter-sequence SIMD layout), and runs the whole
DP inside the program:

- the target-row loop runs until every lane of the block has retired
  (z-drop, zero row or end of target); the wrapper sorts pairs by
  target length so short blocks exit early;
- inside each row the query columns are walked in order, so H's left
  neighbour and the F recurrence are per-lane carries, exactly as in
  the scalar loop (no prefix-max scan, no row shift);
- the per-lane H/E rows live in a [QL + 2, BP] scratch that the
  program indexes by column (two extra outputs, discarded), small
  enough to stay in L1/L2.

Rows are indexed [column, lane] so every load and store of one column
is one coalesced access across the block's lanes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .bsw import BswBatchResult

_BIG = 1 << 30
# pairs per program, one lane per pair and one warp per 32 lanes:
# 32 measured fastest on the H100 against 64 and 128 (PERF.md)
BLOCK = 32


def _bsw_kernel(meta_ref, qs_ref, ts_ref, out_ref, eh_h_ref, eh_e_ref, *,
                TL, o_del, e_del, o_ins, e_ins, zdrop,
                sc_match, sc_mis, sc_n):
    # Every constant is an explicit int32: under jax_enable_x64 a bare
    # Python int meeting another Python int would trace as int64.
    c = jnp.int32
    R = eh_h_ref.shape[0]                    # QL + 2 eh rows
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins

    q_lens = meta_ref[0, :]                  # [BP]
    t_lens = meta_ref[1, :]
    h0 = meta_ref[2, :]
    w_p = meta_ref[3, :]
    zero = jnp.zeros_like(q_lens)

    # -- first eh row: h0, then the decaying insertion ramp -------------
    h1_0 = jnp.maximum(h0 - c(oe_ins), zero)

    def init(j, prev):
        v = jnp.where(j == c(0), h0,
                      jnp.where(j == c(1), h1_0,
                                jnp.where(prev > c(e_ins),
                                          prev - c(e_ins), zero)))
        eh_h_ref[j, :] = jnp.where(j <= q_lens, v, zero)
        eh_e_ref[j, :] = zero
        return v

    jax.lax.fori_loop(c(0), c(R), init, zero)

    def row_cond(st):
        return jnp.max(st[-1]) > c(0)

    def row_body(st):
        (i, beg0, end0, max_sc, max_i, max_j, max_ie, gscore, max_off,
         alive_i) = st
        alive = (alive_i > c(0)) & (i < t_lens)
        tb = ts_ref[jnp.minimum(i, c(TL - 1)), :]
        tb = jnp.minimum(jnp.maximum(tb, zero), c(4))
        beg = jnp.maximum(beg0, i - w_p)
        end = jnp.minimum(jnp.minimum(end0, i + w_p + c(1)), q_lens)
        h1_first = jnp.where(
            beg == c(0),
            jnp.maximum(h0 - (c(o_del) + c(e_del) * (i + c(1))), zero),
            zero)
        # columns [beg, end) are computed; column `end` receives the
        # row's last H and a zero E (it may lie left of beg)
        jlo = jnp.min(jnp.where(alive, jnp.minimum(beg, end), c(_BIG)))
        jhi = jnp.max(jnp.where(alive, end, c(-1))) + c(1)

        def col(j, cs):
            h1, f, mrow, mj, lead, last = cs
            act = alive & (j >= beg) & (j < end)
            at_end = alive & (j == end)
            m_old = eh_h_ref[j, :]               # H(i-1, j-1)
            e = eh_e_ref[j, :]                   # E(i, j)
            qc = jnp.minimum(jnp.maximum(qs_ref[j, :], zero), c(4))
            sc = jnp.where((tb == c(4)) | (qc == c(4)), c(sc_n),
                           jnp.where(tb == qc, c(sc_match), c(sc_mis)))
            m = jnp.where(m_old != c(0), m_old + sc, zero)
            h = jnp.maximum(jnp.maximum(m, e), f)
            e_new = jnp.maximum(e - c(e_del),
                                jnp.maximum(m - c(oe_del), zero))
            f_new = jnp.maximum(f - c(e_ins),
                                jnp.maximum(m - c(oe_ins), zero))
            e_new = jnp.where(at_end, zero, e_new)
            wr = act | at_end
            eh_h_ref[j, :] = jnp.where(wr, h1, m_old)
            eh_e_ref[j, :] = jnp.where(wr, e_new, e)
            # band-shrink bookkeeping on the freshly written cells
            nz = (h1 != c(0)) | (e_new != c(0))
            lead = jnp.where(act & nz & (lead == c(_BIG)), j, lead)
            last = jnp.where(wr & nz, j, last)
            upd = act & (mrow <= h)              # LAST attaining column
            mj = jnp.where(upd, j, mj)
            mrow = jnp.where(upd, h, mrow)
            h1 = jnp.where(act, h, h1)
            f = jnp.where(act, f_new, f)
            return h1, f, mrow, mj, lead, last

        h1, _, mrow, mj, lead, last = jax.lax.fori_loop(
            jlo, jhi, col,
            (h1_first, zero, zero, zero - c(1), zero + c(_BIG),
             zero - c(1)))

        # gscore when the band reached the query end
        gupd = alive & (end == q_lens) & (gscore <= h1)
        gscore2 = jnp.where(gupd, h1, gscore)
        max_ie2 = jnp.where(gupd, i, max_ie)

        brk0 = alive & (mrow == c(0))
        better = alive & ~brk0 & (mrow > max_sc)
        off = jnp.maximum(mj - i, i - mj)
        max_off2 = jnp.where(better, jnp.maximum(max_off, off), max_off)
        diag_i = i - max_i
        diag_j = mj - max_j
        zdelta = jnp.where(diag_i > diag_j,
                           max_sc - mrow - (diag_i - diag_j) * c(e_del),
                           max_sc - mrow - (diag_j - diag_i) * c(e_ins))
        brkz = alive & ~brk0 & ~better & (zdelta > c(zdrop))
        if zdrop <= 0:
            brkz = alive & False
        max_sc2 = jnp.where(better, mrow, max_sc)
        max_i2 = jnp.where(better, i, max_i)
        max_j2 = jnp.where(better, mj, max_j)

        # adaptive band shrink: first and last non-zero cell
        beg2 = jnp.where(lead < c(_BIG), lead, end)
        tail = jnp.where(last >= c(0), last, beg2 - c(1))
        end2 = jnp.minimum(tail + c(2), q_lens)

        alive2 = alive & ~brk0 & ~brkz
        return (i + c(1), jnp.where(alive, beg2, beg0),
                jnp.where(alive, end2, end0), max_sc2, max_i2, max_j2,
                max_ie2, gscore2, max_off2, alive2.astype(jnp.int32))

    neg1 = zero - c(1)
    live0 = ((t_lens > c(0)) & (q_lens > c(0))).astype(jnp.int32)
    st = jax.lax.while_loop(
        row_cond, row_body,
        (c(0), zero, q_lens, h0, neg1, neg1, neg1, neg1, zero, live0))
    (_, _, _, max_sc, max_i, max_j, max_ie, gscore, max_off, _) = st
    out_ref[0, :] = max_sc
    out_ref[1, :] = max_j
    out_ref[2, :] = max_i
    out_ref[3, :] = max_ie
    out_ref[4, :] = gscore
    out_ref[5, :] = max_off


def _trunc_div(n, d):
    return jnp.where(n >= 0, n // d, -((-n) // d))


def banded_swa_batch_pallas(qs, q_lens, ts, t_lens, h0, w: int,
                            o_del: int, e_del: int, o_ins: int,
                            e_ins: int, zdrop: int, mat,
                            end_bonus: int = 0, block: int = BLOCK,
                            interpret: bool = False) -> BswBatchResult:
    """Drop-in replacement for ops.bsw.banded_swa_batch (bit-equal).

    Sorts pairs by masked target length, runs the kernel over blocks
    of `block` lanes (each exits at its own longest lane), and
    inverse-permutes the six result vectors.
    """
    P, QL = qs.shape
    TL = ts.shape[1]
    i32 = jnp.int32
    q_lens = q_lens.astype(i32)
    t_lens = t_lens.astype(i32)
    h0 = h0.astype(i32)

    mat_np = np.asarray(mat)
    mx = int(mat_np.max())
    sc = dict(sc_match=int(mat_np[0, 0]), sc_mis=int(mat_np[0, 1]),
              sc_n=int(mat_np[0, 4]))

    # per-pair band clamp (C-truncation), as in the jnp kernel
    max_ins = _trunc_div(q_lens * mx + end_bonus - o_ins, e_ins) + 1
    max_del = _trunc_div(q_lens * mx + end_bonus - o_del, e_del) + 1
    w_p = jnp.minimum(jnp.asarray(w, i32),
                      jnp.minimum(jnp.maximum(max_ins, 1),
                                  jnp.maximum(max_del, 1))).astype(i32)

    # lane-coherence sort: dead lanes (len 0) first, then by t_len
    # (the sortPairsLen[Ext] of src/bwamem.cpp:2667-2805)
    eff_t = jnp.where((t_lens > 0) & (q_lens > 0), t_lens, 0)
    perm = jnp.argsort(eff_t).astype(i32)

    BP = block
    Pp = -(-max(P, 1) // BP) * BP
    pad = Pp - P
    R = QL + 2

    def permute(x):
        x = jnp.take(x, perm, axis=0)
        if pad:
            x = jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
        return x

    qs_t = jnp.pad(permute(qs.astype(i32)), ((0, 0), (0, R - QL))).T
    ts_t = permute(ts.astype(i32)).T                         # [TL, Pp]
    meta = jnp.stack([permute(q_lens), permute(t_lens), permute(h0),
                      permute(w_p)], axis=0)                 # [4, Pp]

    kern = functools.partial(_bsw_kernel, TL=TL, o_del=o_del,
                             e_del=e_del, o_ins=o_ins, e_ins=e_ins,
                             zdrop=zdrop, **sc)
    col = lambda b: (0, b)
    out, _, _ = pl.pallas_call(
        kern,
        grid=(Pp // BP,),
        in_specs=[pl.BlockSpec((4, BP), col),
                  pl.BlockSpec((R, BP), col),
                  pl.BlockSpec((TL, BP), col)],
        out_specs=[pl.BlockSpec((8, BP), col),
                   pl.BlockSpec((R, BP), col),
                   pl.BlockSpec((R, BP), col)],
        out_shape=[jax.ShapeDtypeStruct((8, Pp), i32),
                   jax.ShapeDtypeStruct((R, Pp), i32),
                   jax.ShapeDtypeStruct((R, Pp), i32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=max(block // 32, 1), num_stages=1),
        interpret=interpret,
        name="bsw_extend",
    )(meta, qs_t, ts_t)

    # inverse permutation: column r of `out` is pair perm[r]
    inv = jnp.zeros((P,), i32).at[perm].set(jnp.arange(P, dtype=i32))
    unperm = jnp.take(out, inv, axis=1)
    return BswBatchResult(score=unperm[0], qle=unperm[1] + 1,
                          tle=unperm[2] + 1, gtle=unperm[3] + 1,
                          gscore=unperm[4], max_off=unperm[5])
