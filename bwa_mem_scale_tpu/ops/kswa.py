"""Batched local Smith-Waterman (ksw_align2) on device — mate rescue.

One alignment problem per lane, the batched analogue of the reference's
inter-sequence kswv batch kernel (src/kswv.cpp:372-934) driven from
mem_sam_pe_batch. The row recurrence vectorizes over (lane, query)
with the insertion term F resolved by a prefix max (lax.cummax):
F(i,j) = max_k<j (H'(i,k) - o_ins - e_ins*(j-k)), valid because an
insertion never improves by chaining through another insertion's
origin when o_ins >= 0.

Two-phase coordinates like the reference (src/ksw.cpp:369-379):
phase 0 forward scan gives (score, te, qe, score2), phase 1 re-scans
the reversed (qe, te)-prefixes for (qb, tb). See ref/ksw_align.py for
the scalar oracle and the documented score2 divergence.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

NEG = jnp.int32(-(1 << 29))


class KswBatchResult(NamedTuple):
    score: jax.Array
    te: jax.Array
    qe: jax.Array
    score2: jax.Array
    te2: jax.Array
    tb: jax.Array
    qb: jax.Array


def _scan_phase(q, qlens, t, tlens, mat5, o_del, e_del, o_ins, e_ins):
    """Forward local-SW scan. q [J, L] int32 (4=N ok), t [J, T].
    Returns (gmax, te, qe, colmax [J, T])."""
    J, L = q.shape
    T = t.shape[1]
    jq = jnp.arange(L, dtype=jnp.int32)
    q_in = jq[None, :] < qlens[:, None]
    e_ins_j = e_ins * jq

    def step(carry, ti):
        H_prev, E, gmax, te, Hbest, i = carry
        tb = jnp.clip(ti, 0, 4)
        S = mat5[tb[:, None], jnp.clip(q, 0, 4)]
        M = jnp.concatenate(
            [jnp.zeros((J, 1), jnp.int32), H_prev[:, :-1]], axis=1) + S
        Hp = jnp.maximum(jnp.maximum(M, E), 0)
        Hp = jnp.where(q_in, Hp, 0)
        A = Hp + e_ins_j[None, :]
        pm = jax.lax.cummax(A, axis=1)
        pm = jnp.concatenate([jnp.full((J, 1), NEG), pm[:, :-1]], axis=1)
        F = pm - o_ins - e_ins_j[None, :]
        H = jnp.maximum(Hp, jnp.maximum(F, 0))
        H = jnp.where(q_in, H, 0)
        E = jnp.maximum(jnp.maximum(H - o_del - e_del, E - e_del), 0)
        E = jnp.where(q_in, E, 0)
        live = i < tlens
        cm = jnp.where(live, jnp.max(H, axis=1), 0)
        better = live & (cm > gmax)
        gmax = jnp.where(better, cm, gmax)
        te = jnp.where(better, i, te)
        Hbest = jnp.where(better[:, None], H, Hbest)
        H_prev = jnp.where(live[:, None], H, H_prev)
        return (H_prev, E, gmax, te, Hbest, i + 1), cm

    z = jnp.zeros((J, L), dtype=jnp.int32)
    init = (z, z, jnp.zeros((J,), jnp.int32),
            jnp.full((J,), -1, jnp.int32), z, jnp.int32(0))
    (H_prev, E, gmax, te, Hbest, _), colmax = jax.lax.scan(
        step, init, jnp.swapaxes(t, 0, 1))
    qe = jnp.argmax(Hbest, axis=1).astype(jnp.int32)  # first max = min j
    qe = jnp.where(gmax > 0, qe, -1)
    return gmax, te, qe, jnp.swapaxes(colmax, 0, 1)


def ksw_align_batch(q, qlens, t, tlens, mat5, o_del, e_del, o_ins,
                    e_ins, minsc: int, max_mat: int) -> KswBatchResult:
    """Batched ksw_align2 with XSTART: q/t padded code arrays."""
    J, L = q.shape
    T = t.shape[1]
    gmax, te, qe, colmax = _scan_phase(q, qlens, t, tlens, mat5,
                                       o_del, e_del, o_ins, e_ins)
    # second-best outside the te window (see module docstring)
    d = (gmax + max_mat - 1) // max_mat
    ti = jnp.arange(T, dtype=jnp.int32)[None, :]
    outside = (ti < (te - d)[:, None]) | (ti > (te + d)[:, None])
    cand = jnp.where(outside & (colmax >= max(minsc, 1)), colmax, 0)
    score2 = jnp.max(cand, axis=1)
    te2 = jnp.where(score2 > 0, jnp.argmax(cand, axis=1), -1)

    # phase 1: reversed prefixes for start coordinates
    jq = jnp.arange(L, dtype=jnp.int32)
    ti1 = jnp.arange(T, dtype=jnp.int32)
    rq = jnp.take_along_axis(q, jnp.clip(qe[:, None] - jq[None, :],
                                         0, L - 1), axis=1)
    rt = jnp.take_along_axis(t, jnp.clip(te[:, None] - ti1[None, :],
                                         0, T - 1), axis=1)
    g2, te_r, qe_r, _ = _scan_phase(rq, qe + 1, rt, te + 1, mat5,
                                    o_del, e_del, o_ins, e_ins)
    # ksw_align2 skips the start-coordinate pass below the XSUBO
    # threshold (src/ksw.cpp:369)
    ok = (g2 == gmax) & (gmax > 0) & (gmax >= minsc)
    tb = jnp.where(ok, te - te_r, -1)
    qb = jnp.where(ok, qe - qe_r, -1)
    return KswBatchResult(score=gmax, te=te, qe=qe, score2=score2,
                          te2=te2.astype(jnp.int32), tb=tb, qb=qb)
