"""Batched suffix-array lookup (SAL) on device.

Device form of the reference's compressed SA resolution
(get_sa_entry_compressed / get_sa_entries_prefetch,
src/FMI_search.cpp:2107-2379): every SMEM's SA interval is sampled into
at most max_occ coordinates; non-sampled rows are recovered by a
batched LF-walk (at most 2^sa_compx - 1 steps, each one occ gather for
the whole coordinate batch). The reference hides the walk's memory
latency with 20-wide software prefetch pipelines; here the batch *is*
the pipeline.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .occ import (DeviceFMIndex, occ_b_and_base, sa_sample_at,
                  _take_c)
from .smem import SmemBuf


def sa_lookup(fmi: DeviceFMIndex, pos: jax.Array, valid: jax.Array
              ) -> jax.Array:
    """Resolve SA[pos] for a batch of BWT row indices.

    pos [...], valid [...] bool (invalid lanes return 0).

    The LF walk is GEOMETRIC: a lane finds a sampled row with
    p = 1/2^sa_compx per step (the walk visits pseudo-random rows),
    so the mean walk is 2^sa_compx but the slowest of N lanes runs
    ~2^sa_compx * ln(N) steps — a lockstep machine wastes >90% of its
    lane-ticks in that tail at batch widths (hg38 probe: 11 s for 2M
    lanes). Staged narrowing (the seeding machines' fix) compacts
    retired lanes out at halving width thresholds; 1-D state rows
    make each stage a handful of cheap per-element gathers/scatters."""
    compx_mask = (1 << fmi.sa_compx) - 1
    pos_dtype = fmi.pos_dtype
    if fmi.sa_compx == 0:
        # full SA resident (memory-for-speed knob, like the
        # reference's SA_COMPX build parameter): single gather.
        out = sa_sample_at(fmi, pos.astype(jnp.int64))
        return jnp.where(valid, out, 0)

    shape = pos.shape
    N = 1
    for d in shape:
        N *= d

    def body(st):
        sp, offset, active, done_val, orow = st
        sampled = (sp & compx_mask) == 0
        take_sample = active & sampled
        samp = sa_sample_at(fmi, (sp >> fmi.sa_compx).astype(jnp.int64))
        done_val = jnp.where(take_sample, samp + offset, done_val)
        active = active & ~sampled
        # LF step: one fused row gather gives both occ(sp, b) and
        # b = BWT[sp]; occ_b_and_base popcounts only the one mask
        # and selects count words before widening to int64.
        occ_b, b = occ_b_and_base(fmi, sp)
        hit_sentinel = active & (b == 4)
        done_val = jnp.where(hit_sentinel, offset, done_val)
        active = active & ~hit_sentinel
        # one-hot selects, not per-lane gathers (see ops/occ._take_c)
        bc = jnp.clip(b, 0, 3)
        cnt_b = _take_c(fmi.count[:4], bc)
        sp_new = cnt_b + occ_b
        sp = jnp.where(active, sp_new, sp)
        offset = offset + active.astype(pos_dtype)
        return sp, offset, active, done_val, orow

    import os
    stages_env = os.environ.get("BWATPU_SAL_STAGES", "auto")
    if stages_env == "0":
        widths = []
    elif stages_env == "auto":
        widths = []
        w = N // 2
        while w >= 16384:
            widths.append(w)
            w //= 2
    else:
        # explicit comma-separated width schedule (like
        # BWATPU_SEED_STAGES) — lets small-N tests exercise the
        # compaction/flush/orow-scatter path
        widths = [int(w) for w in stages_env.split(",")
                  if 0 < int(w) < N]

    sp = pos.reshape(N).astype(pos_dtype)
    offset = jnp.zeros(N, pos_dtype)
    active = valid.reshape(N)
    done_val = jnp.zeros(N, pos_dtype)
    orow = jnp.arange(N, dtype=jnp.int32)
    glob = jnp.zeros(N, pos_dtype)
    st = (sp, offset, active, done_val, orow)
    for W2 in widths:
        st = jax.lax.while_loop(
            lambda s, W2=W2: jnp.sum(s[2]) > W2, body, st)
        sp, offset, active, done_val, orow = st
        rows = jnp.where(active, N, orow)   # retired lanes flush
        glob = glob.at[rows].set(done_val, mode="drop")
        from .smem import compact_indices
        perm, keep = compact_indices(active, W2)
        # padding lanes (beyond the live count) get orow = N so their
        # garbage drops at every later scatter
        st = (sp[perm], offset[perm], keep,
              done_val[perm], jnp.where(keep, orow[perm], N))
    st = jax.lax.while_loop(lambda s: jnp.any(s[2]), body, st)
    _, _, _, done_val, orow = st
    glob = glob.at[orow].set(done_val, mode="drop")
    return glob.reshape(shape)


def expand_and_lookup(fmi: DeviceFMIndex, smems: SmemBuf, max_occ: int,
                      max_coords: int, flat_k: int = None):
    """Sample each SMEM interval and resolve coordinates.

    Returns (rbeg [B, C], seed_smem [B, C] (index into smems arrays),
    coord_valid [B, C], total [B], overflow [B]) where C = max_coords.
    Within a read, coordinates appear in SMEM order then interval order
    — the same order the reference feeds seeds into chaining
    (mem_chain_seeds, src/bwamem.cpp:862-895). `overflow` marks reads
    whose sampled coordinates exceeded the max_coords capacity (the
    reference's heap-backed seed vector never drops seeds,
    src/bwamem.cpp:789-895 — overflowed reads must be retried at a
    larger shape).

    The SA walk runs over a FLAT compacted [K] coordinate list
    (K = flat_k, default B*C//16 rounded to 1024, floor 4096), not
    the [B, C] grid: valid coords are a dense prefix per read, and
    their batch-wide sum is a small fraction of B*C — resolving the
    grid paid a per-lane serialized row gather for every EMPTY slot
    (chip: the [4096, 256] E. coli SAL block was 48 ms of a 223 ms
    device stage; the walk itself only needs ~30 k lanes). Reads
    whose coords fall past K are latched into `overflow` (the
    existing retry ladder re-runs them at bigger shapes).
    """
    B, M = smems.m.shape
    C = max_coords
    valid = jnp.arange(M)[None, :] < smems.cnt[:, None]
    s = smems.s
    big = s > max_occ
    step = jnp.where(big, s // max_occ, 1).astype(s.dtype)
    # number of sampled coordinates per SMEM
    n_i = jnp.where(big,
                    jnp.minimum((s + step - 1) // step, max_occ),
                    jnp.minimum(s, max_occ))
    n_i = jnp.where(valid, n_i, 0).astype(jnp.int32)
    csum = jnp.cumsum(n_i, axis=1)
    overflow = csum[:, -1] > max_coords
    total = jnp.minimum(csum[:, -1], max_coords)
    starts = csum - n_i                          # [B, M]

    slot = jnp.arange(C, dtype=jnp.int32)[None, :]   # [1, C]
    coord_valid = slot < total[:, None]
    # Which SMEM does each slot belong to? One-hot mark + running max
    # (= searchsorted(csum, slot, "right") on the valid slots): marks
    # of nonzero SMEMs land at strictly increasing starts, cummax
    # forward-fills. All VPU work — no per-lane scatter.
    iota_m = jnp.arange(M, dtype=jnp.int32)
    hit = (starts[:, None, :] == slot[:, :, None]) \
        & (n_i[:, None, :] > 0)                  # [B, C, M]
    mark = jnp.max(jnp.where(hit, iota_m[None, None, :], -1), axis=2)
    seed_idx = jax.lax.cummax(mark, axis=1)
    seed_idx = jnp.clip(seed_idx, 0, M - 1)
    # per-slot SMEM fields via one-hot over the small M axis
    from .occ import _oh_take
    starts_c = _oh_take(starts, seed_idx)        # [B, C]
    k_c = _oh_take(smems.k, seed_idx)
    step_c = _oh_take(step, seed_idx)
    within = slot - starts_c
    pos = k_c + within.astype(s.dtype) * step_c  # [B, C]

    # ---- flat compaction: resolve only the valid coords ----
    K = flat_k or max(4096, (B * C // 16 + 1023) // 1024 * 1024)
    if B * C <= K:
        rbeg = sa_lookup(fmi, pos, coord_valid)
        return rbeg, seed_idx, coord_valid, total, overflow
    tot_c = jnp.cumsum(total)                    # [B]
    grand = tot_c[-1]
    overflow = overflow | ((tot_c > K) & (total > 0))
    j = jnp.arange(K, dtype=jnp.int32)
    # fb[j] = #{b: tot_c[b] <= j} (searchsorted-right). The direct
    # jnp.searchsorted lowers to a [K, B] broadcast compare. tot_c is
    # monotone,
    # so a B-row scatter-max of read ids at their tot_c positions
    # plus a cummax forward-fill computes the same function.
    fb = jax.lax.cummax(
        jnp.zeros((K + 1,), jnp.int32)
        .at[jnp.minimum(tot_c, K).astype(jnp.int32)]
        .max(jnp.arange(1, B + 1, dtype=jnp.int32), mode="drop")[:K])
    fbc = jnp.clip(fb, 0, B - 1)
    fc = j - (tot_c - total)[fbc]
    f_valid = j < grand
    fcc = jnp.clip(fc, 0, C - 1)
    # 1-D flat gather instead of the 2-D advanced-index form
    # pos[fbc, fcc]
    pos_f = pos.reshape(B * C)[fbc * C + fcc]    # [K] gather
    rbeg_f = sa_lookup(fmi, pos_f, f_valid)
    # scatter back into the [B, C] grid (K rows; empty slots stay 0)
    flat_tgt = jnp.where(f_valid, fbc * C + fcc, B * C)
    rbeg = jnp.zeros((B * C,), dtype=rbeg_f.dtype).at[flat_tgt].set(
        rbeg_f, mode="drop").reshape(B, C)
    return rbeg, seed_idx, coord_valid, total, overflow
