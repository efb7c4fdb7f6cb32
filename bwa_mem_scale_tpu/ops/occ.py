"""Device FM-index: batched occ counting and backward extension.

The device formulation of the reference's GET_OCC/backwardExt hot
loop (src/FMI_search.h:76-83, src/FMI_search.cpp:2029-2056): the
checkpointed BWT lives in HBM as
    cp_count [nblocks, 4]  (int32/int64)  exclusive base counts
    cp_mask  [nblocks, 4]  (uint32)       one-hot 32-bp block bitmasks
and occ(p, c) for a batch of positions is one row gather plus a masked
population count — elementwise work over thousands of lanes.

All functions are shape-polymorphic over a leading batch shape and are
designed to be called inside jit/while_loop bodies.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..index.artifacts import FMIndex, CP_SHIFT, CP_MASK


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceFMIndex:
    """FM-index arrays resident on device.

    For int32-position genomes, the checkpoint counts and bitmasks are
    fused into one [nb, 8] int32 table so each occ(p, *) is a single
    row gather (the dependent row fetch is the seeding sweeps' inner
    step — the analogue of the reference packing CP_OCC into one
    cache line, src/FMI_search.h:64-68)."""

    count: jax.Array        # [5] pos_dtype
    cp_fused: jax.Array     # [nb, 8] int32 (counts | bitcast masks),
                            # or None for int64 genomes
    cp_fused32: jax.Array   # int64 path: [nb, 8] uint32
                            #   (low-32 counts | masks) — one gather
    cp_hi: jax.Array        # int64 path: [nb, 4] uint8 high count
                            #   bits (positions < 2^40, so 8 suffice)
    sa_samples: jax.Array   # [ns] pos_dtype (int32 path; None int64)
    sa_ms: jax.Array        # int64 path: [ns] uint8 high byte
    sa_ls: jax.Array        # int64 path: [ns] uint32 low word
                            #   (the reference's exact 5-byte layout,
                            #    sa_ms_byte/sa_ls_word,
                            #    src/FMI_search.cpp:723-743)
    sentinel_index: jax.Array  # scalar pos_dtype
    ref: jax.Array          # uint8 byte reference: fw+rc [2*l_pac],
                            # or forward-only [l_pac] (hg38 HBM plan;
                            # read through ref_byte)
    cp2_fused: jax.Array    # optional [nb, 40|168] int32 k-gram rows
                            # (index/kstep.py) — 2-/3-step extensions
    count2: jax.Array       # optional [16] pos_dtype C2 table
    count3: jax.Array       # optional [64] pos_dtype C3 table (K=3)
    # static metadata
    sa_compx: int
    l_pac: int
    seq_len: int

    @property
    def pos_dtype(self):
        return self.count.dtype

    def tree_flatten(self):
        children = (self.count, self.cp_fused, self.cp_fused32,
                    self.cp_hi, self.sa_samples, self.sa_ms,
                    self.sa_ls, self.sentinel_index, self.ref,
                    self.cp2_fused, self.count2, self.count3)
        aux = (self.sa_compx, self.l_pac, self.seq_len)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def from_host(cls, idx: FMIndex, force_int64: bool = False,
                  ref_fw_only: bool = None,
                  cp2=None) -> "DeviceFMIndex":
        """ref_fw_only (default: on for int64-position genomes, where
        HBM is the binding constraint) uploads only the forward half
        of the reference; consumers read it through ops.occ.ref_byte,
        which reconstructs the reverse-complement strand on the fly.

        cp2: optional index.kstep.Cp2Table; when present, the seeding
        sweeps extend two bases per checkpoint gather."""
        pos_dtype = (np.int64 if (force_int64 or not idx.pos_fits_int32)
                     else np.int32)
        cp_fused = cp_fused32 = cp_hi = None
        sa_samples = sa_ms = sa_ls = None
        if pos_dtype == np.int32:
            fused = np.concatenate(
                [idx.cp_count.astype(np.int32),
                 idx.cp_mask.view(np.int32).reshape(-1, 4)],
                axis=1)
            cp_fused = jnp.asarray(fused)
            sa_samples = jnp.asarray(idx.sa_samples, dtype=pos_dtype)
        else:
            lay = cls._int64_layout(idx)
            cp_fused32 = jnp.asarray(lay["cp_fused32"])
            cp_hi = jnp.asarray(lay["cp_hi"])
            sa_ms = jnp.asarray(lay["sa_ms"])
            sa_ls = jnp.asarray(lay["sa_ls"])
        if ref_fw_only is None:
            ref_fw_only = pos_dtype == np.int64
        if pos_dtype == np.int64 and ref_fw_only:
            ref = lay["ref"]
        else:
            ref = (idx.ref_string[: idx.bns.l_pac] if ref_fw_only
                   else idx.ref_string)
            ref = cls._pack_ref(ref)
        cp2_fused = count2 = count3 = None
        if cp2 is not None:
            if pos_dtype != np.int32:
                raise ValueError("k-step table is int32-path only")
            cp2_fused = jnp.asarray(np.ascontiguousarray(cp2.fused))
            count2 = jnp.asarray(cp2.c2, dtype=pos_dtype)
            if cp2.c3 is not None:
                count3 = jnp.asarray(cp2.c3, dtype=pos_dtype)
        return cls(
            count=jnp.asarray(idx.count, dtype=pos_dtype),
            cp_fused=cp_fused,
            cp_fused32=cp_fused32,
            cp_hi=cp_hi,
            sa_samples=sa_samples,
            sa_ms=sa_ms,
            sa_ls=sa_ls,
            sentinel_index=jnp.asarray(idx.sentinel_index, dtype=pos_dtype),
            ref=jnp.asarray(ref),
            cp2_fused=cp2_fused,
            count2=count2,
            count3=count3,
            sa_compx=idx.sa_compx,
            l_pac=idx.bns.l_pac,
            seq_len=idx.seq_len,
        )


    @staticmethod
    def _pack_ref(ref: np.ndarray) -> np.ndarray:
        """Pack a byte reference whose flat index space exceeds 32
        bits (hg38 scale) as [ceil(n/128), 128]: row indices fit
        int32 and the lane is selected one-hot (ref_byte); the
        [*, 128] row view also serves ref_windows as a no-op reshape.
        This pack worked around the previous accelerator's gather
        index limit; whether the GPU needs it is an open question.

        Either layout is zero-padded to a 128-byte multiple so the
        block row-gather window fetch (ops/window.ref_windows) can
        reshape it to 128-wide rows; tiny refs (< 4 KiB, test
        genomes) stay unpadded — padding there could flip ref_byte's
        forward-only-layout inference, and they take ref_windows'
        per-element fallback anyway."""
        if ref.shape[0] <= REF_2D_LIMIT:
            if ref.shape[0] >= 4096:
                pad = (-ref.shape[0]) % 128
                if pad:
                    ref = np.concatenate(
                        [ref, np.zeros(pad, dtype=ref.dtype)])
            return ref
        pad = (-ref.shape[0]) % 128
        if pad:
            ref = np.concatenate([ref, np.zeros(pad, dtype=ref.dtype)])
        return ref.reshape(-1, 128)

    @classmethod
    def _int64_layout(cls, idx: FMIndex) -> dict:
        """hg38-class HBM residency transforms (numpy): checkpoint
        counts split into a fused uint32 row (low words | masks — one
        gather on the hot path) + a tiny uint8 high-byte array; SA
        samples in the reference's 5-byte ms/ls layout
        (sa_ms_byte/sa_ls_word, src/FMI_search.cpp:723-743); forward
        ref half only, 2-D packed. ~14 GB total for hg38's 6.2e9
        positions vs ~22 GB naive int64."""
        cnt = np.ascontiguousarray(idx.cp_count, dtype=np.int64)
        fused32 = np.concatenate(
            [(cnt & 0xFFFFFFFF).astype(np.uint32),
             idx.cp_mask.view(np.uint32).reshape(-1, 4)], axis=1)
        sa = np.ascontiguousarray(idx.sa_samples, dtype=np.int64)
        return dict(
            cp_fused32=fused32,
            cp_hi=(cnt >> 32).astype(np.uint8),
            sa_ms=(sa >> 32).astype(np.uint8),
            sa_ls=(sa & 0xFFFFFFFF).astype(np.uint32),
            ref=cls._pack_ref(idx.ref_string[: idx.bns.l_pac]),
        )

    @classmethod
    def from_host_cached(cls, idx: FMIndex,
                         cp2=None) -> "DeviceFMIndex":
        """from_host with a persisted post-layout cache for
        genome-scale (int64-position) indexes: the host-side
        transforms (count split, SA 5-byte split, ref 2-D packing)
        cost minutes + peak RAM at hg38 scale; the cache mmaps the
        transformed arrays so a cold start streams them straight to
        HBM (the bwa_shm warm-store effect, src/bwa_shm.cpp:1585)."""
        import os
        if idx.pos_fits_int32 or not getattr(idx, "source_prefix",
                                             None):
            return cls.from_host(idx, cp2=cp2)
        if cp2 is not None:
            raise ValueError("k-step table is int32-path only")
        # v3: ref packed [n/128, 128] (v1/v2 caches' [n/16, 16] pack
        # triggers an 8x layout-copy OOM inside reshaping programs)
        path = idx.source_prefix + ".devlayout3.npz"
        if not os.path.exists(path):
            lay = cls._int64_layout(idx)
            np.savez(path, **lay)
            del lay
        from ..utils.npzmap import load_npz_mmap
        z = load_npz_mmap(path)
        return cls(
            count=jnp.asarray(idx.count, dtype=np.int64),
            cp_fused=None,
            cp_fused32=jnp.asarray(z["cp_fused32"]),
            cp_hi=jnp.asarray(z["cp_hi"]),
            sa_samples=None,
            sa_ms=jnp.asarray(z["sa_ms"]),
            sa_ls=jnp.asarray(z["sa_ls"]),
            sentinel_index=jnp.asarray(idx.sentinel_index,
                                       dtype=np.int64),
            ref=jnp.asarray(z["ref"]),
            cp2_fused=None, count2=None, count3=None,
            sa_compx=idx.sa_compx,
            l_pac=idx.bns.l_pac,
            seq_len=idx.seq_len,
        )


# Above this element count DeviceFMIndex packs the ref [n/128, 128]
# so gather indices fit int32.
REF_2D_LIMIT = (1 << 31) - (1 << 20)


def _ref_fetch(ref: jax.Array, idx: jax.Array) -> jax.Array:
    """ref[idx] for both device layouts ([n] u8, or [n/128, 128] u8
    for hg38-class refs whose flat index space exceeds 32 bits)."""
    if ref.ndim == 2:
        w = ref.shape[1]
        sh = w.bit_length() - 1
        rows = (idx >> sh).astype(jnp.int32)
        lane = (idx & (w - 1)).astype(jnp.int32)
        r = ref[rows]                               # [..., w] u8
        iota = jnp.arange(w, dtype=jnp.int32)
        return jnp.sum(jnp.where(iota == lane[..., None], r, 0),
                       axis=-1, dtype=jnp.int32)
    return ref[idx].astype(jnp.int32)


def ref_flat_len(ref: jax.Array) -> int:
    return int(ref.shape[0]) * (int(ref.shape[1]) if ref.ndim == 2
                                else 1)


def ref_byte(ref: jax.Array, pos: jax.Array, l_pac: int) -> jax.Array:
    """Reference base at fw+rc position(s) in [0, 2*l_pac) as int32.

    Supports the device layouts: full fw+rc byte array, forward-only
    ([l_pac], hg38 HBM residency plan — the reverse-complement strand
    is computed on the fly from the mirrored position), and either of
    those packed 2-D ([n/128, 128]) when the flat index space exceeds
    32 bits (see _ref_fetch). The ref holds only
    0..3 because index construction fills ambiguity holes with random
    bases, matching the reference's pac, src/bntseq.cpp."""
    l2 = 2 * l_pac
    pos = jnp.clip(pos, 0, l2 - 1)
    if ref_flat_len(ref) >= l2:
        return _ref_fetch(ref, pos)
    rev = pos >= l_pac
    idx = jnp.where(rev, (l2 - 1) - pos, pos)
    v = _ref_fetch(ref, idx)
    return jnp.where(rev, 3 - v, v)


def occ_all4(fmi: DeviceFMIndex, pp: jax.Array) -> jax.Array:
    """occ(pp, c) for all four bases. pp [...], returns [..., 4]."""
    block = (pp >> CP_SHIFT).astype(jnp.int32)
    y = (pp & CP_MASK).astype(jnp.uint32)
    counts, masks = _row_at(fmi, block)
    # Top-y-bits mask; y == 0 -> 0.
    top = (~(jnp.uint32(0xFFFFFFFF) >> y)).astype(jnp.uint32)
    hit = masks & top[..., None]
    pc = jax.lax.population_count(hit).astype(fmi.pos_dtype)
    return counts + pc


def occ_all4_pair(fmi: DeviceFMIndex, pp0: jax.Array, pp1: jax.Array):
    """occ_all4 at two same-shape position sets with ONE checkpoint-row
    gather over the doubled lane set. The two addresses are known
    together at the start of an extension tick, so batching them
    halves the dependent-gather count of the seeding machines' hot
    loop (the tick cost there is gather-latency-bound, not FLOP- or
    byte-bound)."""
    pp = jnp.concatenate([pp0.reshape(-1), pp1.reshape(-1)])
    occ = occ_all4(fmi, pp)                      # [2N, 4]
    n = pp0.size
    return (occ[:n].reshape(*pp0.shape, 4),
            occ[n:].reshape(*pp1.shape, 4))


def backward_ext_all4(fmi: DeviceFMIndex, k, l, s):
    """Backward extension of intervals (k, l, s) by every base.

    Returns (k4, l4, s4) each [..., 4], matching the reference's
    backwardExt including sentinel correction (FMI_search.cpp:2029-2056).
    """
    occ_sp, occ_ep = occ_all4_pair(fmi, k, k + s)
    k4 = fmi.count[:4] + occ_sp
    s4 = occ_ep - occ_sp
    sent = ((k <= fmi.sentinel_index)
            & (k + s > fmi.sentinel_index)).astype(fmi.pos_dtype)
    l3 = l + sent
    l2 = l3 + s4[..., 3]
    l1 = l2 + s4[..., 2]
    l0 = l1 + s4[..., 1]
    l4 = jnp.stack([l0, l1, l2, l3], axis=-1)
    return k4, l4, s4


def _occ12_at(fmi: DeviceFMIndex, pp: jax.Array, want3: bool = False):
    """(occ1 [..., 4], occ2 [..., 16][, occ3 [..., 64]]) at positions
    pp from the fused k-gram checkpoint row (index/kstep.py layouts:
    [.., 40] for K=2, [.., 168] for K=3) — one gather."""
    block = (pp >> CP_SHIFT).astype(jnp.int32)
    y = (pp & CP_MASK).astype(jnp.uint32)
    row = fmi.cp2_fused[block]                  # [..., 40|168] int32
    top = (~(jnp.uint32(0xFFFFFFFF) >> y)).astype(jnp.uint32)
    off = int(row.shape[-1]) - 40               # 0 (K=2) | 128 (K=3)

    def occ_part(c_lo, c_hi, m_lo, m_hi):
        m = jax.lax.bitcast_convert_type(row[..., m_lo:m_hi],
                                         jnp.uint32)
        pc = jax.lax.population_count(m & top[..., None])
        return row[..., c_lo:c_hi] + pc.astype(jnp.int32)

    occ2 = occ_part(off, off + 16, off + 16, off + 32)
    occ1 = occ_part(off + 32, off + 36, off + 36, off + 40)
    if not want3:
        return occ1, occ2
    occ3 = occ_part(0, 64, 64, 128) if off else None
    return occ1, occ2, occ3


def _suffix_sum(v):
    """suf[..., c] = sum over d > c of v[..., d]."""
    rev = jnp.flip(v, axis=-1)
    return jnp.flip(jnp.cumsum(rev, axis=-1), axis=-1) - v


def _take_c(v, i):
    """v[..., i] for a per-lane small-axis index, as a one-hot masked
    reduction instead of take_along_axis/gather: over a W<=64 minor
    axis the masked sum is elementwise work. (Chosen for the previous
    accelerator; not yet measured on the GPU.)"""
    W = v.shape[-1]
    iota = jnp.arange(W, dtype=jnp.int32)
    sel = iota == i[..., None].astype(jnp.int32)
    return jnp.sum(jnp.where(sel, v, 0), axis=-1, dtype=v.dtype)


def _oh_take(v, idx):
    """take_along_axis(v, idx, axis=-1) via one-hot (see _take_c).
    v [..., W], idx [..., n] -> [..., n]."""
    W = v.shape[-1]
    iota = jnp.arange(W, dtype=jnp.int32)
    sel = idx[..., :, None].astype(jnp.int32) == iota   # [..., n, W]
    return jnp.sum(jnp.where(sel, v[..., None, :], 0), axis=-1,
                   dtype=v.dtype)


def _two_steps(fmi, occ1_k, occ1_e, occ2_k, occ2_e, k, l, s, c1, c2,
               occ3_k=None, occ3_e=None, c3=None):
    """2- (or 3-)step interval update from pre-gathered occ rows at
    (k, k+s) (see backward_ext2); each deeper step follows the same
    telescoping recipe one k-gram level up."""
    s1_4 = occ1_e - occ1_k                       # [..., 4]
    k1 = fmi.count[c1] + _take_c(occ1_k, c1)
    s1 = _take_c(s1_4, c1)
    sent0 = ((k <= fmi.sentinel_index)
             & (k + s > fmi.sentinel_index)).astype(fmi.pos_dtype)
    l1 = l + sent0 + _take_c(_suffix_sum(s1_4), c1)

    pair = c1 * 4 + c2
    s2_16 = occ2_e - occ2_k                      # [..., 16]
    k2 = fmi.count2[pair] + _take_c(occ2_k, pair)
    s2 = _take_c(s2_16, pair)
    sent1 = ((k1 <= fmi.sentinel_index)
             & (k1 + s1 > fmi.sentinel_index)).astype(fmi.pos_dtype)
    # s''(c) for the intermediate interval = occ2 diffs of (c1 -> c)
    grp = c1[..., None] * 4 + jnp.arange(4, dtype=jnp.int32)
    s2_grp = _oh_take(s2_16, grp)                       # [..., 4]
    l2 = l1 + sent1 + _take_c(_suffix_sum(s2_grp), c2)
    if c3 is None:
        return (k1, l1, s1), (k2, l2, s2)

    tri = pair * 4 + c3
    s3_64 = occ3_e - occ3_k                      # [..., 64]
    k3 = fmi.count3[tri] + _take_c(occ3_k, tri)
    s3 = _take_c(s3_64, tri)
    sent2 = ((k2 <= fmi.sentinel_index)
             & (k2 + s2 > fmi.sentinel_index)).astype(fmi.pos_dtype)
    grp3 = pair[..., None] * 4 + jnp.arange(4, dtype=jnp.int32)
    s3_grp = _oh_take(s3_64, grp3)                      # [..., 4]
    l3 = l2 + sent2 + _take_c(_suffix_sum(s3_grp), c3)
    return (k1, l1, s1), (k2, l2, s2), (k3, l3, s3)


def backward_ext2(fmi: DeviceFMIndex, k, l, s, c1, c2):
    """Backward extension by per-lane chars c1 then c2 with ONE
    checkpoint-row gather pair (at k and k+s) — the 2-step FM index
    (see index/kstep.py for the math and its verification). Returns
    ((k1, l1, s1), (k2, l2, s2)): the intermediate single-step result
    (needed by callers to resolve boundaries that land mid-stride)
    and the 2-step result. Bit-identical to two backward_ext calls."""
    pp = jnp.concatenate([k.reshape(-1), (k + s).reshape(-1)])
    occ1_p, occ2_p = _occ12_at(fmi, pp)          # one doubled gather
    nk = k.size
    rs = lambda v, w: v.reshape(*k.shape, w)
    return _two_steps(fmi, rs(occ1_p[:nk], 4), rs(occ1_p[nk:], 4),
                      rs(occ2_p[:nk], 16), rs(occ2_p[nk:], 16),
                      k, l, s, c1, c2)


def backward_ext_steps_and_1(fmi: DeviceFMIndex, k, l, s, chars,
                             kB, lB, sB, cB, sides=()):
    """K-step backward extension of (k, l, s) by chars[0..K-1]
    (K = len(chars) = 2 or 3, 3 requires the trigram table) PLUS
    single-step backward extensions of side intervals — (kB, lB, sB)
    by cB and each (kX, lX, sX, cX) in `sides` — ALL checkpoint
    addresses in ONE fused gather. Lets the seeding machine's tick
    extend the forward walk K bases AND several backward-tail stack
    entries at no extra gather depth. Returns
    (step tuples..., B tuple, *side tuples)."""
    want3 = len(chars) == 3
    parts = [k.reshape(-1), (k + s).reshape(-1),
             kB.reshape(-1), (kB + sB).reshape(-1)]
    for kX, lX, sX, cX in sides:
        parts += [kX.reshape(-1), (kX + sX).reshape(-1)]
    pp = jnp.concatenate(parts)
    occ = _occ12_at(fmi, pp, want3=want3)
    occ1_p, occ2_p = occ[0], occ[1]
    n = k.size
    rs = lambda v, w: v.reshape(*k.shape, w)
    kw = {}
    if want3:
        occ3_p = occ[2]
        kw = dict(occ3_k=rs(occ3_p[:n], 64),
                  occ3_e=rs(occ3_p[n:2 * n], 64), c3=chars[2])
    steps = _two_steps(fmi,
                       rs(occ1_p[:n], 4), rs(occ1_p[n:2 * n], 4),
                       rs(occ2_p[:n], 16), rs(occ2_p[n:2 * n], 16),
                       k, l, s, chars[0], chars[1], **kw)

    def one_step(i, kX, lX, sX, cX):
        o1k = rs(occ1_p[i * n:(i + 1) * n], 4)
        o1e = rs(occ1_p[(i + 1) * n:(i + 2) * n], 4)
        s1_4 = o1e - o1k
        kx = fmi.count[cX] + _take_c(o1k, cX)
        sx = _take_c(s1_4, cX)
        sentX = ((kX <= fmi.sentinel_index)
                 & (kX + sX > fmi.sentinel_index)
                 ).astype(fmi.pos_dtype)
        lx = lX + sentX + _take_c(_suffix_sum(s1_4), cX)
        return (kx, lx, sx)

    out = steps + (one_step(2, kB, lB, sB, cB),)
    for si, (kX, lX, sX, cX) in enumerate(sides):
        out = out + (one_step(4 + 2 * si, kX, lX, sX, cX),)
    return out


def backward_ext2_and_1(fmi: DeviceFMIndex, k, l, s, c1, c2,
                        kB, lB, sB, cB):
    """See backward_ext_steps_and_1 (2-step form)."""
    return backward_ext_steps_and_1(fmi, k, l, s, (c1, c2),
                                    kB, lB, sB, cB)


def forward_ext2(fmi: DeviceFMIndex, k, l, s, a, b):
    """Two forward extensions (append a then b) in one gather pair:
    backward extension on the swapped bi-interval by the complements
    (FMI_search.cpp:1477-1484), results swapped back."""
    (k1, l1, s1), (k2, l2, s2) = backward_ext2(
        fmi, l, k, s, 3 - a, 3 - b)
    return (l1, k1, s1), (l2, k2, s2)


def backward_ext3(fmi: DeviceFMIndex, k, l, s, c1, c2, c3):
    """Three backward extensions from one gather pair (trigram
    table); bit-identical to three chained backward_ext calls."""
    pp = jnp.concatenate([k.reshape(-1), (k + s).reshape(-1)])
    occ1_p, occ2_p, occ3_p = _occ12_at(fmi, pp, want3=True)
    n = k.size
    rs = lambda v, w: v.reshape(*k.shape, w)
    return _two_steps(fmi, rs(occ1_p[:n], 4), rs(occ1_p[n:], 4),
                      rs(occ2_p[:n], 16), rs(occ2_p[n:], 16),
                      k, l, s, c1, c2,
                      occ3_k=rs(occ3_p[:n], 64),
                      occ3_e=rs(occ3_p[n:], 64), c3=c3)


def forward_ext3(fmi: DeviceFMIndex, k, l, s, a, b, c):
    """Three forward extensions via the swap/complement identity."""
    t1, t2, t3 = backward_ext3(fmi, l, k, s, 3 - a, 3 - b, 3 - c)
    sw = lambda t: (t[1], t[0], t[2])
    return sw(t1), sw(t2), sw(t3)


def backward_ext(fmi: DeviceFMIndex, k, l, s, a):
    """Backward extension by base a [...] (values 0..3)."""
    k4, l4, s4 = backward_ext_all4(fmi, k, l, s)
    return _take_c(k4, a), _take_c(l4, a), _take_c(s4, a)


def forward_ext(fmi: DeviceFMIndex, k, l, s, a):
    """Forward extension = backward extension on the RC BWT via k/l swap
    and base complement (FMI_search.cpp:1477-1484)."""
    k2, l2, s2 = backward_ext(fmi, l, k, s, 3 - a)
    return l2, k2, s2


def _row_at(fmi: DeviceFMIndex, block):
    """(counts [..., 4] pos_dtype, masks [..., 4] uint32) for the
    checkpoint rows at `block` — one fused gather on the hot path
    (plus the tiny uint8 high-count gather on the int64 layout)."""
    if fmi.cp_fused is not None:
        row = fmi.cp_fused[block]
        return row[..., :4], jax.lax.bitcast_convert_type(row[..., 4:],
                                                          jnp.uint32)
    row = fmi.cp_fused32[block]                 # [..., 8] uint32
    lo = row[..., :4].astype(jnp.int64)
    hi = fmi.cp_hi[block].astype(jnp.int64)     # [..., 4] uint8
    return (hi << 32) | lo, row[..., 4:]


def sa_sample_at(fmi: DeviceFMIndex, idx: jax.Array) -> jax.Array:
    """SA sample at sample-index `idx` ([...] pos_dtype)."""
    if fmi.sa_samples is not None:
        return fmi.sa_samples[idx]
    hi = fmi.sa_ms[idx].astype(jnp.int64)
    lo = fmi.sa_ls[idx].astype(jnp.int64)
    return (hi << 32) | lo


def bwt_base_at(fmi: DeviceFMIndex, pos: jax.Array) -> jax.Array:
    """Base code of BWT[pos] ([...] int32); 4 at the sentinel row."""
    block = (pos >> CP_SHIFT).astype(jnp.int32)
    y = (31 - (pos & CP_MASK)).astype(jnp.uint32)
    _, masks = _row_at(fmi, block)
    bits = (masks >> y[..., None]) & jnp.uint32(1)   # [..., 4]
    b = jnp.argmax(bits, axis=-1).astype(jnp.int32)
    none = jnp.sum(bits, axis=-1) == 0
    return jnp.where(none, 4, b)


def occ_and_base(fmi: DeviceFMIndex, pos: jax.Array):
    """(occ(pos, c) for all c, BWT[pos]) with ONE checkpoint-row gather
    — the LF-step fast path for SA resolution."""
    block = (pos >> CP_SHIFT).astype(jnp.int32)
    counts, masks = _row_at(fmi, block)
    y = (pos & CP_MASK).astype(jnp.uint32)
    top = (~(jnp.uint32(0xFFFFFFFF) >> y)).astype(jnp.uint32)
    pc = jax.lax.population_count(masks & top[..., None])
    occs = counts + pc.astype(fmi.pos_dtype)
    yb = (jnp.uint32(31) - y)
    bits = (masks >> yb[..., None]) & jnp.uint32(1)
    b = jnp.argmax(bits, axis=-1).astype(jnp.int32)
    b = jnp.where(jnp.sum(bits, axis=-1) == 0, 4, b)
    return occs, b


def occ_b_and_base(fmi: DeviceFMIndex, pos: jax.Array):
    """(occ(pos, BWT[pos]), BWT[pos]) — the lean SAL LF step.

    Unlike occ_and_base it popcounts ONLY the loaded base's mask and,
    on the int64 layout, one-hot-selects the low/high count words
    BEFORE widening — occ_and_base materialized [N, 4] int64 counts +
    4 popcounts per tick, ~2x the vector traffic the step needs."""
    block = (pos >> CP_SHIFT).astype(jnp.int32)
    y = (pos & CP_MASK).astype(jnp.uint32)
    if fmi.cp_fused is not None:
        row = fmi.cp_fused[block]
        counts4 = row[..., :4]
        masks = jax.lax.bitcast_convert_type(row[..., 4:], jnp.uint32)
        hi4 = None
    else:
        row = fmi.cp_fused32[block]                 # [..., 8] uint32
        counts4 = row[..., :4]
        masks = row[..., 4:]
        hi4 = fmi.cp_hi[block]                      # [..., 4] uint8
    yb = (jnp.uint32(31) - y)
    bits = (masks >> yb[..., None]) & jnp.uint32(1)
    b = jnp.argmax(bits, axis=-1).astype(jnp.int32)
    b = jnp.where(jnp.sum(bits, axis=-1) == 0, 4, b)
    bc = jnp.clip(b, 0, 3)
    mask_b = _take_c(masks, bc)
    top = (~(jnp.uint32(0xFFFFFFFF) >> y))
    pc = jax.lax.population_count(mask_b & top)
    cnt_b = _take_c(counts4, bc)
    if hi4 is None:
        occ_b = cnt_b + pc.astype(fmi.pos_dtype)
    else:
        occ_b = ((_take_c(hi4, bc).astype(jnp.int64) << 32)
                 | cnt_b.astype(jnp.uint32).astype(jnp.int64)) \
            + pc.astype(jnp.int64)
    return occ_b, b
