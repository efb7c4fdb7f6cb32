"""2-step (bigram) FM-index checkpoint table — trade HBM row width
for dependent-gather depth.

The seeding machines' cost is the *number of sequential
checkpoint-row gathers* (each tick is one dependent, latency-bound
fetch for thousands of lanes). The reference attacks
FM-walk cost with cache-resident helper tables (SMEM_ACCEL,
src/FMI_search.cpp:1414-1463); the device equivalent is the
n-step FM-index (Chacon et al.): checkpoint occ counts for all 16
BWT *bigrams* B2[i] = (BWT[i], BWT[LF(i)]) let one row gather extend
a bi-interval by TWO bases, halving the tick count of every forward
extension loop.

Correctness basis (verified exhaustively in tests/test_kstep.py):
  range(c2 c1 P) = [ C2[c1,c2] + occ2(k, c1c2),  + s2 )
  with  C2[c1,c2] = C[c2] + occ1(C[c1], c2)
        occ2(p, c1c2) = #{ i < p : BWT[i]=c1 and BWT[LF(i)]=c2 }
(LF maps the c1-class of [0, k) monotonically onto
[C[c1], LF_c1(k)), so the second step's occ1 decomposes into the
constant C2 plus occ2 at the ORIGINAL position.) The intermediate
interval (k1, l1, s1) and the rc-side l updates — including both
sentinel corrections — are recoverable from the same row because
s''(c) = occ2diff(c1->c) for every c.

The fused device row is [nb, 40] int32 per 32-position block:
counts2[16] | masks2[16] | counts1[4] | masks1[4] — one gather serves
the 2-step extension, the embedded 1-step (for boundary resolution
when s changes mid-stride), and the sentinel checks.

Pairs whose second step crosses the text start (LF lands on the
sentinel row) or whose first char is the sentinel belong to no bigram
class; the embedded 1-step counts keep those lanes exact.

Scope: int32-position genomes (the bigram table costs 5 B/position —
the same memory-for-speed class as ERT/FMA; hg38 seeding stays on the
1-step readlane machine, see LIMITS.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np

CP2_SHIFT = 5          # 32 positions per block, matching ops/occ.py
CP2_BLOCK = 1 << CP2_SHIFT


@dataclasses.dataclass
class Cp2Table:
    """Host k-gram checkpoint artifact (K = 2 or 3).

    K=2 fused row: counts2[16] | masks2[16] | counts1[4] | masks1[4]
    (40 int32). K=3 prepends counts3[64] | masks3[64] (168 int32,
    21 B/position); c3[64] carries C3[c1*16+c2*4+c3] =
    C[c3] + occ1(C2[c1,c2], c3) by the same telescoping argument."""

    fused: np.ndarray    # [nb, 40 or 168] int32 (see module doc)
    c2: np.ndarray       # [16] int64: C2[c1*4+c2]
    seq_len: int
    c3: np.ndarray = None   # [64] int64 (K=3 only)

    @property
    def K(self) -> int:
        return 3 if self.c3 is not None else 2

    def nbytes(self) -> int:
        return self.fused.nbytes + self.c2.nbytes


def extract_bwt(idx) -> np.ndarray:
    """BWT chars (uint8, 4 at the sentinel row) from the checkpoint
    masks (the index stores the BWT only in that form)."""
    n = idx.seq_len
    nb = idx.cp_mask.shape[0]
    # bit (31 - y) of mask[block, c] set <=> BWT[block*32 + y] == c
    masks = idx.cp_mask.astype(np.uint32)              # [nb, 4]
    shifts = (31 - np.arange(CP2_BLOCK, dtype=np.uint32))
    bwt = np.full(nb * CP2_BLOCK, 4, dtype=np.uint8)
    for c in range(4):
        bits = (masks[:, c][:, None] >> shifts[None, :]) & 1
        bwt[bits.reshape(-1).astype(bool)] = c
    return bwt[:n]


def _class_checkpoints(classes: np.ndarray, ncls: int, n: int):
    """(counts [nb, ncls] exclusive-cumulative, masks [nb, ncls]
    uint32) for a per-position class array (ncls = invalid)."""
    nb = (n + CP2_BLOCK - 1) >> CP2_SHIFT
    npad = nb * CP2_BLOCK
    cls_pad = np.full(npad, ncls, dtype=np.int64)
    cls_pad[:n] = classes
    block = np.arange(npad, dtype=np.int64) >> CP2_SHIFT
    per_block = np.bincount(
        block * (ncls + 1) + cls_pad,
        minlength=nb * (ncls + 1)).reshape(nb, ncls + 1)[:, :ncls]
    counts = np.zeros((nb, ncls), dtype=np.int64)
    counts[1:] = np.cumsum(per_block, axis=0)[:-1]
    shifts = (31 - np.arange(CP2_BLOCK, dtype=np.uint32))
    masks = np.zeros((nb, ncls), dtype=np.uint32)
    pp = cls_pad.reshape(nb, CP2_BLOCK)
    for c in range(ncls):
        bits = (pp == c).astype(np.uint32)
        masks[:, c] = (bits << shifts[None, :]).sum(
            axis=1, dtype=np.uint32)
    return counts, masks


def build_cp2(idx, K: int = 2) -> Cp2Table:
    """Build the k-gram checkpoint table from an FMIndex artifact."""
    if not idx.pos_fits_int32:
        raise ValueError("k-step table supports int32-position "
                         "genomes only (see module doc)")
    if K not in (2, 3):
        raise ValueError("K must be 2 or 3")
    n = idx.seq_len
    count = np.asarray(idx.count, dtype=np.int64)
    bwt = extract_bwt(idx)

    # LF as a permutation: LF over the c-class is count[c] + rank
    lf = np.zeros(n, dtype=np.int64)
    for c in range(4):
        rows = np.flatnonzero(bwt == c)
        lf[rows] = count[c] + np.arange(len(rows), dtype=np.int64)
    second = np.full(n, 4, dtype=np.uint8)
    has = bwt < 4
    second[has] = bwt[lf[has]]

    pair = np.full(n, 16, dtype=np.int64)       # 16 = no bigram class
    both = has & (second < 4)
    pair[both] = bwt[both].astype(np.int64) * 4 + second[both]
    counts2, masks2 = _class_checkpoints(pair, 16, n)

    parts = [counts2.astype(np.int32), masks2.view(np.int32),
             np.asarray(idx.cp_count, dtype=np.int32),
             np.asarray(idx.cp_mask).view(np.int32)]

    # C2[c1,c2] = C[c2] + occ1(C[c1], c2)
    cum1 = {c: np.cumsum(bwt == c) for c in range(4)}

    def occ1_at(p, c):
        return int(cum1[c][p - 1]) if p > 0 else 0

    occ_at = np.zeros((4, 4), dtype=np.int64)
    for c2 in range(4):
        for c1 in range(4):
            occ_at[c1, c2] = occ1_at(int(count[c1]), c2)
    c2tab = (count[None, :4] + occ_at).reshape(16).astype(np.int64)

    c3tab = None
    if K == 3:
        third = np.full(n, 4, dtype=np.uint8)
        third[both] = bwt[lf[lf[both]]]
        tri = np.full(n, 64, dtype=np.int64)
        all3 = both & (third < 4)
        tri[all3] = pair[all3] * 4 + third[all3]
        counts3, masks3 = _class_checkpoints(tri, 64, n)
        parts = [counts3.astype(np.int32),
                 masks3.view(np.int32)] + parts
        # C3[c1,c2,c3] = C[c3] + occ1(C2[c1,c2], c3): telescoping the
        # monotone LF^2 image of the (c1,c2) class exactly as for C2
        c3tab = np.zeros(64, dtype=np.int64)
        for p in range(16):
            base = int(c2tab[p])
            for c3 in range(4):
                c3tab[p * 4 + c3] = count[c3] + occ1_at(base, c3)

    fused = np.concatenate(parts, axis=1)
    assert fused.shape[1] == (168 if K == 3 else 40)
    return Cp2Table(fused=np.ascontiguousarray(fused),
                    c2=c2tab, seq_len=n, c3=c3tab)


def save_cp2(t: Cp2Table, prefix: str) -> str:
    path = f"{prefix}.cp{t.K}.npz"
    kw = {}
    if t.c3 is not None:
        kw["c3"] = t.c3
    np.savez(path, fused=t.fused, c2=t.c2,
             seq_len=np.int64(t.seq_len), **kw)
    return path


def load_cp2(path: str) -> Cp2Table:
    from ..utils.npzmap import load_npz_mmap
    z = load_npz_mmap(path)
    return Cp2Table(fused=z["fused"], c2=z["c2"],
                    seq_len=int(z["seq_len"]),
                    c3=z["c3"] if "c3" in z else None)
