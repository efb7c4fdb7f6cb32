"""FM-index construction (offline toolchain).

Builds the device index artifact set from a FASTA, the counterpart of
the reference's ``bwa index`` path (reference: src/bwtindex.cpp:232,
src/FMI_search.cpp:773-870 build_index/build_fm_index):

  text  = forward + reverse-complement of the packed genome (2*l_pac)
  SA    = suffix array of text + virtual sentinel
  BWT   = text[SA[i]-1], sentinel row where SA[i]==0
  cp_occ= checkpointed occurrence blocks: per 32-bp block, the exclusive
          cumulative count of each base plus a one-hot uint32 bitmask per
          base (bit 31 = first position in block). occ(p, c) is then a
          single gather + masked popcount — the batched form of the
          reference's 64-bp GET_OCC (src/FMI_search.h:76-83).
  SA samples = every 2^SA_COMPX-th SA entry (src/macro.h:81-82).

Suffix array construction uses the C++ SA-IS native library when built
(native/libsais.so, see native/), else a NumPy prefix-doubling sort.
"""

from __future__ import annotations

import numpy as np

from .bntseq import BntSeq
from .artifacts import FMIndex, CP_SHIFT, CP_MASK, CP_BLOCK_SIZE

DEFAULT_SA_COMPX = 3  # sample SA every 8 rows, like the reference


def suffix_array_doubling(text: np.ndarray) -> np.ndarray:
    """Suffix array by prefix doubling (NumPy; O(n log^2 n)).

    ``text`` is uint8 codes; the virtual sentinel (smaller than any
    symbol) is appended internally. Returns SA of length len(text)+1 with
    SA[0] = len(text) (the sentinel suffix).
    """
    n = len(text) + 1
    rank = np.zeros(n, dtype=np.int64)
    rank[: n - 1] = text.astype(np.int64) + 1  # sentinel gets rank 0
    sa = np.argsort(rank, kind="stable")
    k = 1
    while True:
        # Sort by (rank[i], rank[i+k]) pairs.
        rank2 = np.zeros(n, dtype=np.int64)
        rank2[: n - k] = rank[k:]
        key = rank * (n + 1) + rank2
        sa = np.argsort(key, kind="stable")
        sorted_key = key[sa]
        new_rank = np.zeros(n, dtype=np.int64)
        new_rank[sa[1:]] = np.cumsum(sorted_key[1:] != sorted_key[:-1])
        rank = new_rank
        if rank[sa[-1]] == n - 1:
            break
        k <<= 1
    return sa


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of text+sentinel; prefers the native SA-IS library."""
    try:
        from . import native_sais
        return native_sais.suffix_array(text)
    except (ImportError, OSError):
        return suffix_array_doubling(text)


_BUILD_CHUNK = 1 << 26  # 64M rows per pass: keeps build temporaries <1 GB


def bwt_from_sa(text: np.ndarray, sa: np.ndarray) -> tuple[np.ndarray, int]:
    """BWT over text+sentinel. Sentinel row marked with code 4.

    Returns (bwt codes uint8 [n+1], sentinel_index). Chunked so the
    int64 fancy-index temporaries stay bounded at genome scale (an
    hg38-class SA is ~50 GB; whole-array `sa - 1` would double it).
    Prefers the native prefetching extractor (~3x on large texts)."""
    try:
        from . import native_sais
        return native_sais.bwt_from_sa(text, sa)
    except (ImportError, OSError):
        pass
    n = len(sa)
    bwt = np.empty(n, dtype=np.uint8)
    sentinel_index = -1
    for lo in range(0, n, _BUILD_CHUNK):
        hi = min(lo + _BUILD_CHUNK, n)
        sac = sa[lo:hi]
        zeros = np.flatnonzero(sac == 0)
        prev = sac - 1
        if zeros.size:
            sentinel_index = lo + int(zeros[0])
            prev[zeros] = 0
        bwt[lo:hi] = text[prev]
        if zeros.size:
            bwt[lo + zeros] = 4
    assert sentinel_index >= 0
    return bwt, sentinel_index


def build_cp_occ(bwt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Checkpointed occ blocks from the BWT.

    Returns (cp_count int64 [nblocks,4], cp_mask uint32 [nblocks,4]).
    cp_count[b, c] = #occurrences of c strictly before block b.
    cp_mask[b, c] bit (31-j) set iff bwt[b*32+j] == c.
    """
    n = len(bwt)
    nblocks = (n + CP_BLOCK_SIZE - 1) // CP_BLOCK_SIZE
    cp_mask = np.empty((nblocks, 4), dtype=np.uint32)
    cp_count = np.empty((nblocks, 4), dtype=np.int64)
    # Chunked over blocks: the one-hot temporaries would be ~16x the
    # BWT if materialized whole (hg38-class: ~100 GB).
    blk_chunk = max(1, _BUILD_CHUNK // CP_BLOCK_SIZE)
    running = np.zeros(4, dtype=np.int64)
    for b0 in range(0, nblocks, blk_chunk):
        b1 = min(b0 + blk_chunk, nblocks)
        lo, hi = b0 * CP_BLOCK_SIZE, b1 * CP_BLOCK_SIZE
        if hi <= n:
            blocks = bwt[lo:hi].reshape(-1, CP_BLOCK_SIZE)
        else:
            padded = np.full((b1 - b0) * CP_BLOCK_SIZE, 6, dtype=np.uint8)
            padded[: n - lo] = bwt[lo:n]
            blocks = padded.reshape(-1, CP_BLOCK_SIZE)
        per_block = np.empty((b1 - b0, 4), dtype=np.int64)
        for c in range(4):
            bits = blocks == np.uint8(c)                      # [nb, 32]
            # packbits is MSB-first: byte0 bit7 = block position 0, so a
            # big-endian uint32 view lands position 0 on bit 31 — the
            # occ prefix-mask convention of ops/occ.py.
            pb = np.packbits(bits, axis=1)                    # [nb, 4] u8
            cp_mask[b0:b1, c] = pb.view(">u4")[:, 0]
            per_block[:, c] = bits.sum(axis=1)
        cp_count[b0] = running
        np.cumsum(per_block[:-1], axis=0, out=cp_count[b0 + 1:b1])
        cp_count[b0 + 1:b1] += running
        running = running + per_block.sum(axis=0)
    return cp_count, cp_mask


def build_index(bns: BntSeq, sa_compx: int = DEFAULT_SA_COMPX) -> FMIndex:
    """Full index build from genome metadata."""
    text = bns.full_text()
    sa = suffix_array(text)
    bwt, sentinel_index = bwt_from_sa(text, sa)
    sa_samples = sa[:: 1 << sa_compx].astype(np.int64)
    del sa  # hg38-class SA is ~50 GB; release before cp_occ build

    # Cumulative base counts, sentinel included as rank 0
    # (matches the reference's count[]+1 after load, FMI_search.cpp:1304-1308).
    base_counts = np.bincount(text, minlength=4)[:4]
    count = np.zeros(5, dtype=np.int64)
    count[1:] = np.cumsum(base_counts)
    count += 1

    cp_count, cp_mask = build_cp_occ(bwt)
    del bwt

    return FMIndex(
        seq_len=len(text) + 1,
        count=count,
        cp_count=cp_count,
        cp_mask=cp_mask,
        sa_samples=sa_samples,
        sa_compx=sa_compx,
        sentinel_index=sentinel_index,
        bns=bns,
        ref_string=text,
    )
