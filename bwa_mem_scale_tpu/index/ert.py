"""ERT — Enumerated Radix Tree index, device formulation.

The reference's ERT (src/ertindex.cpp: per-15-mer byte-serialized
radix trees with EMPTY/LEAF/UNIFORM/DIVERGE nodes and 40-bit reference
pointers, walked by a sequential byte decoder in src/ertseeding.cpp)
exists to replace cache-hostile FM-index occ walks with pointer-light
tree descent and direct reference positions at the leaves.

Device re-design: since this framework's FM bi-interval `k` is
exactly the suffix-array range start, the ERT becomes a suffix TRIE
over the fw+rc text whose nodes carry their SA ranges:

  kmer table  [4^K]   (lo, cnt, ptr) after the first K bases
  child_ptr   [N, 4]  per node/base: >= 0 -> child node id;
                      -1 -> empty; else -(sa_row)-2 -> single leaf
  node_lo     [N]     SA range start of the node
  node_cnt    [N]     SA range size

Device descent (ops/ert.py) costs ONE row gather per step (vs two
fused occ gathers for FM extension); single-hit paths degrade to one
reference-byte compare per step (the reference's lazy leaf
verification, src/ertseeding.cpp:2950); and seed coordinates come
straight from the resident SA — the reference's memory-for-speed
contract. Because nodes carry true SA ranges, the ERT seeder's output
is bit-identical to the FM seeder's, k included (tested).

The builder is a vectorized level-BFS over SA ranges: rows within an
SA range are already sorted by the character at the current depth, so
splitting every active range is one global gather + bincount — no
recursion, no per-node Python. The only subtlety is the at-most-one
row per range whose suffix ends exactly at the split depth (the
sentinel character): it sorts first and belongs to no child.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

DEFAULT_ERT_K = 12
DEFAULT_MAX_DEPTH = 320   # reference LEP bitvector cap (ertseeding.h:100)


@dataclasses.dataclass
class ErtIndex:
    """Host ERT artifact (the reference's .kmer_table/.mlt_table)."""

    K: int
    max_depth: int
    kmer_lo: np.ndarray     # int64 [4^K] SA range start
    kmer_cnt: np.ndarray    # int32 [4^K] SA range size
    kmer_ptr: np.ndarray    # int64 [4^K] child encoding (see module doc)
    node_lo: np.ndarray     # int64 [N]
    node_cnt: np.ndarray    # int32 [N]
    child_ptr: np.ndarray   # int64 [N, 4]
    root_children: np.ndarray  # int64 [4] depth-1 encodings

    @property
    def n_nodes(self) -> int:
        return len(self.node_lo)


def _split_children(text, sa, n, lo, hi, d):
    """Split SA ranges [lo, hi) by the suffix character at offset d.

    Returns flat (child_lo, child_hi, parent_index, base) for bases
    0..3; the at-most-one ends-here row per range is skipped.
    """
    reps = (hi - lo).astype(np.int64)
    total = int(reps.sum())
    parent = np.repeat(np.arange(len(lo), dtype=np.int64), reps)
    offs = (np.arange(total, dtype=np.int64)
            - np.repeat(np.cumsum(reps) - reps, reps))
    rows = lo[parent] + offs
    pos = sa[rows] + d
    ch = np.where(pos < n, text[np.minimum(pos, n - 1)],
                  4).astype(np.int64)
    cnt = np.bincount(parent * 5 + ch,
                      minlength=len(lo) * 5).reshape(len(lo), 5)
    seg_start = np.empty((len(lo), 4), dtype=np.int64)
    seg_start[:, 0] = lo + cnt[:, 4]       # ends-here row sorts first
    for b in range(1, 4):
        seg_start[:, b] = seg_start[:, b - 1] + cnt[:, b - 1]
    out_lo, out_hi, out_p, out_b = [], [], [], []
    for b in range(4):
        m = cnt[:, b] > 0
        out_lo.append(seg_start[m, b])
        out_hi.append(seg_start[m, b] + cnt[m, b])
        out_p.append(np.flatnonzero(m).astype(np.int64))
        out_b.append(np.full(int(m.sum()), b, dtype=np.int64))
    return (np.concatenate(out_lo), np.concatenate(out_hi),
            np.concatenate(out_p), np.concatenate(out_b))


def build_ert(text: np.ndarray, sa: np.ndarray, K: int = DEFAULT_ERT_K,
              max_depth: int = DEFAULT_MAX_DEPTH) -> ErtIndex:
    """Level-BFS construction from the fw+rc text (uint8 codes) and its
    suffix array (row 0 = sentinel, as built by index/build.py).

    Nodes are materialized for every depth >= 1 (cnt >= 2 ranges);
    root_children holds the four depth-1 encodings. Singleton ranges
    ride along in the frontier until depth K purely to populate the
    kmer table (their chars are read off the text), then drop out —
    the device walk verifies them lazily against the reference.
    """
    n = len(text)
    sa = np.asarray(sa, dtype=np.int64)

    node_lo: List[np.ndarray] = []
    node_cnt: List[np.ndarray] = []
    all_children: List[np.ndarray] = []
    n_nodes = 0

    def alloc_nodes(lo, cnt):
        nonlocal n_nodes
        ids = np.arange(n_nodes, n_nodes + len(lo), dtype=np.int64)
        n_nodes += len(lo)
        node_lo.append(lo.copy())
        node_cnt.append(cnt.astype(np.int32))
        return ids

    def encode(lo, cnt):
        enc = np.full(len(lo), -1, dtype=np.int64)
        one = cnt == 1
        enc[one] = -lo[one] - 2
        multi = cnt >= 2
        enc[multi] = alloc_nodes(lo[multi], cnt[multi])
        return enc

    # depth-1 ranges: skip the sentinel row; chars of sa[1:] are sorted
    c0 = text[sa[1:]]
    bounds = np.searchsorted(c0, np.arange(5), side="left") + 1
    lo1 = bounds[:4].astype(np.int64)
    cnt1 = (bounds[1:5] - bounds[:4]).astype(np.int64)
    root_children = encode(lo1, cnt1)

    # frontier of multi ranges awaiting a split (aligned with node ids)
    keepm = cnt1 >= 2
    cur_lo, cur_hi = lo1[keepm], lo1[keepm] + cnt1[keepm]
    cur_id = root_children[keepm]
    # kmer-path tracking (multi + singleton lanes) until depth K
    km_lo = lo1[cnt1 >= 1]
    km_hi = (lo1 + cnt1)[cnt1 >= 1]
    km_path = np.arange(4, dtype=np.int64)[cnt1 >= 1]

    nk = 4 ** K
    kmer_lo = np.zeros(nk, dtype=np.int64)
    kmer_cnt = np.zeros(nk, dtype=np.int32)
    kmer_ptr = np.full(nk, -1, dtype=np.int64)

    depth = 1
    while (len(cur_lo) or (depth <= K and len(km_lo))) \
            and depth < max_depth:
        if len(cur_lo):
            s_lo, s_hi, s_parent, s_base = _split_children(
                text, sa, n, cur_lo, cur_hi, depth)
            cnts = s_hi - s_lo
            enc = encode(s_lo, cnts)
            rows = np.full((len(cur_lo), 4), -1, dtype=np.int64)
            rows[s_parent, s_base] = enc
            all_children.append(rows)
            keep = cnts >= 2
            nxt_lo, nxt_hi = s_lo[keep], s_hi[keep]
        else:
            nxt_lo = nxt_hi = np.zeros(0, dtype=np.int64)

        if depth <= K and len(km_lo):
            # advance kmer paths: split multis, verify singletons
            one = (km_hi - km_lo) == 1
            srow = km_lo[one]
            spos = sa[srow] + depth
            sch = np.where(spos < n, text[np.minimum(spos, n - 1)],
                           4).astype(np.int64)
            sok = sch < 4
            s_next_lo = srow[sok]
            s_next_path = km_path[one][sok] * 4 + sch[sok]
            m_lo, m_hi = km_lo[~one], km_hi[~one]
            m_path = km_path[~one]
            if len(m_lo):
                t_lo, t_hi, t_parent, t_base = _split_children(
                    text, sa, n, m_lo, m_hi, depth)
                t_path = m_path[t_parent] * 4 + t_base
            else:
                t_lo = t_hi = t_path = np.zeros(0, dtype=np.int64)
            km_lo = np.concatenate([t_lo, s_next_lo])
            km_hi = np.concatenate([t_hi, s_next_lo + 1])
            km_path = np.concatenate([t_path, s_next_path])
            if depth == K - 1:
                # frontier is now at depth K: fill the kmer table
                kmer_lo[km_path] = km_lo
                kmer_cnt[km_path] = (km_hi - km_lo).astype(np.int32)
                one_k = (km_hi - km_lo) == 1
                kmer_ptr[km_path[one_k]] = -km_lo[one_k] - 2
                # multi entries point at their nodes: those nodes were
                # just allocated in this level's encode() pass; match
                # them positionally via a (lo, cnt) lookup of the level
                lvl_lo = node_lo[-1] if node_lo else np.zeros(0)
                # nodes of this level are the last alloc batch(es);
                # build a dict for the multi kmer ranges
                mk = ~one_k
                if mk.any():
                    id_of = {}
                    base_id = n_nodes - len(node_lo[-1]) \
                        if node_lo else 0
                    for off, (a, b) in enumerate(
                            zip(node_lo[-1], node_cnt[-1])):
                        id_of[(int(a), int(b))] = base_id + off
                    ids = np.array(
                        [id_of[(int(a), int(b - a))]
                         for a, b in zip(km_lo[mk], km_hi[mk])],
                        dtype=np.int64)
                    kmer_ptr[km_path[mk]] = ids
                km_lo = np.zeros(0, dtype=np.int64)
                km_hi = np.zeros(0, dtype=np.int64)
                km_path = np.zeros(0, dtype=np.int64)

        cur_lo, cur_hi = nxt_lo, nxt_hi
        depth += 1

    if len(cur_lo):
        # depth cap: terminal nodes, matches cannot extend past it
        all_children.append(np.full((len(cur_lo), 4), -1,
                                    dtype=np.int64))

    child_ptr = (np.concatenate(all_children, axis=0) if all_children
                 else np.zeros((0, 4), dtype=np.int64))
    node_lo_a = (np.concatenate(node_lo) if node_lo
                 else np.zeros(0, dtype=np.int64))
    node_cnt_a = (np.concatenate(node_cnt) if node_cnt
                  else np.zeros(0, dtype=np.int32))
    assert len(child_ptr) == len(node_lo_a) == n_nodes, \
        (len(child_ptr), len(node_lo_a), n_nodes)
    return ErtIndex(K=K, max_depth=max_depth, kmer_lo=kmer_lo,
                    kmer_cnt=kmer_cnt, kmer_ptr=kmer_ptr,
                    node_lo=node_lo_a, node_cnt=node_cnt_a,
                    child_ptr=child_ptr, root_children=root_children)


def build_ert_from_index(idx, K: int = DEFAULT_ERT_K,
                         max_depth: int = DEFAULT_MAX_DEPTH) -> ErtIndex:
    """Build from an FMIndex artifact. Requires the full SA; with a
    sampled index the SA is recomputed from the stored text."""
    from .build import suffix_array
    if idx.sa_compx == 0:
        sa = idx.sa_samples
    else:
        sa = suffix_array(idx.ref_string)
    return build_ert(idx.ref_string, sa, K=K, max_depth=max_depth)


def save_ert(ert: ErtIndex, prefix: str) -> str:
    path = f"{prefix}.ert{ert.K}.npz"
    np.savez(path, K=np.int64(ert.K), max_depth=np.int64(ert.max_depth),
             kmer_lo=ert.kmer_lo, kmer_cnt=ert.kmer_cnt,
             kmer_ptr=ert.kmer_ptr, node_lo=ert.node_lo,
             node_cnt=ert.node_cnt, child_ptr=ert.child_ptr,
             root_children=ert.root_children)
    return path


def load_ert(path: str) -> ErtIndex:
    from ..utils.npzmap import load_npz_mmap
    z = load_npz_mmap(path)
    return ErtIndex(K=int(z["K"]), max_depth=int(z["max_depth"]),
                    kmer_lo=z["kmer_lo"], kmer_cnt=z["kmer_cnt"],
                    kmer_ptr=z["kmer_ptr"], node_lo=z["node_lo"],
                    node_cnt=z["node_cnt"], child_ptr=z["child_ptr"],
                    root_children=z["root_children"])
