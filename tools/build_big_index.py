"""Genome-scale index build driver with phase timing + RSS logging.

Runs the same code path as `cli index` (parse_fasta -> build_index ->
save_index) but reports per-phase wall time and peak memory, which is
how the hg38-scale build is validated and measured.

  python tools/build_big_index.py ref.fa -p prefix
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from bwa_mem_scale_tpu.index.bntseq import parse_fasta
from bwa_mem_scale_tpu.index import build
from bwa_mem_scale_tpu.index.artifacts import save_index


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("fasta")
    ap.add_argument("-p", "--prefix", required=True)
    ap.add_argument("-s", "--sa-compx", type=int, default=None,
                    help="SA compression exponent (default: the "
                         "build default; 0 keeps the full SA "
                         "resident — single-gather SAL, the "
                         "MEMSCALE memory-for-speed knob)")
    args = ap.parse_args()

    t0 = time.time()
    bns = parse_fasta(args.fasta)
    t1 = time.time()
    print(f"parse_fasta: {t1-t0:.1f}s  l_pac={bns.l_pac:,} "
          f"({len(bns.anns)} contigs, {len(bns.ambs)} holes) "
          f"rss={rss_gb():.1f}G", flush=True)

    text = bns.full_text()
    t2 = time.time()
    print(f"full_text: {t2-t1:.1f}s  n={len(text):,} rss={rss_gb():.1f}G",
          flush=True)

    sa = build.suffix_array(text)
    t3 = time.time()
    print(f"suffix_array: {t3-t2:.1f}s "
          f"({len(text)/(t3-t2)/1e6:.2f} Mchar/s) rss={rss_gb():.1f}G",
          flush=True)

    bwt, sentinel_index = build.bwt_from_sa(text, sa)
    compx = (build.DEFAULT_SA_COMPX if args.sa_compx is None
             else args.sa_compx)
    sa_samples = sa[:: 1 << compx].astype(np.int64)
    del sa
    t4 = time.time()
    print(f"bwt+samples: {t4-t3:.1f}s rss={rss_gb():.1f}G", flush=True)

    base_counts = np.bincount(text, minlength=4)[:4]
    count = np.zeros(5, dtype=np.int64)
    count[1:] = np.cumsum(base_counts)
    count += 1
    cp_count, cp_mask = build.build_cp_occ(bwt)
    del bwt
    t5 = time.time()
    print(f"cp_occ: {t5-t4:.1f}s rss={rss_gb():.1f}G", flush=True)

    from bwa_mem_scale_tpu.index.artifacts import FMIndex
    idx = FMIndex(
        seq_len=len(text) + 1, count=count, cp_count=cp_count,
        cp_mask=cp_mask, sa_samples=sa_samples,
        sa_compx=compx, sentinel_index=sentinel_index,
        bns=bns, ref_string=text)
    path = save_index(idx, args.prefix)
    t6 = time.time()
    print(f"save_index: {t6-t5:.1f}s -> {path} rss={rss_gb():.1f}G",
          flush=True)
    print(f"TOTAL: {(t6-t0)/60:.1f} min", flush=True)


if __name__ == "__main__":
    main()
