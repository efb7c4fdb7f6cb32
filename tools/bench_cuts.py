"""Cut-point timing inside seed_chain_extend on the real chip.

Times jitted prefixes at each `cut` point (enum, seqs, bsw1, bswL,
bswLR1) plus the full program; deltas attribute the extension stage's
internal cost (the stage table's `filter+BSW+rest` lump).

Run on chip:  python tools/bench_cuts.py
"""

import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

import bench
from bwa_mem_scale_tpu.models.aligner import simulate_reads
from bwa_mem_scale_tpu.pipeline.align import seed_chain_extend

REPS = int(os.environ.get("BENCH_REPS", 3))


def main():
    print(f"* devices: {jax.devices()}", file=sys.stderr)
    al = bench.get_aligner()
    B, L = bench.BATCH, bench.READ_LEN
    seed0 = int(time.time()) % 1000000
    batches = [simulate_reads(al.idx.bns, B, L, seed=seed0 + i,
                              err_rate=0.01) for i in range(REPS + 1)]

    prev = 0.0
    for cut in ("enum", "seqs", "bsw1", "bswL", "bswLR1", None):
        fn = jax.jit(partial(seed_chain_extend, L=L, opt=al.opt,
                             cfg=al.cfg, cut=cut),
                     static_argnames=())
        def run(codes, lens):
            out = fn(al.fmi, al.dbns, jnp.asarray(codes, jnp.int32),
                     jnp.asarray(lens, jnp.int32), fma=al.dfma,
                     ert=al.dert)
            leaf = jax.tree_util.tree_leaves(out)[0]
            jax.block_until_ready(leaf)
        run(*batches[0])                    # compile + warm
        t0 = time.perf_counter()
        for b in batches[1:]:
            run(*b)
        dt = (time.perf_counter() - t0) / REPS
        name = cut or "full"
        print(f"  {name:<8} {dt:7.3f} s/batch  (delta {dt - prev:7.3f})")
        prev = dt


if __name__ == "__main__":
    main()
