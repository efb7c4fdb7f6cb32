"""Per-device-stage timing table (`mem -v 4`).

The reference prints a per-phase cycle matrix after every run
(display_stats, src/profiling.cpp:87-307). XLA fuses our whole batch
program, so per-stage attribution is recovered by timing jitted
PREFIXES of the pipeline on one representative batch: seeding alone,
then +SA lookup, then +chaining, then the full program; successive
deltas are the stage costs. Each prefix returns a scalar reduction
over its outputs so nothing is dead-code-eliminated, and every timing
is taken on the second (warm) call so compile time is excluded.
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp


def _seed_bufs(aligner, fmi, codes, lens, fma, ert):
    opt, cfg = aligner.opt, aligner.cfg
    L = codes.shape[1]
    if ert is not None:
        from ..ops.ert import collect_smems_ert
        return collect_smems_ert(
            ert, fmi.ref, codes, lens,
            min_seed_len=opt.min_seed_len, split_len=opt.split_len,
            split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
            max_out=cfg.max_smem_out or L, pos_dtype=fmi.pos_dtype,
            seq_len=2 * fmi.l_pac)
    if cfg.seed_engine == "readlane":
        from ..ops.smem_rl import collect_smems_rl
        return collect_smems_rl(
            fmi, codes, lens,
            min_seed_len=opt.min_seed_len, split_len=opt.split_len,
            split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
            max_out=cfg.max_smem_out or L, lanes=cfg.seed_lanes)
    if cfg.seed_engine == "onehot":
        from ..ops.smem_oh import collect_smems_oh
        return collect_smems_oh(
            fmi, codes, lens,
            min_seed_len=opt.min_seed_len, split_len=opt.split_len,
            split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
            max_out=cfg.max_smem_out or L)
    from ..ops.smem import collect_smems_device
    return collect_smems_device(
        fmi, codes, lens,
        min_seed_len=opt.min_seed_len, split_len=opt.split_len,
        split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
        max_out=cfg.max_smem_out or L, fma=fma)


def device_stage_profile(aligner, codes, lens, file=sys.stderr):
    """Print the incremental stage table for one batch."""
    from ..ops.sal import expand_and_lookup
    from ..ops.chain import chain_seeds_device, chain_filter_device

    opt, cfg = aligner.opt, aligner.cfg
    fmi, dbns = aligner.fmi, aligner.dbns
    fma, ert = aligner.dfma, aligner.dert
    codes = jnp.asarray(codes, jnp.int32)
    lens = jnp.asarray(lens, jnp.int32)
    B = int(codes.shape[0])

    def p_seed(fmi, codes, lens, fma, ert):
        bufs = _seed_bufs(aligner, fmi, codes, lens, fma, ert)
        return (bufs.cnt.sum() + bufs.k.sum() + bufs.s.sum())

    def p_sal(fmi, codes, lens, fma, ert):
        bufs = _seed_bufs(aligner, fmi, codes, lens, fma, ert)
        rbeg, seed_idx, cv, total, of = expand_and_lookup(
            fmi, bufs, opt.max_occ, cfg.max_coords)
        return rbeg.sum() + total.sum() + seed_idx.sum()

    def p_chain(fmi, dbns, codes, lens, fma, ert):
        bufs = _seed_bufs(aligner, fmi, codes, lens, fma, ert)
        rbeg, seed_idx, cv, total, of = expand_and_lookup(
            fmi, bufs, opt.max_occ, cfg.max_coords)
        ch = chain_seeds_device(
            dbns, bufs, rbeg, seed_idx, cv,
            w=opt.w, max_chain_gap=opt.max_chain_gap,
            max_chains=cfg.max_chains,
            max_seeds_per_chain=cfg.max_seeds_per_chain)
        order, kept, w_slot = chain_filter_device(
            ch, dbns, min_chain_weight=opt.min_chain_weight,
            mask_level=opt.mask_level, max_chain_gap=opt.max_chain_gap,
            drop_ratio=opt.drop_ratio, min_seed_len=opt.min_seed_len,
            max_chain_extend=opt.max_chain_extend)
        return (ch.n_seeds.sum() + ch.seed_rbeg.sum() + kept.sum()
                + order.sum().astype(jnp.int64))

    stages = [
        ("seed", jax.jit(p_seed)),
        ("+sa_lookup", jax.jit(p_sal)),
        ("+chain/filter", jax.jit(p_chain)),
    ]
    times = []
    names = []
    for name, fn in stages:
        args = ((fmi, codes, lens, fma, ert) if name == "seed"
                or name == "+sa_lookup"
                else (fmi, dbns, codes, lens, fma, ert))
        jax.block_until_ready(fn(*args))      # compile + warm
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
        names.append(name)
    # full program (the production jit, already compiled)
    L = int(codes.shape[1])
    jax.block_until_ready(aligner._jit_extend(fmi, dbns, codes, lens,
                                              L=L, fma=fma, ert=ert))
    t0 = time.perf_counter()
    jax.block_until_ready(aligner._jit_extend(fmi, dbns, codes, lens,
                                              L=L, fma=fma, ert=ert))
    times.append(time.perf_counter() - t0)
    names.append("+extend(full)")

    print(f"\nDevice stage profile (B={B}, L={L}, warm; incremental "
          f"prefixes):", file=file)
    prev = 0.0
    for name, t in zip(names, times):
        delta = t - prev
        print(f"  {name:<14} {t:7.3f}s  (stage {max(delta, 0.0):7.3f}s"
              f", {B / t:8.0f} reads/s cumulative)", file=file)
        prev = t
    return dict(zip(names, times))
