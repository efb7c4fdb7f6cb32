"""Oracle end-to-end single-end alignment pipeline.

Chains the oracle stages exactly as the reference's per-batch kernels do
(mem_kernel1_core -> mem_kernel2_core -> worker_sam SE path,
src/bwamem.cpp:1209-1850). Slow; used as the specification for the device
pipeline and in tests.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..config import MemOptions
from ..index.artifacts import FMIndex
from ..io.fastq import Read, ReadBatch
from ..io.sam import aln_to_sam_line
from .fm import FMOracle
from . import chain as chain_mod
from .extend import chain2aln
from .finalize import mark_primary, sort_dedup_patch, reg2sam_records


def align_read(fm: FMOracle, opt: MemOptions, query: np.ndarray,
               read_id: int):
    """Seed, chain, extend, finalize one read; returns final AlnReg list."""
    idx = fm.idx
    bns = idx.bns
    smems = fm.collect_smems(query, 0, opt)
    chains = chain_mod.chain_seeds(fm, opt, bns, query, 0, smems)
    chains = chain_mod.chain_flt(opt, chains)
    chain_mod.flt_chained_seeds(opt, bns, idx.ref_string, query, chains)
    regs = chain2aln(opt, bns, idx.ref_string, query, chains)
    regs = sort_dedup_patch(opt, bns, idx.ref_string, query, regs)
    regs, _ = mark_primary(opt, regs, read_id)
    return regs


def align_batch_to_sam(fm: FMOracle, opt: MemOptions, batch: ReadBatch,
                       id_offset: int = 0) -> List[str]:
    idx = fm.idx
    bns = idx.bns
    lines: List[str] = []
    for i, read in enumerate(batch.reads):
        regs = align_read(fm, opt, read.seq, id_offset + i)
        records = reg2sam_records(opt, bns, idx.ref_string, read.seq, regs)
        for which in range(len(records)):
            lines.append(aln_to_sam_line(opt, bns, read, len(records),
                                         records, which))
    return lines
