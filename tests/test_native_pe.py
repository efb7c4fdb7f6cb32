"""Native PE pipeline (finalize_pe_batch) vs the Python oracle
(pipeline/pe.py): per-record field equality and mate-field equality
over batches that exercise pestat, mate rescue, pairing, unpaired
fallbacks, ALT-free XA, and unmapped mates."""

import os

import numpy as np
import pytest

from conftest import make_genome

from bwa_mem_scale_tpu.config import MemOptions
from bwa_mem_scale_tpu.index.build import build_index
from bwa_mem_scale_tpu.pipeline.align import TpuAligner, PipelineConfig
from bwa_mem_scale_tpu.pipeline import native_finalize
from bwa_mem_scale_tpu.ref.ksw import cigar_rlen

pytestmark = [pytest.mark.skipif(not native_finalize.available(),
                                 reason="native finalize lib missing")]

L = 100


def _sim(bns, n_pairs, seed, err=0.02, break_every=5):
    rng = np.random.RandomState(seed)
    comp = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
    codes = np.full((2 * n_pairs, L), 4, dtype=np.int32)
    for p in range(n_pairs):
        frag = max(int(rng.normal(300, 25)), L + 10)
        pos = rng.randint(0, bns.l_pac - frag)
        r1 = bns.seq[pos: pos + L].copy()
        r2 = comp[bns.seq[pos + frag - L: pos + frag][::-1]].copy()
        for r in (r1, r2):
            m = rng.rand(L) < err
            r[m] = (r[m] + rng.randint(1, 4, max(int(m.sum()), 1))
                    [: int(m.sum())]) % 4
        if break_every and p % break_every == 3:
            # error-saturate one mate: forces the rescue path
            r2[:] = rng.randint(0, 4, L)
        codes[2 * p] = r1
        codes[2 * p + 1] = r2
    lens = np.full(2 * n_pairs, L, dtype=np.int32)
    return codes, lens


def _run(al, codes, lens, native):
    env = {}
    if not native:
        os.environ["BWA_TPU_NO_NATIVE_PE"] = "1"
    try:
        al.pes = None
        return al.align_pairs_and_finalize(codes, lens, id_offset=40)
    finally:
        os.environ.pop("BWA_TPU_NO_NATIVE_PE", None)


def _rec_key(recs):
    return [[(a.rid, a.pos, a.flag, a.mapq, a.score, a.sub, a.NM,
              a.alt_sc, a.is_rev, a.is_alt, tuple(a.cigar or ()),
              a.MD, a.XA) for a in rr] for rr in recs]


def _mate_key(mates):
    out = []
    for m in mates:
        if m is None or m.rid < 0:
            out.append(None)
        else:
            out.append((m.rid, m.pos, m.is_rev,
                        cigar_rlen(m.cigar) if m.cigar else 0))
    return out


def test_native_pe_matches_python():
    bns = make_genome(60000, seed=33)
    idx = build_index(bns)
    cfg = PipelineConfig(max_coords=64, max_chains=16,
                         max_seeds_per_chain=8, max_regs=16)
    al = TpuAligner(idx, MemOptions(), cfg)
    codes, lens = _sim(bns, 40, seed=9)
    recs_n, mates_n = _run(al, codes, lens, native=True)
    recs_p, mates_p = _run(al, codes, lens, native=False)
    assert _rec_key(recs_n) == _rec_key(recs_p)
    assert _mate_key(mates_n) == _mate_key(mates_p)


def test_native_pe_with_emf():
    bns = make_genome(60000, seed=34)
    idx = build_index(bns)
    from bwa_mem_scale_tpu.index.perfect import build_perfect_table
    emf = build_perfect_table(idx, seed_len=L)
    cfg = PipelineConfig(max_coords=64, max_chains=16,
                         max_seeds_per_chain=8, max_regs=16)
    al = TpuAligner(idx, MemOptions(), cfg, emf=emf)
    codes, lens = _sim(bns, 32, seed=10, err=0.0, break_every=4)
    recs_n, mates_n = _run(al, codes, lens, native=True)
    al2 = TpuAligner(idx, MemOptions(), cfg, emf=emf)
    recs_p, mates_p = _run(al2, codes, lens, native=False)
    assert _rec_key(recs_n) == _rec_key(recs_p)
    assert _mate_key(mates_n) == _mate_key(mates_p)


def test_native_pe_sam_text_matches_python():
    bns = make_genome(60000, seed=35)
    idx = build_index(bns)
    cfg = PipelineConfig(max_coords=64, max_chains=16,
                         max_seeds_per_chain=8, max_regs=16)
    al = TpuAligner(idx, MemOptions(), cfg)
    codes, lens = _sim(bns, 32, seed=11)
    B = codes.shape[0]
    names = [b"p%d" % i for i in range(B)]
    quals = [bytes([35 + (i % 38)] * L) for i in range(B)]
    ctx = dict(names=names, quals=quals, rg_id=None)
    al.pes = None
    sam, _ = al.pe_post(al.fetch_pairs(al.dispatch_pairs(
        codes, lens)), 40, sam_ctx=ctx)
    assert all(isinstance(s, bytes) for s in sam)

    from bwa_mem_scale_tpu.io.sam import compose_sam_python
    al2 = TpuAligner(idx, MemOptions(), cfg)
    al2.pes = None
    recs, mates = _run(al2, codes, lens, native=False)
    for i in range(B):
        want = compose_sam_python(al.opt, idx.bns,
                                  codes[i, : lens[i]], recs[i], ctx,
                                  i, mate=mates[i])
        assert sam[i] == want, (
            f"read {i}:\n native: {sam[i]!r}\n python: {want!r}")


def test_native_pe_overflow_retries_sam_matches_python():
    """Pairs whose candidates exceed max_regs take the overflow-retry
    path (ov_regs); the native PE SAM text must equal the Python path
    byte for byte, including the retried reads' frac_rep."""
    bns = make_genome(60000, seed=36)
    idx = build_index(bns)
    cfg = PipelineConfig(max_coords=64, max_chains=16,
                         max_seeds_per_chain=8, max_regs=2)
    codes, lens = _sim(bns, 24, seed=12, err=0.04)
    B = codes.shape[0]
    ctx = dict(names=[b"q%d" % i for i in range(B)],
               quals=[b"I" * L] * B, rg_id=None)
    al = TpuAligner(idx, MemOptions(), cfg)
    fetched = al.fetch_pairs(al.dispatch_pairs(codes, lens))
    assert fetched[0] == "raw" and fetched[-1], "no overflow retries"
    # a device fetch may hand back a read-only, column-major buffer,
    # whose meta[:, 0] is then a contiguous read-only view
    meta = np.asfortranarray(fetched[5])
    meta.flags.writeable = False
    fetched = fetched[:5] + (meta,) + fetched[6:]
    sam_n, _ = al.pe_post(fetched, 40, sam_ctx=ctx)
    al2 = TpuAligner(idx, MemOptions(), cfg)
    os.environ["BWA_TPU_NO_NATIVE_PE"] = "1"
    try:
        sam_p, _ = al2.pe_post(al2.fetch_pairs(al2.dispatch_pairs(
            codes, lens)), 40, sam_ctx=ctx)
    finally:
        os.environ.pop("BWA_TPU_NO_NATIVE_PE", None)
    assert sam_n == sam_p
