"""Read-axis sharding over a virtual 8-device mesh must reproduce the
unsharded extend results exactly — including global read indices in
the packed output matrix (column 1 is shard-local before the
globalization in parallel/mesh.local_step)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.slow

from bwa_mem_scale_tpu.config import MemOptions
from bwa_mem_scale_tpu.pipeline.align import (PipelineConfig,
                                              seed_chain_extend)
from bwa_mem_scale_tpu.models.aligner import (build_demo_aligner,
                                              simulate_reads)
from bwa_mem_scale_tpu.parallel.mesh import make_mesh, sharded_align_fn


def _regions_by_read(packed):
    out = {}
    for row in np.asarray(packed).reshape(-1, packed.shape[-1]):
        if not row[0]:
            continue
        rb = (int(row[11]) << 31) | int(row[10])
        re = (int(row[13]) << 31) | int(row[12])
        out.setdefault(int(row[1]), []).append(
            (int(row[2]), int(row[3]), int(row[4]), rb, re))
    return {k: sorted(v) for k, v in out.items()}


def test_sharded_extend_matches_unsharded():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    opt = MemOptions()
    cfg = PipelineConfig(max_coords=64, max_chains=8,
                        max_seeds_per_chain=8, max_regs=8)
    aligner = build_demo_aligner(genome_bp=12000, opt=opt, cfg=cfg)
    L = 64
    B = 16
    codes, lens = simulate_reads(aligner.idx.bns, B, L, err_rate=0.02)
    codes = jnp.asarray(np.asarray(codes, np.int32))
    lens = jnp.asarray(np.asarray(lens, np.int32))

    mesh = make_mesh(8)
    fn = sharded_align_fn(mesh, opt, cfg, L)
    out = fn(aligner.fmi, aligner.dbns, codes, lens)
    got = _regions_by_read(np.asarray(out["packed"]))

    ref = jax.jit(lambda f, d, c, l: seed_chain_extend(
        f, d, c, l, L=L, opt=opt, cfg=cfg, fma=None, ert=None))(
        aligner.fmi, aligner.dbns, codes, lens)
    want = _regions_by_read(np.asarray(ref["packed"]))
    assert got == want


def _write_fastq(path, reads):
    bases = "ACGT"
    with open(path, "w") as f:
        for name, s in reads:
            txt = "".join(bases[min(int(c), 3)] for c in s)
            f.write(f"@{name}\n{txt}\n+\n{'I' * len(s)}\n")


def _sam_body(text):
    return [ln for ln in text.splitlines() if not ln.startswith("@")]


def test_mesh_mem_end_to_end_sam_equal(small_index):
    """The CLI-level pipeline (EMF probe + extend + finalize + SE SAM)
    must emit byte-identical SAM on 1 device and on an 8-device mesh."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import io
    import tempfile, os
    from bwa_mem_scale_tpu.pipeline.align import TpuAligner
    from bwa_mem_scale_tpu.pipeline.driver import run_alignment
    from bwa_mem_scale_tpu.index.perfect import build_perfect_table

    opt = MemOptions()
    cfg = PipelineConfig(max_coords=64, max_chains=8,
                         max_seeds_per_chain=8, max_regs=8,
                         max_pairs=256)
    emf = build_perfect_table(small_index, seed_len=80)
    g = small_index.bns.seq
    rng = np.random.RandomState(5)
    reads = []
    for i in range(24):
        p = rng.randint(0, len(g) - 80)
        s = g[p: p + 80].astype(np.uint8).copy()
        if i % 3 == 0:   # 1/3 with errors -> EMF misses
            s[rng.rand(80) < 0.03] = rng.randint(0, 4)
        reads.append((f"r{i}", s))

    with tempfile.TemporaryDirectory() as d:
        fq = os.path.join(d, "r.fq")
        _write_fastq(fq, reads)
        outs = []
        for mesh in (None, make_mesh(8)):
            al = TpuAligner(small_index, MemOptions(), cfg, emf=emf,
                            mesh=mesh)
            buf = io.StringIO()
            n = run_alignment(al, [fq], buf, batch_reads=8)
            assert n == len(reads)
            outs.append(buf.getvalue())
    assert _sam_body(outs[0]) == _sam_body(outs[1])
    assert len(_sam_body(outs[0])) >= len(reads)


def test_mesh_device_emf_probe_path(small_index):
    """align_and_finalize (device EMF probe + extend, both sharded)
    matches the unsharded aligner record-for-record."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from bwa_mem_scale_tpu.pipeline.align import TpuAligner
    from bwa_mem_scale_tpu.index.perfect import build_perfect_table

    cfg = PipelineConfig(max_coords=64, max_chains=8,
                         max_seeds_per_chain=8, max_regs=8,
                         max_pairs=256)
    emf = build_perfect_table(small_index, seed_len=80)
    g = small_index.bns.seq
    rng = np.random.RandomState(9)
    B, L = 16, 80
    codes = np.full((B, L), 4, np.int32)
    lens = np.full(B, L, np.int32)
    for i in range(B):
        p = rng.randint(0, len(g) - L)
        s = g[p: p + L].astype(np.uint8).copy()
        if i % 2:
            s[rng.rand(L) < 0.03] = rng.randint(0, 4)
        codes[i] = s
    recs = []
    for mesh in (None, make_mesh(8)):
        al = TpuAligner(small_index, MemOptions(), cfg, emf=emf,
                        mesh=mesh)
        out = al.align_and_finalize(codes, lens)
        recs.append([[(r.rid, r.pos, r.cigar, r.mapq, r.flag)
                      for r in rr] for rr in out])
    assert recs[0] == recs[1]


def test_mesh_pe_end_to_end(small_index):
    """Paired-end under the mesh: interleaved
    proper pairs through align_pairs_and_finalize must match the
    unsharded aligner record-for-record, mate fields included."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from bwa_mem_scale_tpu.pipeline.align import TpuAligner
    from bwa_mem_scale_tpu.index.perfect import build_perfect_table

    cfg = PipelineConfig(max_coords=64, max_chains=8,
                         max_seeds_per_chain=8, max_regs=8,
                         max_pairs=256)
    emf = build_perfect_table(small_index, seed_len=80)
    g = small_index.bns.seq
    rng = np.random.RandomState(13)
    n_pairs, L = 8, 80
    codes = np.zeros((2 * n_pairs, L), np.int32)
    for p in range(n_pairs):
        isize = L + 60
        pos = rng.randint(0, len(g) - isize)
        r1 = g[pos: pos + L].astype(np.int32).copy()
        r2 = (3 - g[pos + isize - L: pos + isize][::-1]).astype(
            np.int32)
        if p % 3 == 0:
            r1[rng.rand(L) < 0.03] = rng.randint(0, 4)
        codes[2 * p], codes[2 * p + 1] = r1, r2
    lens = np.full(2 * n_pairs, L, np.int32)
    recs = []
    for mesh in (None, make_mesh(8)):
        al = TpuAligner(small_index, MemOptions(), cfg, emf=emf,
                        mesh=mesh)
        out, mates = al.align_pairs_and_finalize(codes, lens)
        # Mate fields in SAM (RNEXT/PNEXT/TLEN/0x20) all derive from
        # the mate Aln returned alongside the records (io/sam.py
        # aln_to_sam_line), so comparing (records, mates) covers them.
        recs.append((
            [[(r.rid, r.pos, r.mapq, r.flag, tuple(r.cigar or ()))
              for r in rr] for rr in out],
            [None if m is None else
             (m.rid, m.pos, m.is_rev, tuple(m.cigar or ()))
             for m in mates]))
    assert recs[0] == recs[1]
