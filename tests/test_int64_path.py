"""int64 reference-position path (genomes with 2*l_pac >= 2^31).

hg38's fw+rc coordinate space is 6.2e9 positions, so every device
position (cp_occ checkpoints, SA samples, rbeg/rmax spans) must run in
int64 — the analogue of the reference's 40-bit positions
(src/FMI_search.cpp:1288). DeviceFMIndex.from_host(force_int64=True)
exercises that exact code path (cp_fused=None branch of ops/occ.py) on
a small genome, and the full pipeline must be bit-identical to the
int32 run.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.slow

from bwa_mem_scale_tpu.config import MemOptions
from bwa_mem_scale_tpu.ops.occ import DeviceFMIndex
from bwa_mem_scale_tpu.pipeline.align import TpuAligner, PipelineConfig


def _mk_reads(bns, n, L, seed=21):
    rng = np.random.RandomState(seed)
    comp = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
    codes = np.full((n, L), 4, np.int32)
    lens = np.full(n, L, np.int32)
    g = bns.seq
    for i in range(n):
        p = rng.randint(0, len(g) - L)
        s = g[p: p + L].astype(np.uint8).copy()
        s[rng.rand(L) < 0.02] = rng.randint(0, 4)
        if i % 2:
            s = comp[s[::-1]]
        codes[i] = s
    return codes, lens


@pytest.mark.parametrize("engine", ["sweep", "readlane"])
def test_int64_pipeline_bit_equal(small_index, engine):
    cfg = PipelineConfig(max_coords=64, max_chains=8,
                         max_seeds_per_chain=8, max_regs=8,
                         max_pairs=256, seed_engine=engine)
    codes, lens = _mk_reads(small_index.bns, 16, 100)
    recs = []
    for force in (False, True):
        al = TpuAligner(small_index, MemOptions(), cfg)
        if force:
            al.fmi = DeviceFMIndex.from_host(small_index,
                                             force_int64=True)
            assert al.fmi.pos_dtype == np.int64
            assert al.fmi.cp_fused is None   # int64 branch in occ
        else:
            assert al.fmi.pos_dtype == np.int32
        out = al.align_and_finalize(codes, lens)
        recs.append([[(r.rid, r.pos, r.mapq, r.NM,
                       tuple(r.cigar or ()))
                      for r in rr] for rr in out])
    assert recs[0] == recs[1]


def test_int64_sal_and_occ_bit_equal(small_index):
    """occ/backward_ext and SA resolution agree across position
    dtypes at the kernel level."""
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.occ import backward_ext_all4

    f32 = DeviceFMIndex.from_host(small_index)
    f64 = DeviceFMIndex.from_host(small_index, force_int64=True)
    n = small_index.seq_len
    rng = np.random.RandomState(7)
    k = rng.randint(0, n - 1, size=256)
    s = rng.randint(1, 50, size=256)
    s = np.minimum(s, n - k)
    l = rng.randint(0, n - 1, size=256)
    for f, dt in ((f32, np.int32), (f64, np.int64)):
        k4, l4, s4 = backward_ext_all4(
            f, jnp.asarray(k, dt), jnp.asarray(l, dt),
            jnp.asarray(s, dt))
        got = (np.asarray(k4), np.asarray(l4), np.asarray(s4))
        if dt == np.int32:
            want = got
        else:
            assert np.array_equal(want[0], got[0])
            assert np.array_equal(want[1], got[1])
            assert np.array_equal(want[2], got[2])


def test_ref_byte_2d_layout():
    """hg38-class refs are packed 2-D so gather indices fit int32;
    ref_byte must be bit-equal across layouts, fw-only included."""
    import numpy as np
    import jax.numpy as jnp
    from bwa_mem_scale_tpu.ops.occ import ref_byte

    rng = np.random.RandomState(3)
    l_pac = 1000
    fw = rng.randint(0, 4, l_pac).astype(np.uint8)
    full = np.concatenate([fw, 3 - fw[::-1]])
    pos = jnp.asarray(rng.randint(0, 2 * l_pac, 256))

    def pack2d(a):
        pad = (-len(a)) % 16
        return jnp.asarray(np.concatenate(
            [a, np.zeros(pad, np.uint8)]).reshape(-1, 16))

    want = np.asarray(ref_byte(jnp.asarray(full), pos, l_pac))
    for ref in (jnp.asarray(fw), pack2d(fw), pack2d(full)):
        got = np.asarray(ref_byte(ref, pos, l_pac))
        np.testing.assert_array_equal(got, want)
