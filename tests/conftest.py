import os
import sys

# Tests run on the CPU (the tier-1 command sets JAX_PLATFORMS=cpu) with 8
# virtual devices, so the multi-device sharding paths compile and execute
# without a GPU. The device count must be set before the first device use.
import jax  # noqa: E402
jax.config.update("jax_num_cpu_devices", 8)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest

from bwa_mem_scale_tpu.index.bntseq import BntSeq, Annotation, decode_bases
from bwa_mem_scale_tpu.index.build import build_index
from bwa_mem_scale_tpu.utils.compile_cache import enable_compile_cache

# The suite's wall time is dominated by compiling the same programs
# every run; the persistent cache keeps them (utils/compile_cache.py).
enable_compile_cache()


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (tests marked `gpu`
    run on the card; decided here, never at import or collection)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX backend is "
                    f"{jax.default_backend()})")


def make_genome(n: int, seed: int = 0, n_contigs: int = 1) -> BntSeq:
    rng = np.random.RandomState(seed)
    seq = rng.randint(0, 4, size=n).astype(np.uint8)
    anns = []
    per = n // n_contigs
    off = 0
    for i in range(n_contigs):
        ln = per if i < n_contigs - 1 else n - off
        anns.append(Annotation(name=f"ctg{i}", anno="(null)", offset=off,
                               length=ln, n_ambs=0))
        off += ln
    return BntSeq(l_pac=n, anns=anns, ambs=[], seq=seq)


def sample_reads(bns: BntSeq, n_reads: int, read_len: int, seed: int = 1,
                 err_rate: float = 0.0, indel_rate: float = 0.0):
    """Simulate reads with known true positions. Returns list of
    (codes, true_pos, is_rev)."""
    rng = np.random.RandomState(seed)
    comp = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
    out = []
    for _ in range(n_reads):
        pos = rng.randint(0, bns.l_pac - read_len)
        frag = bns.seq[pos: pos + read_len].copy()
        is_rev = bool(rng.randint(2))
        if is_rev:
            frag = comp[frag[::-1]]
        if err_rate > 0:
            err = rng.rand(read_len) < err_rate
            frag[err] = (frag[err] + rng.randint(1, 4, size=err.sum())) % 4
        out.append((frag.astype(np.uint8), pos, is_rev))
    return out


@pytest.fixture(scope="session")
def small_genome():
    return make_genome(20000, seed=42)


@pytest.fixture(scope="session")
def small_index(small_genome):
    return build_index(small_genome)
