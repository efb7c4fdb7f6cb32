"""Pallas BSW kernel (ops/bsw_pallas.py) vs the jnp kernel and the
scalar oracle, bit for bit.

On the CPU the kernel runs in interpret mode, which covers its
semantics and the wrapper (padding, length sort, un-permute, block
size); the compiled Triton kernel runs in the `gpu` test on the card
and in chip_smoke.py phase b. Spec for all: the reference's
scalarBandedSWA (src/bandedSWA.cpp:116-238) via ref/bsw.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bwa_mem_scale_tpu.config import MemOptions
from bwa_mem_scale_tpu.ops.bsw import banded_swa_batch
from bwa_mem_scale_tpu.ops.bsw_pallas import banded_swa_batch_pallas
from bwa_mem_scale_tpu.pipeline.align import select_bsw
from bwa_mem_scale_tpu.ref.bsw import scalar_banded_swa

OPT = MemOptions()
FIELDS = ("score", "qle", "tle", "gtle", "gscore", "max_off")


def _pairs(P, QL, TL, w, seed):
    """Extension pairs like one batch's: query flanks, targets that
    follow them with substitutions, N bases and short indels, dead
    lanes, h0 a seed score."""
    r = np.random.default_rng(seed)
    q_lens = r.integers(1, QL + 1, P)
    t_lens = np.minimum(q_lens + r.integers(0, w + 1, P), TL)
    dead = r.random(P) < 0.15
    q_lens[dead] = 0
    t_lens[dead] = 0
    qs = r.integers(0, 4, (P, QL))
    ts = r.integers(0, 4, (P, TL))
    sub = r.random((P, QL)) < 0.03
    ts[:, :QL] = np.where(sub, r.integers(0, 5, (P, QL)), qs)
    for k in np.flatnonzero(r.random(P) < 0.3):
        p = int(r.integers(1, QL - 1))
        ts[k, p:] = np.roll(ts[k, p:], int(r.integers(-3, 4)))
    h0 = r.integers(1, QL + 1, P)
    return tuple(np.asarray(x, np.int32)
                 for x in (qs, q_lens, ts, t_lens, h0))


def _pen(w):
    return (w, OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins, OPT.zdrop,
            OPT.mat)


def _assert_equal(got, want, tag=""):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      f"{tag} {f}")


@pytest.mark.parametrize("w", [OPT.w, 2 * OPT.w])
def test_kernel_bit_equal_at_read_width(w):
    """151 bp queries, targets up to L + 2w + 8, band w and 2w: equal
    to the jnp kernel on every pair and to the scalar oracle on a
    sample."""
    QL = 151
    TL = QL + 2 * OPT.w + 8
    host = _pairs(80, QL, TL, w, seed=w)
    args = tuple(jnp.asarray(x) for x in host)
    got = banded_swa_batch_pallas(*args, *_pen(w), interpret=True)
    _assert_equal(got, banded_swa_batch(*args, *_pen(w)), f"w={w}")
    qs, ql, ts, tl, h0 = host
    for k in range(0, 80, 4):
        if ql[k] == 0 or tl[k] == 0:
            continue
        s = scalar_banded_swa(qs[k, :ql[k]], ts[k, :tl[k]], w, int(h0[k]),
                              OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins,
                              OPT.zdrop, OPT.mat)
        assert tuple(int(np.asarray(getattr(got, f))[k])
                     for f in FIELDS) == tuple(getattr(s, f)
                                               for f in FIELDS), k


@pytest.mark.parametrize("P,block", [(1, 32), (31, 32), (33, 32),
                                     (64, 32), (40, 8)])
def test_wrapper_padding_sort_unpermute(P, block):
    """Pair counts that are not a multiple of the block pad with dead
    lanes; the length sort and its inverse leave every pair's result
    in its own slot."""
    host = _pairs(P, 40, 72, 16, seed=P)
    args = tuple(jnp.asarray(x) for x in host)
    got = banded_swa_batch_pallas(*args, *_pen(16), block=block,
                                  interpret=True)
    assert got.score.shape == (P,)
    _assert_equal(got, banded_swa_batch(*args, *_pen(16)),
                  f"P={P} block={block}")


def test_block_size_does_not_change_results():
    host = _pairs(48, 40, 72, 16, seed=5)
    args = tuple(jnp.asarray(x) for x in host)
    res = [banded_swa_batch_pallas(*args, *_pen(16), block=b,
                                   interpret=True) for b in (8, 16, 64)]
    for r in res[1:]:
        _assert_equal(r, res[0])


def test_engine_choice_by_platform():
    assert select_bsw("cpu") is banded_swa_batch
    assert select_bsw("gpu") is banded_swa_batch_pallas
    assert select_bsw(jax.default_backend()) is banded_swa_batch


def test_gpu_kernel_never_falls_back():
    """The GPU engine is the compiled Triton kernel: where it cannot
    compile (here, no GPU) the call raises instead of silently running
    the jnp kernel or interpret mode."""
    if jax.default_backend() == "gpu":
        pytest.skip("the kernel compiles here")
    args = tuple(jnp.asarray(x) for x in _pairs(8, 16, 24, 8, seed=1))
    kern = select_bsw("gpu")
    with pytest.raises(Exception):
        jax.block_until_ready(jax.jit(
            lambda *a: kern(*a, *_pen(8)))(*args))


@pytest.mark.gpu
def test_compiled_kernel_on_gpu(gpu):
    """The compiled kernel on the card, one batch's pair count."""
    QL = 151
    TL = QL + 2 * OPT.w + 8
    for w in (OPT.w, 2 * OPT.w):
        args = tuple(jnp.asarray(x)
                     for x in _pairs(4 * 8192, QL, TL, w, seed=w))
        got = jax.jit(lambda *a: banded_swa_batch_pallas(*a, *_pen(w)))(
            *args)
        _assert_equal(got, jax.jit(
            lambda *a: banded_swa_batch(*a, *_pen(w)))(*args), f"w={w}")
