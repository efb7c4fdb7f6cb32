"""FMA — FM-index Accelerator (the reference's "smem-table" feature).

The reference precomputes two k-mer lookup tables that skip the first k
steps of FM-index walking: `all_smem_t` (11-mer -> full forward
extension ladder of k/l/s, consumed by the SMEM passes,
src/FMI_search.h:101-117, build src/FMI_search.cpp:78-153) and
`last_smem_t` (13-mer -> final interval, consumed by the 3rd-pass seed
strategy, src/FMI_search.h:119-133).

Device formulation: ONE ladder table
    ladder_{k,l,s}[4^K, K]   (k, l, s) after extending the j-th base
                             of each K-mer, j = 1..K
built on-device by running the very same forward-extension kernel the
search uses (ops/occ.forward_ext), so fast-forwarding the first K steps
of `extend_all_positions` from the table is bit-identical to running
them. One [B, L]-lane gather of the s-ladder picks the per-lane resume
depth j*; two scalar gathers fetch (k, l) at j*. This accelerates all
three SMEM passes (the reference needs two distinct tables because its
per-position walk is sequential; our position-parallel sweep only needs
the ladder).

Sizing: K=11 (the reference's ALL_SMEM_MAX_BP) gives 3 * 4^11 * 11
entries = 0.55 GB at int32 positions / 1.1 GB at int64 — same order as
the reference's 0.5 GB + 1 GB pair.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .occ import DeviceFMIndex, forward_ext

DEFAULT_FMA_K = 11  # reference ALL_SMEM_MAX_BP (src/FMI_search.h:106)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceFmaTable:
    """K-mer extension-ladder table resident on device."""

    ladder_k: jax.Array   # [4^K, K] pos_dtype
    ladder_l: jax.Array   # [4^K, K] pos_dtype
    ladder_s: jax.Array   # [4^K, K] pos_dtype
    K: int

    def tree_flatten(self):
        return (self.ladder_k, self.ladder_l, self.ladder_s), (self.K,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def build_fma_table(fmi: DeviceFMIndex, K: int = DEFAULT_FMA_K,
                    chunk: int = 1 << 18) -> "FmaTable":
    """Enumerate all 4^K K-mers and record their extension ladders.

    Mirrors build_all_smem_table (src/FMI_search.cpp:78-153) but runs
    the ladders batched on device with the search's own kernel.
    """
    N = 4 ** K
    shifts = jnp.asarray(2 * (K - 1 - np.arange(K)), dtype=jnp.int32)

    @jax.jit
    def chunk_fn(ids):
        b = ((ids[:, None] >> shifts[None, :]) & 3).astype(jnp.int32)
        a0 = b[:, 0]
        k = fmi.count[a0]
        l = fmi.count[3 - a0]
        s = fmi.count[a0 + 1] - fmi.count[a0]
        ks, ls, ss = [k], [l], [s]
        for j in range(1, K):
            k, l, s = forward_ext(fmi, k, l, s, b[:, j])
            ks.append(k)
            ls.append(l)
            ss.append(s)
        return (jnp.stack(ks, axis=1), jnp.stack(ls, axis=1),
                jnp.stack(ss, axis=1))

    out_k = np.empty((N, K), dtype=np.int64)
    out_l = np.empty((N, K), dtype=np.int64)
    out_s = np.empty((N, K), dtype=np.int64)
    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        ids = jnp.arange(lo, hi, dtype=jnp.int32)
        ck, cl, cs = chunk_fn(ids)
        out_k[lo:hi] = np.asarray(ck, dtype=np.int64)
        out_l[lo:hi] = np.asarray(cl, dtype=np.int64)
        out_s[lo:hi] = np.asarray(cs, dtype=np.int64)
    return FmaTable(K=K, ladder_k=out_k, ladder_l=out_l, ladder_s=out_s)


@dataclasses.dataclass
class FmaTable:
    """Host-side FMA artifact (the reference's .all_smem.<K> file)."""

    K: int
    ladder_k: np.ndarray
    ladder_l: np.ndarray
    ladder_s: np.ndarray

    def to_device(self, pos_dtype) -> DeviceFmaTable:
        return DeviceFmaTable(
            ladder_k=jnp.asarray(self.ladder_k, dtype=pos_dtype),
            ladder_l=jnp.asarray(self.ladder_l, dtype=pos_dtype),
            ladder_s=jnp.asarray(self.ladder_s, dtype=pos_dtype),
            K=self.K)


def save_fma(fma: FmaTable, prefix: str) -> str:
    path = f"{prefix}.fma{fma.K}.npz"
    np.savez(path, K=np.int64(fma.K), ladder_k=fma.ladder_k,
             ladder_l=fma.ladder_l, ladder_s=fma.ladder_s)
    return path


def load_fma(path: str) -> FmaTable:
    from ..utils.npzmap import load_npz_mmap
    z = load_npz_mmap(path)
    return FmaTable(K=int(z["K"]), ladder_k=z["ladder_k"],
                    ladder_l=z["ladder_l"], ladder_s=z["ladder_s"])


def fast_forward(fmi: DeviceFMIndex, fma: DeviceFmaTable, codes, lens,
                 mi, check_initial: bool, K_eff: int, n_pos: int = 0):
    """Resolve the first K_eff extension steps of every (read, pos) lane
    from the ladder table.

    Returns (E, k, l, s, active, died_s) exactly as
    `extend_all_positions` would have them after K_eff lockstep steps
    (died_s: lane retired inside the window on an interval-size
    failure — for min_intv == 1 that means s hit 0):
      j* = number of steps the lane survives within the window
           (pass 1/2: s_j >= mi for every prefix; pass 3: every in-range
           non-N step is kept regardless of s — callers guarantee
           K_eff < stop_min_len so no pass-3 stop can fire here);
      E = p + j*, (k, l, s) = ladder[j*];
      active = lane still extending after the window.
    """
    B, L = codes.shape
    P = n_pos or L
    K = fma.K
    pos_dtype = fmi.pos_dtype
    pcol = jnp.arange(P, dtype=jnp.int32)[None, :]

    codes_pad = jnp.pad(codes, ((0, 0), (0, K)), constant_values=4)
    w = jnp.stack([codes_pad[:, i:i + P] for i in range(K)], axis=-1)
    in_read = (pcol[..., None] + jnp.arange(K, dtype=jnp.int32)
               ) < lens[:, None, None]
    base_ok = (w >= 0) & (w < 4) & in_read                    # [B, L, K]
    lead = jnp.cumprod(base_ok[..., :K_eff].astype(jnp.int32), axis=-1)
    cap = jnp.sum(lead, axis=-1, dtype=jnp.int32)             # [B, L]

    pow4 = jnp.asarray(4 ** (K - 1 - np.arange(K)), dtype=jnp.int32)
    km = jnp.sum(jnp.clip(w, 0, 3) * pow4, axis=-1,
                 dtype=jnp.int32)                             # [B, L]

    s_lad = fma.ladder_s[km]                                  # [B, L, K]
    if check_initial:
        ok = (s_lad[..., :K_eff] >= mi[..., None]).astype(jnp.int32)
        n_ok = jnp.sum(jnp.cumprod(ok, axis=-1), axis=-1,
                       dtype=jnp.int32)
        jstar = jnp.minimum(n_ok, cap)
    else:
        jstar = cap

    jm1 = jnp.maximum(jstar - 1, 0)
    flat = (km * K + jm1).reshape(-1)
    k = fma.ladder_k.reshape(-1)[flat].reshape(B, P)
    l = fma.ladder_l.reshape(-1)[flat].reshape(B, P)
    s = jnp.take_along_axis(s_lad, jm1[..., None], axis=-1)[..., 0]

    has = jstar >= 1
    zero = jnp.zeros((), dtype=pos_dtype)
    k = jnp.where(has, k, zero)
    l = jnp.where(has, l, zero)
    s = jnp.where(has, s, zero)
    E = pcol + jstar
    active = (jstar == K_eff) & ((pcol + K_eff) < lens[:, None])
    died_s = jstar < cap
    return E, k, l, s, active, died_s
