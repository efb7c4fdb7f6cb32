"""Windowed sequence staging without per-element gathers.

The extension pipeline stages contiguous sequence windows — query
prefixes/suffixes and reference target spans (the SoA SeqPair buffers
of mem_chain2aln_across_reads_V2, src/bwamem.cpp:2976-3188). A naive
`arr[start[p] + iota]` is a per-element gather over 16 k pairs x
300 B windows per batch.

This module fetches each lane's window as a handful of consecutive
128-byte ROW gathers and realigns the sub-row offset with log2(W)
static conditional rolls (elementwise selects). Net: O(W/128) gather rows per lane instead of
O(W) gather elements.

Contract shared with the per-element path it replaces: elements of a
window that fall outside the source array are JUNK (deterministic,
in-domain values — the old path clipped indices, this one clamps row
indices), and every consumer masks them; elements inside the source
are exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _ceil_log2(n: int) -> int:
    b = 0
    while (1 << b) < n:
        b += 1
    return b


def roll_rows_left(x: jax.Array, s: jax.Array,
                   max_bits: int = None) -> jax.Array:
    """Per-lane left-roll: out[p, j] = x[p, (j + s[p]) % W].

    x [P, W], s [P] int in [0, W). Decomposes s into bits; each bit is
    one static slice+concat roll selected per lane — no gathers.
    max_bits: bound on bit_length(s) when the caller knows s is small
    (skips the dead high-bit passes XLA can't eliminate itself).
    """
    W = x.shape[-1]
    s = s.astype(jnp.int32)
    bits = _ceil_log2(W) if max_bits is None else min(
        max_bits, _ceil_log2(W))
    for b in range(bits - 1, -1, -1):
        k = 1 << b
        rolled = jnp.concatenate([x[..., k:], x[..., :k]], axis=-1)
        x = jnp.where((s & k)[..., None] != 0, rolled, x)
    return x


def take_windows(mat: jax.Array, start: jax.Array, W: int,
                 reverse: bool = False) -> jax.Array:
    """out[p, j] = mat[p, start[p] + j] (or start[p] - j if reverse).

    mat [P, L]; returns [P, W] of mat.dtype. Out-of-range elements are
    junk (in-domain values from the same row); in-range elements exact.
    """
    P, L = mat.shape
    if reverse:
        # out[j] = mat[start - j] = flip(mat)[(L-1-start) + j]
        return take_windows(mat[:, ::-1], (L - 1) - start, W)
    # pad the row so every roll amount in [0, L] is representable and
    # the window slice never wraps valid data into the junk region
    Wp = max(L + 1, W)
    if Wp > L:
        mat = jnp.pad(mat, ((0, 0), (0, Wp - L)))
    s = jnp.clip(start.astype(jnp.int32), 0, Wp - 1)
    out = roll_rows_left(mat, s)
    if W < Wp:
        out = out[:, :W]
    elif W > Wp:
        out = jnp.pad(out, ((0, 0), (0, W - Wp)))
    return out


def ref_windows(ref: jax.Array, start: jax.Array, W: int, l_pac: int,
                reverse: bool = False) -> jax.Array:
    """Reference window per lane, in fw+rc coordinate space [0, 2*l_pac):
    out[p, j] = ref_byte(ref, start[p] + j) (or start[p] - j if
    reverse), int32 [P, W].

    Requires the whole window on one strand for forward-only ref
    layouts (the hg38 HBM residency plan) — true for every caller:
    extension spans are clamped to one strand (rmax bridging,
    pipeline/align.py) and EMF verify windows are forward by
    construction. Junk-window lanes (masked by callers) may straddle;
    they get junk, which is the contract anyway.

    Falls back to the per-element path for refs whose flat length is
    not 128-aligned (tiny test genomes; construction pads real ones).
    """
    from .occ import ref_byte, ref_flat_len
    flat = ref_flat_len(ref)
    l2 = 2 * l_pac
    NR = (W + 127) // 128 + 1
    if flat % 128 or flat < NR * 128:
        iota = jnp.arange(W, dtype=jnp.int32)
        off = (-iota if reverse else iota)[None, :]
        return ref_byte(ref, start[:, None] + off, l_pac)
    fw_only = flat < l2
    ref128 = ref.reshape(-1, 128)
    R = ref128.shape[0]

    # ascending window base in fw+rc space
    a0 = start - (W - 1) if reverse else start
    if fw_only:
        # storage holds the forward strand; an rc-strand window reads
        # storage idx = l2-1-pos, which ascends as pos descends
        rev_lane = jnp.clip(start, 0, l2 - 1) >= l_pac
        s0 = jnp.where(rev_lane, (l2 - W) - a0, a0)
    else:
        rev_lane = None
        s0 = a0

    r0 = (s0 >> 7).astype(jnp.int32)               # floor(s0 / 128)
    sub = (s0 & 127).astype(jnp.int32)             # s0 mod 128 (>= 0)
    rows = jnp.clip(r0[:, None] + jnp.arange(NR, dtype=jnp.int32)
                    [None, :], 0, R - 1)
    blk = ref128[rows].reshape(start.shape[0], NR * 128)
    out = roll_rows_left(blk, sub, max_bits=7)[:, :W].astype(jnp.int32)

    if fw_only:
        flip = rev_lane ^ reverse
        out = jnp.where(flip[:, None], out[:, ::-1], out)
        out = jnp.where(rev_lane[:, None], 3 - out, out)
    elif reverse:
        out = out[:, ::-1]
    return out
