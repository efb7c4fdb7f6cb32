"""Multi-chip execution: read-axis data parallelism over a device mesh.

The reference scales by thread pools + process-shared index memory
(kt_for src/kthread.cpp:79, bwa_shm src/bwa_shm.cpp); the device
equivalent is a jax.sharding.Mesh with the read batch sharded over the
'dp' axis and the index replicated in every device's memory (SURVEY.md
section 5.8). shard_map keeps each chip's seeding while-loops local —
no per-iteration collectives; chips retire their shards independently.

Index sharding over a second axis (for indices larger than one chip's
HBM) is the planned extension; the entry points here take a mesh so
that mode can slot in.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..pipeline.align import seed_chain_extend, PipelineConfig
from ..config import MemOptions


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def sharded_align_fn(mesh: Mesh, opt: MemOptions, cfg: PipelineConfig,
                     L: int, axis: str = "dp", with_fma: bool = False,
                     with_ert: bool = False):
    """Build a jitted, read-sharded seed-chain-extend step.

    Returns f(fmi, dbns, codes [B, L], lens [B][, fma][, ert]) with B
    divisible by the mesh size; index state and accelerator tables
    replicated in every chip's HBM, read axis sharded. (Alignment has
    no weight/activation axes to shard — dp over reads is the whole
    parallelism story per chip; cross-host scaling shards the FASTQ
    stream, SURVEY.md section 5.8.)
    """
    def local_step(fmi, dbns, codes, lens, *extra):
        i = 0
        fma = ert = None
        if with_fma:
            fma, i = extra[i], i + 1
        if with_ert:
            ert = extra[i]
        out = seed_chain_extend(fmi, dbns, codes, lens, L=L, opt=opt,
                                cfg=cfg, fma=fma, ert=ert)
        # pair-space read indices are shard-local; globalize them
        # (both the plain field and column 1 of the packed matrix).
        shard = jax.lax.axis_index(axis)
        out["read"] = jnp.where(
            out["valid"], out["read"] + shard * codes.shape[0], -1)
        pk = out["packed"]
        gread = jnp.where(pk[:, 0] == 1,
                          pk[:, 1] + shard * codes.shape[0], -1)
        out["packed"] = pk.at[:, 1].set(gread)
        # scalars must grow a shard axis to concatenate over the mesh
        out = {k: (v[None] if v.ndim == 0 else v)
               for k, v in out.items()}
        return out

    in_specs = [P(), P(), P(axis, None), P(axis)]
    if with_fma:
        in_specs.append(P())
    if with_ert:
        in_specs.append(P())
    fn = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_emf_fn(mesh: Mesh, axis: str = "dp"):
    """Read-sharded EMF probe (ops/emf.emf_lookup): the perfect-match
    table and reference replicated per chip, reads split over the
    mesh. Every output of emf_lookup is per-read [B]-shaped, so
    out_specs is a plain shard axis."""
    from ..ops.emf import emf_lookup
    fn = jax.shard_map(
        emf_lookup, mesh=mesh,
        in_specs=(P(), P(), P(axis, None), P(axis)),
        out_specs=P(axis),
        check_vma=False)
    return jax.jit(fn)


def pad_to_multiple(codes: np.ndarray, lens: np.ndarray, mult: int):
    """Pad the read batch so it divides evenly over the mesh. Padding
    reads have length 0 and produce no valid regions."""
    B = codes.shape[0]
    rem = (-B) % mult
    if rem == 0:
        return codes, lens, B
    codes = np.concatenate(
        [codes, np.full((rem, codes.shape[1]), 4, dtype=codes.dtype)])
    lens = np.concatenate([lens, np.zeros(rem, dtype=lens.dtype)])
    return codes, lens, B
