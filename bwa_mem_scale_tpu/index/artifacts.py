"""Index artifact container and persistent format.

The artifact inventory mirrors the reference's persistent index files
(SURVEY.md section 5.4; reference: src/FMI_search.cpp:629-763 layout):
one versioned ``.tpuidx.npz`` bundle holding the FM-index (checkpointed
occ + SA samples + sentinel), the byte reference (fw+rc, the reference's
".0123" ref_string), and the contig metadata (".ann/.amb"). Optional
accelerator tables (FMA smem tables, EMF perfect-match table) are
separate files built/loaded on demand, like the reference's
``.all_smem.11 / .last_smem.13 / .perfect.<len>``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from .bntseq import BntSeq, Annotation, Hole

# Our checkpoint block is 32 bp (uint32 one-hot masks, popcounted in
# int32 lanes; the reference uses 64 bp, src/FMI_search.h:59-62).
CP_BLOCK_SIZE = 32
CP_SHIFT = 5
CP_MASK = 31

ARTIFACT_VERSION = 1


@dataclasses.dataclass
class FMIndex:
    """Loaded FM-index over the fw+rc genome text (host-side arrays)."""

    seq_len: int             # 2*l_pac + 1 (includes virtual sentinel row)
    count: np.ndarray        # int64 [5], C-array incl. sentinel rank 0
    cp_count: np.ndarray     # int64 [nblocks, 4]
    cp_mask: np.ndarray      # uint32 [nblocks, 4]
    sa_samples: np.ndarray   # int64 [ceil(seq_len / 2^sa_compx)]
    sa_compx: int
    sentinel_index: int
    bns: BntSeq
    ref_string: np.ndarray   # uint8 [2*l_pac] fw+rc byte reference
    source_prefix: str = None   # set by load_index (device-layout cache)

    @property
    def l_pac(self) -> int:
        return self.bns.l_pac

    @property
    def pos_fits_int32(self) -> bool:
        """True when all FM positions fit int32 (small-genome fast path)."""
        return self.seq_len < (1 << 31)


def save_index(idx: FMIndex, prefix: str) -> str:
    meta = {
        "version": ARTIFACT_VERSION,
        "seq_len": idx.seq_len,
        "sa_compx": idx.sa_compx,
        "sentinel_index": idx.sentinel_index,
        "l_pac": idx.bns.l_pac,
        "seed": idx.bns.seed,
        "anns": [dataclasses.asdict(a) for a in idx.bns.anns],
        "ambs": [dataclasses.asdict(h) for h in idx.bns.ambs],
    }
    path = prefix + ".tpuidx.npz"
    np.savez(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        count=idx.count,
        cp_count=idx.cp_count,
        cp_mask=idx.cp_mask,
        sa_samples=idx.sa_samples,
        ref_string=idx.ref_string,
    )
    return path


def load_index(prefix: str) -> FMIndex:
    path = prefix if prefix.endswith(".npz") else prefix + ".tpuidx.npz"
    # zero-copy open: members memory-map in place (utils/npzmap);
    # pages stream in as the first batches touch them
    from ..utils.npzmap import load_npz_mmap
    z = load_npz_mmap(path)
    meta = json.loads(bytes(z["meta"]).decode())
    if meta["version"] != ARTIFACT_VERSION:
        raise ValueError(f"index version {meta['version']} != "
                         f"{ARTIFACT_VERSION}")
    ref_string = z["ref_string"]
    bns = BntSeq(
        l_pac=meta["l_pac"],
        anns=[Annotation(**a) for a in meta["anns"]],
        ambs=[Hole(**h) for h in meta["ambs"]],
        seq=ref_string[: meta["l_pac"]],
        seed=meta["seed"],
    )
    return FMIndex(
        seq_len=meta["seq_len"],
        count=z["count"],
        cp_count=z["cp_count"],
        cp_mask=z["cp_mask"],
        sa_samples=z["sa_samples"],
        sa_compx=meta["sa_compx"],
        sentinel_index=meta["sentinel_index"],
        bns=bns,
        ref_string=ref_string,
        source_prefix=path[: -len(".tpuidx.npz")]
        if path.endswith(".tpuidx.npz") else None,
    )
