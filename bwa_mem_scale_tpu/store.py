"""In-memory index store + MEMSCALE budget policy.

The reference keeps every index piece in named POSIX shared-memory
segments so that (a) repeated runs skip deserialization and (b) many
mapper processes share one RAM copy, with a -g <GB> budget choosing
which optional accelerators get loaded (src/bwa_shm.{h,cpp}; budget
order src/bwa_shm.cpp:1585-1770; state machine src/bwa_shm.h:108-149).

Equivalent here: artifacts are staged once into a tmpfs
directory (default /dev/shm) as raw little-endian .npy pieces plus a
manifest carrying a state machine (LOADING -> AVAIL) and source
identity (path, mtime, size). `mem` attaches with zero-copy
numpy mmaps — page cache shared across processes, device upload
streams straight from the mapping. The budget policy mirrors the
reference's cost/benefit order: base FM index (mandatory) -> FMA
ladder -> EMF table -> ERT trie (which replaces the FMA when it
fits, as the reference's ERT replaces the smem tables).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Dict, List, Optional

import numpy as np

DEFAULT_STORE_DIR = "/dev/shm/bwa-mem-scale-tpu"

STATE_LOADING = "LOADING"
STATE_AVAIL = "AVAIL"

# budget order: (piece kind, glob pattern); the base index is
# mandatory and always first
PIECE_KINDS = ("index", "fma", "emf", "ert")


def _identity(path: str) -> Dict:
    st = os.stat(path)
    return {"path": os.path.abspath(path), "mtime": st.st_mtime,
            "size": st.st_size}


def _store_name(prefix: str) -> str:
    import hashlib
    return hashlib.sha1(
        os.path.abspath(prefix).encode()).hexdigest()[:16]


def discover_artifacts(prefix: str) -> Dict[str, str]:
    """Locate the artifact files next to an index prefix."""
    import glob
    out = {}
    p = prefix + ".tpuidx.npz"
    if os.path.exists(p):
        out["index"] = p
    for kind, pat in (("fma", ".fma*.npz"), ("emf", ".emf*.npz"),
                      ("ert", ".ert*.npz")):
        hits = sorted(glob.glob(prefix + pat), reverse=True)
        if hits:
            out[kind] = hits[0]
    return out


def plan_budget(prefix: str, budget_gb: Optional[float]
                ) -> List[str]:
    """MEMSCALE piece selection (reference order,
    src/bwa_shm.cpp:1670-1770). Returns kinds to stage."""
    arts = discover_artifacts(prefix)
    if "index" not in arts:
        raise FileNotFoundError(f"{prefix}.tpuidx.npz")
    budget = (float("inf") if budget_gb is None
              else budget_gb * (1 << 30))
    chosen = ["index"]
    used = os.stat(arts["index"]).st_size
    if used > budget:
        raise ValueError(
            f"budget {budget_gb} GB below the mandatory index size "
            f"({used / (1 << 30):.2f} GB)")
    for kind in ("fma", "emf"):
        if kind in arts:
            sz = os.stat(arts[kind]).st_size
            if used + sz <= budget:
                chosen.append(kind)
                used += sz
    if "ert" in arts:
        sz = os.stat(arts["ert"]).st_size
        # ERT replaces the FMA ladder when it fits (the walk never
        # touches the occ tables)
        base = used - (os.stat(arts["fma"]).st_size
                       if "fma" in chosen else 0)
        if base + sz <= budget:
            if "fma" in chosen:
                chosen.remove("fma")
            chosen.append("ert")
    return chosen


def stage(prefix: str, budget_gb: Optional[float] = None,
          store_dir: str = DEFAULT_STORE_DIR,
          log=print) -> str:
    """load-shm: unpack selected artifacts into raw mmap-able pieces."""
    kinds = plan_budget(prefix, budget_gb)
    arts = discover_artifacts(prefix)
    root = os.path.join(store_dir, _store_name(prefix))
    if os.path.exists(root):
        shutil.rmtree(root)
    os.makedirs(root)
    manifest = {"version": 1, "state": STATE_LOADING, "pieces": {}}
    mpath = os.path.join(root, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    for kind in kinds:
        src = arts[kind]
        sub = os.path.join(root, kind)
        os.makedirs(sub)
        entry = {"source": _identity(src), "arrays": {}}
        with np.load(src) as z:
            for name in z.files:
                arr = z[name]
                np.save(os.path.join(sub, name + ".npy"), arr)
                entry["arrays"][name] = name + ".npy"
        manifest["pieces"][kind] = entry
        log(f"* staged {kind}: {src} "
            f"({os.stat(src).st_size / (1 << 20):.1f} MB)")
    manifest["state"] = STATE_AVAIL
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(mpath + ".tmp", mpath)  # atomic AVAIL flip
    return root


def remove(prefix: str, store_dir: str = DEFAULT_STORE_DIR) -> bool:
    root = os.path.join(store_dir, _store_name(prefix))
    if os.path.exists(root):
        shutil.rmtree(root)
        return True
    return False


@dataclasses.dataclass
class AttachedStore:
    root: str
    pieces: Dict[str, Dict[str, np.ndarray]]   # kind -> name -> mmap

    def has(self, kind: str) -> bool:
        return kind in self.pieces


def attach(prefix: str, store_dir: str = DEFAULT_STORE_DIR
           ) -> Optional[AttachedStore]:
    """Zero-copy attach; None if absent, loading, or stale."""
    root = os.path.join(store_dir, _store_name(prefix))
    mpath = os.path.join(root, "manifest.json")
    if not os.path.exists(mpath):
        return None
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest.get("state") != STATE_AVAIL:
        return None
    arts = discover_artifacts(prefix)
    pieces = {}
    for kind, entry in manifest["pieces"].items():
        src = entry["source"]
        cur = arts.get(kind)
        if cur is None or _identity(cur) != src:
            return None   # stale store (reference: identity check)
        arrs = {}
        for name, fn in entry["arrays"].items():
            arrs[name] = np.load(os.path.join(root, kind, fn),
                                 mmap_mode="r")
        pieces[kind] = arrs
    return AttachedStore(root=root, pieces=pieces)


# -- rebuilders: mmap piece dict -> artifact objects --------------------

def index_from_store(arrs: Dict[str, np.ndarray]):
    from .index.artifacts import FMIndex
    from .index.bntseq import BntSeq, Annotation, Hole
    meta = json.loads(bytes(np.asarray(arrs["meta"])).decode())
    ref_string = arrs["ref_string"]
    bns = BntSeq(l_pac=meta["l_pac"],
                 anns=[Annotation(**a) for a in meta["anns"]],
                 ambs=[Hole(**h) for h in meta["ambs"]],
                 seq=ref_string[: meta["l_pac"]],
                 seed=meta["seed"])
    return FMIndex(seq_len=meta["seq_len"], count=arrs["count"],
                   cp_count=arrs["cp_count"], cp_mask=arrs["cp_mask"],
                   sa_samples=arrs["sa_samples"],
                   sa_compx=meta["sa_compx"],
                   sentinel_index=meta["sentinel_index"], bns=bns,
                   ref_string=ref_string)


def fma_from_store(arrs):
    from .ops.fma import FmaTable
    return FmaTable(K=int(arrs["K"]), ladder_k=arrs["ladder_k"],
                    ladder_l=arrs["ladder_l"], ladder_s=arrs["ladder_s"])


def emf_from_store(arrs):
    from .index.perfect import PerfectTable
    return PerfectTable(
        seed_len=int(arrs["seed_len"]), l_pac=int(arrs["l_pac"]),
        max_probe=int(arrs["max_probe"]), loc=arrs["loc"],
        fp=arrs["fp"], fwless=arrs["fwless"], cnt=arrs["cnt"],
        mlidx=arrs["mlidx"], ml_off=arrs["ml_off"],
        ml_nfw=arrs["ml_nfw"], ml_locs=arrs["ml_locs"])


def ert_from_store(arrs):
    from .index.ert import ErtIndex
    return ErtIndex(K=int(arrs["K"]), max_depth=int(arrs["max_depth"]),
                    kmer_lo=arrs["kmer_lo"], kmer_cnt=arrs["kmer_cnt"],
                    kmer_ptr=arrs["kmer_ptr"], node_lo=arrs["node_lo"],
                    node_cnt=arrs["node_cnt"],
                    child_ptr=arrs["child_ptr"],
                    root_children=arrs["root_children"])
