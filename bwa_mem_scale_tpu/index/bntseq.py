"""Reference-genome metadata and 2-bit packed sequence ("bntseq" layer).

Re-design of the reference's bntseq component
(reference: src/bntseq.{h,cpp}): FASTA -> per-contig annotations
(name/offset/length), ambiguity ("hole") records, and the numeric base
array. We keep the byte-per-base int8 array as the primary in-memory form
(it is what gets uploaded to device HBM; equivalent of the reference's
".0123" ref_string) and derive the 2-bit pac packing only for artifact
compactness.

Coordinate conventions (identical to the reference):
- Bases: A=0 C=1 G=2 T=3, ambiguous=4.
- l_pac = total forward-strand length; positions in [0, 2*l_pac) address
  the forward strand followed by the reverse complement
  (pos_rc = 2*l_pac - 1 - pos_fw, reference: src/bntseq.h:89-92).
- Ambiguous bases are replaced by lrand48()&3 with srand48(11), exactly
  as the reference does (src/bntseq.cpp:304,334-335), so indices built
  here are base-for-base identical to reference-built indices.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
from typing import Iterator, List, Tuple

import numpy as np

# nt4 encoding table for ASCII bases (reference: src/bntseq.cpp nst_nt4_table).
NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _c, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3),
               ("a", 0), ("c", 1), ("g", 2), ("t", 3)):
    NT4_TABLE[ord(_c)] = _v

BASE_CHARS = "ACGTN"
COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


def encode_bases(s: str | bytes) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode()
    return NT4_TABLE[np.frombuffer(s, dtype=np.uint8)]


def decode_bases(codes: np.ndarray) -> str:
    return "".join(BASE_CHARS[c] for c in codes)


class Lrand48:
    """glibc drand48 family LCG; bit-exact lrand48() (POSIX)."""

    MASK = (1 << 48) - 1
    A = 0x5DEECE66D
    C = 0xB

    def __init__(self, seed: int = 11):
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def lrand48(self) -> int:
        self.x = (self.A * self.x + self.C) & self.MASK
        return self.x >> 17

    def _affine_pow(self, n: int):
        """(a, c) with f^n(x) = a*x + c mod 2^48 (repeated squaring)."""
        ra, rc = 1, 0
        a, c = self.A, self.C
        while n:
            if n & 1:
                ra, rc = (a * ra) & self.MASK, (a * rc + c) & self.MASK
            a, c = (a * a) & self.MASK, (a * c + c) & self.MASK
            n >>= 1
        return ra, rc

    def fill_and3(self, n: int) -> np.ndarray:
        """n successive lrand48()&3 draws.

        Large fills run the LCG lane-parallel in numpy (L lanes, each
        stepping by the L-fold affine composition f^L) — at hg38 scale
        the scalar Python loop over every hole base would cost tens of
        minutes. Bit-exact with the scalar path (tested)."""
        L = 4096
        if n < 2 * L:
            out = np.empty(n, dtype=np.uint8)
            x = self.x
            for i in range(n):
                x = (self.A * x + self.C) & self.MASK
                out[i] = (x >> 17) & 3
            self.x = x
            return out
        # seed lanes with f^1(x)..f^L(x) serially
        lane = np.empty(L, dtype=np.uint64)
        x = self.x
        for j in range(L):
            x = (self.A * x + self.C) & self.MASK
            lane[j] = x
        nsteps = -(-n // L)
        out = np.empty(nsteps * L, dtype=np.uint8)
        out[:L] = ((lane >> np.uint64(17)) & np.uint64(3)).astype(np.uint8)
        aL, cL = self._affine_pow(L)
        # 24-bit limb multiply keeps every partial product below 2^50
        # (uint64-safe): (ah*2^24+al)*x mod 2^48.
        M24 = np.uint64((1 << 24) - 1)
        ah = np.uint64(aL >> 24)
        al = np.uint64(aL & ((1 << 24) - 1))
        cv = np.uint64(cL)
        M48 = np.uint64(self.MASK)
        s24 = np.uint64(24)
        for k in range(1, nsteps):
            xl = lane & M24
            xh = lane >> s24
            cross = ((ah * xl + al * xh) & M24) << s24
            lane = (al * xl + cross + cv) & M48
            out[k * L:(k + 1) * L] = ((lane >> np.uint64(17))
                                      & np.uint64(3)).astype(np.uint8)
        an, cn = self._affine_pow(n)
        self.x = (an * self.x + cn) & self.MASK
        return out[:n]


@dataclasses.dataclass
class Annotation:
    name: str
    anno: str
    offset: int
    length: int
    n_ambs: int
    is_alt: bool = False


@dataclasses.dataclass
class Hole:
    offset: int
    length: int
    amb: str


@dataclasses.dataclass
class BntSeq:
    """Genome metadata + numeric forward-strand sequence."""

    l_pac: int
    anns: List[Annotation]
    ambs: List[Hole]
    seq: np.ndarray          # int8 [l_pac], values 0..3 (ambs already filled)
    seed: int = 11

    @property
    def n_seqs(self) -> int:
        return len(self.anns)

    @property
    def offsets(self) -> np.ndarray:
        cached = getattr(self, "_offsets_arr", None)
        if cached is None or len(cached) != len(self.anns):
            cached = np.array([a.offset for a in self.anns],
                              dtype=np.int64)
            object.__setattr__(self, "_offsets_arr", cached)
        return cached

    @property
    def lens(self) -> np.ndarray:
        return np.array([a.length for a in self.anns], dtype=np.int64)

    @property
    def is_alt(self) -> np.ndarray:
        return np.array([a.is_alt for a in self.anns], dtype=bool)

    def full_text(self) -> np.ndarray:
        """Forward + reverse-complement text of length 2*l_pac
        (the FM-index text, reference: FMI_search.cpp pac2nt)."""
        fw = self.seq
        rc = COMP[fw[::-1]]
        return np.concatenate([fw, rc]).astype(np.uint8)

    def depos(self, pos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Map [0,2*l_pac) position to forward coordinate + is_rev
        (reference: src/bntseq.h:89-92 bns_depos)."""
        pos = np.asarray(pos, dtype=np.int64)
        is_rev = pos >= self.l_pac
        pos_f = np.where(is_rev, (self.l_pac << 1) - 1 - pos, pos)
        return pos_f, is_rev

    def pos2rid(self, pos_f: np.ndarray) -> np.ndarray:
        """Forward coordinate -> contig id, -1 if >= l_pac
        (reference: src/bntseq.cpp bns_pos2rid)."""
        pos_f = np.asarray(pos_f, dtype=np.int64)
        rid = np.searchsorted(self.offsets, pos_f, side="right") - 1
        return np.where(pos_f >= self.l_pac, -1, rid).astype(np.int32)

    # scalar fast paths: the record-emit loop calls these once or
    # twice per SAM record; the array versions cost ~40 us/call in
    # numpy scalar overhead, these ~1 us
    def depos1(self, pos: int) -> Tuple[int, bool]:
        pos = int(pos)
        if pos >= self.l_pac:
            return (self.l_pac << 1) - 1 - pos, True
        return pos, False

    def pos2rid1(self, pos_f: int) -> int:
        pos_f = int(pos_f)
        if pos_f >= self.l_pac:
            return -1
        lst = getattr(self, "_offsets_list", None)
        if lst is None or len(lst) != len(self.anns):
            lst = [a.offset for a in self.anns]
            object.__setattr__(self, "_offsets_list", lst)
        import bisect
        return bisect.bisect_right(lst, pos_f) - 1

    def intv2rid(self, rb: np.ndarray, re: np.ndarray) -> np.ndarray:
        """Interval -> contig id; -2 if bridging fw/rc, -1 if spanning
        contigs (reference: src/bntseq.cpp bns_intv2rid)."""
        rb = np.asarray(rb, dtype=np.int64)
        re = np.asarray(re, dtype=np.int64)
        rid_b = self.pos2rid(self.depos(rb)[0])
        re1 = np.where(rb < re, re - 1, rb)
        rid_e = self.pos2rid(self.depos(re1)[0])
        rid = np.where(rid_b == rid_e, rid_b, -1)
        bridging = (rb < self.l_pac) & (re > self.l_pac)
        return np.where(bridging, -2, rid).astype(np.int32)

    def get_seq(self, beg: int, end: int, ref_string: np.ndarray) -> np.ndarray:
        """Fetch [beg,end) from the fw+rc byte reference; empty if the
        interval bridges the fw/rc boundary (reference bns_get_seq_v2)."""
        if beg > end:
            beg, end = end, beg
        end = min(end, self.l_pac << 1)
        beg = max(beg, 0)
        if beg >= self.l_pac or end <= self.l_pac:
            return ref_string[beg:end]
        return ref_string[0:0]

    def fetch_seq(self, beg: int, mid: int, end: int,
                  ref_string: np.ndarray) -> Tuple[np.ndarray, int, int, int]:
        """Clamp [beg,end) to the contig containing mid and fetch
        (reference bns_fetch_seq_v2). Returns (seq, beg, end, rid)."""
        if end < beg:
            beg, end = end, beg
        assert beg <= mid < end
        pos_f, is_rev = self.depos(np.int64(mid))
        rid = int(self.pos2rid(pos_f))
        far_beg = self.anns[rid].offset
        far_end = far_beg + self.anns[rid].length
        if is_rev:
            far_beg, far_end = ((self.l_pac << 1) - far_end,
                                (self.l_pac << 1) - far_beg)
        beg = max(beg, far_beg)
        end = min(end, far_end)
        seq = self.get_seq(beg, end, ref_string)
        assert len(seq) == end - beg
        return seq, beg, end, rid


def _iter_fasta(handle) -> Iterator[Tuple[str, str, str]]:
    name, comment, parts = None, "", []
    for raw in handle:
        line = raw.rstrip("\n").rstrip("\r")
        if line.startswith(">"):
            if name is not None:
                yield name, comment, "".join(parts)
            hdr = line[1:].split(None, 1)
            name = hdr[0] if hdr else ""
            comment = hdr[1] if len(hdr) > 1 else ""
            parts = []
        elif line:
            parts.append(line)
    if name is not None:
        yield name, comment, "".join(parts)


def parse_fasta(path_or_str, is_text: bool = False) -> BntSeq:
    """FASTA (optionally gzipped) -> BntSeq, with reference-identical
    ambiguity records and lrand48 hole fill."""
    if is_text:
        handle = io.StringIO(path_or_str)
    else:
        path = str(path_or_str)
        if path.endswith(".gz"):
            handle = gzip.open(path, "rt")
        else:
            handle = open(path, "rt")

    rng = Lrand48(seed=11)
    anns: List[Annotation] = []
    ambs: List[Hole] = []
    chunks: List[np.ndarray] = []
    offset = 0
    with handle:
        for name, comment, seq_str in _iter_fasta(handle):
            raw = np.frombuffer(seq_str.encode(), dtype=np.uint8)
            codes = NT4_TABLE[raw].copy()
            n_amb_records = 0
            amb_pos = np.flatnonzero(codes >= 4)
            if amb_pos.size:
                # Group contiguous runs of the same ambiguity character
                # into hole records (reference: src/bntseq.cpp:284-301).
                # Vectorized run detection: a per-position Python loop
                # costs minutes over hg38-scale N blocks.
                ch = raw[amb_pos]
                brk = np.flatnonzero((np.diff(amb_pos) != 1)
                                     | (ch[1:] != ch[:-1]))
                starts = np.concatenate(([0], brk + 1))
                ends = np.concatenate((brk, [amb_pos.size - 1]))
                for s, e in zip(starts, ends):
                    ambs.append(Hole(
                        offset=offset + int(amb_pos[s]),
                        length=int(amb_pos[e] - amb_pos[s] + 1),
                        amb=chr(ch[s])))
                n_amb_records += len(starts)
                # lrand48 fill must be drawn in sequence order.
                codes[amb_pos] = rng.fill_and3(amb_pos.size)
            anns.append(Annotation(name=name, anno=comment or "(null)",
                                   offset=offset, length=len(codes),
                                   n_ambs=n_amb_records))
            chunks.append(codes)
            offset += len(codes)

    seq = (np.concatenate(chunks) if chunks
           else np.zeros(0, dtype=np.uint8)).astype(np.uint8)
    return BntSeq(l_pac=offset, anns=anns, ambs=ambs, seq=seq)


def pack_pac(seq: np.ndarray) -> np.ndarray:
    """2-bit pack (4 bases/byte, first base in the two MSBs —
    reference _set_pac layout)."""
    n = len(seq)
    padded = np.zeros((n + 3) // 4 * 4, dtype=np.uint8)
    padded[:n] = seq
    q = padded.reshape(-1, 4)
    return (q[:, 0] << 6 | q[:, 1] << 4 | q[:, 2] << 2 | q[:, 3]).astype(np.uint8)


def unpack_pac(pac: np.ndarray, n: int) -> np.ndarray:
    b = np.repeat(pac, 4)
    shifts = np.tile(np.array([6, 4, 2, 0], dtype=np.uint8), len(pac))
    return ((b >> shifts) & 3).astype(np.uint8)[:n]
