"""Simulate FASTQ reads from a FASTA (substitutions + indels, fw/rc).

  python tools/make_reads.py ref.fa out.fq -n 100000 -l 150 \
      [--err 0.01] [--indel 0.001] [--seed 7] [--pe out2.fq]

PE mode writes proper FR pairs (insert ~ N(400, 60), both mates
err/indel-mutated) to out.fq / --pe path.

Read names carry the simulated 1-based leftmost reference position:
`sim<i>_<pos>` (SE) and `sim<i>_<pos1>_<pos2>` (PE, mate 1 then mate 2).
"""

from __future__ import annotations

import argparse

import numpy as np

BASES = np.array(list("ACGT"))
COMP = str.maketrans("ACGTN", "TGCAN")


def load_fasta(path):
    names, seqs, cur = [], [], []
    for ln in open(path):
        if ln.startswith(">"):
            if cur:
                seqs.append("".join(cur))
                cur = []
            names.append(ln[1:].split()[0])
        else:
            cur.append(ln.strip())
    if cur:
        seqs.append("".join(cur))
    return names, seqs


def mutate(rng, frag: str, err: float, indel: float) -> str:
    out = []
    i = 0
    n = len(frag)
    while i < n:
        r = rng.rand()
        if r < indel / 2:          # deletion
            i += 1 + int(rng.rand() * 3)
            continue
        if r < indel:              # insertion
            out.append(BASES[rng.randint(0, 4)])
        c = frag[i]
        if rng.rand() < err:
            c = BASES[rng.randint(0, 4)]
        out.append(c)
        i += 1
    return "".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("fasta")
    ap.add_argument("out")
    ap.add_argument("-n", type=int, default=10000)
    ap.add_argument("-l", dest="rlen", type=int, default=150)
    ap.add_argument("--err", type=float, default=0.01)
    ap.add_argument("--indel", type=float, default=0.001)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--pe", default=None,
                    help="write FR mate-2 reads here (PE mode)")
    args = ap.parse_args()

    rng = np.random.RandomState(args.seed)
    names, seqs = load_fasta(args.fasta)
    tot = sum(len(s) for s in seqs)
    weights = np.array([len(s) for s in seqs], dtype=np.float64) / tot
    L = args.rlen
    q = "I" * L

    f2 = open(args.pe, "w") if args.pe else None
    with open(args.out, "w") as f1:
        for i in range(args.n):
            ci = rng.choice(len(seqs), p=weights)
            s = seqs[ci]
            if args.pe:
                isz = max(int(rng.normal(400, 60)), L + 20)
                if len(s) <= isz:
                    continue
                p = rng.randint(0, len(s) - isz)
                a = mutate(rng, s[p: p + L], args.err, args.indel)[:L]
                b = s[p + isz - L: p + isz]
                b = mutate(rng, b, args.err, args.indel)[:L]
                b = b.translate(COMP)[::-1]
                if len(a) < 30 or len(b) < 30:
                    continue
                name = f"sim{i}_{p + 1}_{p + isz - L + 1}"
                f1.write(f"@{name}\n{a}\n+\n{'I' * len(a)}\n")
                f2.write(f"@{name}\n{b}\n+\n{'I' * len(b)}\n")
            else:
                if len(s) <= L + 8:
                    continue
                p = rng.randint(0, len(s) - L - 8)
                w = mutate(rng, s[p: p + L + 8], args.err,
                           args.indel)[:L]
                if len(w) < 30 or "N" in w:
                    continue
                if i % 2:
                    w = w.translate(COMP)[::-1]
                f1.write(f"@sim{i}_{p + 1}\n{w}\n+\n{'I' * len(w)}\n")
    if f2:
        f2.close()


if __name__ == "__main__":
    main()
