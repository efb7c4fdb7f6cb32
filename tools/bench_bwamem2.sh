#!/bin/bash
# Measure real single-core bwa-mem2 throughput on this CPU host — the
# bench's vs_baseline denominator. Usage:
#   bash tools/bench_bwamem2.sh <ref.fa> <reads.fq> [bin]
# Builds the bwa-mem2 index next to ref.fa if missing, runs
# `mem -t 1` timed, prints reads/s.
set -e
REF=$1
FQ=$2
BIN=${3:-/tmp/refbuild/bwa-mem2}
if [ ! -f "$REF.bwt.2bit.64" ]; then
  echo "building bwa-mem2 index for $REF..." >&2
  "$BIN" index "$REF" 2>&1 | tail -3 >&2
fi
N=$(($(wc -l < "$FQ") / 4))
T0=$(date +%s%3N)
"$BIN" mem -t 1 "$REF" "$FQ" > /tmp/bwamem2_out.sam 2>/tmp/bwamem2_err.log
T1=$(date +%s%3N)
python3 - "$N" "$T0" "$T1" <<'PYEOF'
import sys
n, t0, t1 = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
dt = (t1 - t0) / 1e3
rps = n / dt
print(f"bwa-mem2 -t1: {n} reads in {dt:.1f}s = {rps:,.0f} reads/s "
      f"single-core; x40 (linear-scaling assumption) = {40*rps:,.0f}")
PYEOF
