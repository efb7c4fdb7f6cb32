"""Multi-process data-parallel test (SURVEY §4's multi-host strategy):
two jax.distributed processes, each owning half the read batch over a
global CPU mesh, must produce exactly the per-read alignment regions
of a single-process run.

STATUS on this toolchain (jax 0.9.0, probed 2026-08-17): CPU devices
do NOT federate across processes — after jax.distributed.initialize,
jax.device_count() stays at the local count with both the default and
the gloo collectives config (jax_num_cpu_devices /
xla_force_host_platform_device_count are also ignored under the
distributed CPU client), so each worker silently runs a process-local
mesh and the cross-process comparison cannot execute. The sharded
program itself (parallel/mesh.py) is validated on a single-process
8-virtual-device mesh by __graft_entry__.dryrun_multichip and the
mesh tests; this script becomes the real multi-host acceptance test
on hardware with a working multi-process backend (several GPU hosts,
or a jax build with CPU gloo collectives).

Orchestrator:  python tools/multiproc_dp_test.py
Worker:        python tools/multiproc_dp_test.py --worker PID PORT
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_PROC = 2
LOCAL_DEVICES = 2
GENOME_BP = 12000
B = 16          # global batch
L = 64


def regions_by_read(packed):
    """packed int32 [PX, 14] -> {read: sorted[(qb,qe,score,rb,re)]}"""
    out = {}
    for row in packed:
        if not row[0]:
            continue
        rb = (int(row[11]) << 31) | int(row[10])
        re = (int(row[13]) << 31) | int(row[12])
        out.setdefault(int(row[1]), []).append(
            (int(row[2]), int(row[3]), int(row[4]), rb, re))
    return {k: sorted(v) for k, v in out.items()}


def worker(pid: int, port: int):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={LOCAL_DEVICES}")
    import jax
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=N_PROC, process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from jax.experimental import multihost_utils

    from bwa_mem_scale_tpu.config import MemOptions
    from bwa_mem_scale_tpu.pipeline.align import (PipelineConfig,
                                                  seed_chain_extend)
    from bwa_mem_scale_tpu.models.aligner import (build_demo_aligner,
                                                  simulate_reads)
    from bwa_mem_scale_tpu.parallel.mesh import sharded_align_fn

    opt = MemOptions()
    cfg = PipelineConfig(max_coords=64, max_chains=8,
                         max_seeds_per_chain=8, max_regs=8)
    # deterministic index + reads: both processes build identical state
    aligner = build_demo_aligner(genome_bp=GENOME_BP, opt=opt, cfg=cfg)
    codes, lens = simulate_reads(aligner.idx.bns, B, L, err_rate=0.02)
    codes = np.asarray(codes, np.int32)
    lens = np.asarray(lens, np.int32)

    mesh = Mesh(np.array(jax.devices()), ("dp",))
    half = B // N_PROC
    lo, hi = pid * half, (pid + 1) * half
    codes_g = multihost_utils.host_local_array_to_global_array(
        codes[lo:hi], mesh, P("dp", None))
    lens_g = multihost_utils.host_local_array_to_global_array(
        lens[lo:hi], mesh, P("dp"))

    fn = sharded_align_fn(mesh, opt, cfg, L)
    out = fn(aligner.fmi, aligner.dbns, codes_g, lens_g)
    for sh in out["packed"].addressable_shards:
        d = np.asarray(sh.data)
        print(f"proc {pid} dev{sh.device.id} idx{sh.index}: "
              f"valid={int((d[:, 0] == 1).sum())} "
              f"reads={sorted(set(int(r) for r in d[d[:, 0] == 1, 1]))}",
              flush=True)
    # local input sanity
    lg = multihost_utils.process_allgather(lens_g, tiled=True)
    print(f"proc {pid}: global lens={np.asarray(lg).tolist()}",
          flush=True)
    packed_g = multihost_utils.process_allgather(out["packed"],
                                                tiled=True)
    got = regions_by_read(np.asarray(packed_g))

    # single-process reference on this process's local devices
    ref_out = jax.jit(
        lambda f, d, c, l: seed_chain_extend(f, d, c, l, L=L, opt=opt,
                                             cfg=cfg, fma=None,
                                             ert=None)
    )(aligner.fmi, aligner.dbns, jnp.asarray(codes),
      jnp.asarray(lens))
    want = regions_by_read(np.asarray(ref_out["packed"]))

    ok = got == want
    n_regs = sum(len(v) for v in want.values())
    print(f"proc {pid}: {'MATCH' if ok else 'MISMATCH'} "
          f"({len(want)} reads, {n_regs} regions)", flush=True)
    if not ok and pid == 0:
        for r in sorted(set(got) | set(want)):
            g, w = got.get(r), want.get(r)
            if g != w:
                print(f"  read {r}:\n    got  {g}\n    want {w}",
                      flush=True)
    if not ok:
        sys.exit(1)


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]), int(sys.argv[3]))
        return
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker",
         str(i), str(port)]) for i in range(N_PROC)]
    rcs = [p.wait(timeout=1800) for p in procs]
    if any(rcs):
        print("MULTIPROCESS DP TEST FAILED", rcs)
        sys.exit(1)
    print("MULTIPROCESS DP TEST PASSED")


if __name__ == "__main__":
    main()
