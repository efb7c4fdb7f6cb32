"""bwa-mem-scale-tpu: a short-read aligner on JAX, run on an NVIDIA GPU.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
etri/bwa-mem-scale (BWA-MEM-class FM-index alignment with the Exact Match
Filter, FM-index Accelerator tables, ERT seeding, and an in-memory index
store), as fixed-shape batched device programs:

- FM-index occurrence counting is a batched HBM gather + popcount over
  checkpointed one-hot BWT blocks (see ``ops/occ.py``).
- SMEM search runs thousands of reads in lockstep through masked
  ``lax.while_loop`` passes (``ops/smem.py``).
- Banded Smith-Waterman extension is one pair per lane: a Pallas
  kernel on the GPU (``ops/bsw_pallas.py``) and a row-scan jnp DP on
  the CPU (``ops/bsw.py``), both with the exact score semantics of the
  reference's scalar kernel (reference: src/bandedSWA.cpp:116-238).
- Irregular, string-ish work (FASTA/FASTQ parse, SAM text, index
  construction) stays on host.

The ``ref/`` package holds pure-NumPy oracle implementations that encode
the exact reference semantics; every device kernel is tested against them.

64-bit integer support is required for genome-scale indices (positions in
[0, 2*l_pac) can exceed 2^32 for hg38's forward+reverse-complement text),
so x64 is enabled at import. Small genomes automatically use an int32
fast path chosen at index load time.
"""

import jax

jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"
