"""alga_tpu — an accelerator overlap-graph (OLC) de-novo genome assembler.

A ground-up re-design of the capabilities of swacisko/ALGA (C++17/pthreads)
for an accelerator: JAX/XLA for the compute path (rolling-hash overlap
sweeps, packed-bit alignment kernels, banded DP), `jax.sharding` meshes +
collectives for scale-out, a native C++ host engine and a thin host layer
for ragged bookkeeping (IO, graph surgery, contig walking).

Layer map (mirrors reference SURVEY.md §1, re-architected for the device):

  config.py         — immutable config + ALGA's auto-tuning contract
                      (ref: src/Params.cpp, src/main.cpp:93-115)
  core/             — packed 2-bit sequence batches (ref: Bitset/Read)
  ops/              — device kernels: rolling double-hash sweep, XOR/popcount
                      overlap verify, banded LCS DP (ref: GraphCreatorPrefSuf
                      hash loop, AlignmentController{LowErrorRate,LCS})
  graph/            — overlap-graph build + simplification passes as
                      vectorized array algorithms (ref: GraphCreators/,
                      GraphSimplifiers/)
  contig/           — contig walking + per-column consensus (ref:
                      ContigCreators/, Contig::correctSnipsInContig)
  io/               — FASTA/FASTQ ingest, preprocessing, contig output
                      (ref: IO/)
  parallel/         — device-mesh sharding of the overlap sweep
                      (no reference counterpart; the reference is
                      single-process pthreads)
  pipeline.py       — end-to-end assembly orchestration (ref: src/main.cpp)
"""

import jax

# Genomic hash arithmetic needs 64-bit integers (rolling polynomial hashes
# modulo ~2^31 primes accumulate in int64).  Enable before first trace.
jax.config.update("jax_enable_x64", True)

from alga_tpu.jax_cache import enable_compile_cache as _enable_compile_cache

_enable_compile_cache()

__version__ = "0.1.0"
