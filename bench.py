"""Benchmark harness: end-to-end assembly throughput on the attached GPU.

Prints ONE JSON line on stdout, last:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
   "platform": "gpu", "device_kind": "...", "nvidia_smi": "...", ...}

Exits non-zero when JAX finds no GPU, and when any leg fails.

Baseline: reference ALGA (C++/pthreads, -O3) on the SAME deterministic
dataset (200kb random genome, 40k x 100bp error-free reads, seed 123),
--threads 1, measured on a 2-core CPU host: 1.59s (25,206 reads/s).  The
anchors have not been re-measured on the GPU machine's host.

Secondary kernel metrics go to stderr.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REF_BASELINE_READS_PER_S = 25206.0  # measured: see module docstring

# 920k-slot scale anchor (4.6Mb genome, 230k pairs, seed 42): reference
# --threads 1 on the same 2-core CPU host, best of 2 = 30.8s for 460k
# file reads.
REF_SCALE_READS_PER_S = 14935.0
SCALE_GENOME_LEN = 4_600_000
SCALE_COVERAGE = 10.0
SCALE_SEED = 42
SCALE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".bench_data", "scale")

GENOME_LEN = 200_000
READ_LEN = 100
COVERAGE = 20
SEED = 123


def _simulate():
    comp = str.maketrans("ACGT", "TGCA")
    rng = np.random.default_rng(SEED)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, size=GENOME_LEN)].tobytes().decode()
    n_reads = GENOME_LEN * COVERAGE // READ_LEN
    reads = []
    for _ in range(n_reads):
        p = int(rng.integers(0, GENOME_LEN - READ_LEN + 1))
        r = genome[p : p + READ_LEN]
        if rng.random() < 0.5:
            r = r.translate(comp)[::-1]
        reads.append(r)
    return genome, reads


def _kernel_bench():
    """Device kernel throughput: window hashing + packed verification."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from alga_tpu.core import packing
    from alga_tpu.ops import bitops, hashes

    rng = np.random.default_rng(0)
    N, L, K = 8192, 112, 55
    codes = rng.integers(0, 4, size=(N, L)).astype(np.uint8)
    lengths = np.full(N, L, dtype=np.int64)
    packed = jnp.asarray(packing.codes_to_packed(codes, lengths))
    lengths_d = jnp.asarray(lengths)
    num_windows = L - K + 1

    # Measurement: iterations CHAIN on-device inside one jit
    # (data-dependent carry, no DCE/hoisting), the sync is a SCALAR FETCH
    # (int(...)), and throughput is the MARGINAL rate between a short and a
    # long chain, cancelling the dispatch+fetch latency.
    IT1, IT2 = 256, 2048

    @partial(jax.jit, static_argnums=(1,))
    def run_hash_chained(p, iters):
        def body(_, carry):
            p_, acc = carry
            k1, _k2, _v = hashes.window_kmer_keys_u32(p_, lengths_d, K,
                                                      num_windows)
            t = jnp.sum(k1, dtype=jnp.uint32)
            return p_ ^ (t & jnp.uint32(1)), acc + t
        return jax.lax.fori_loop(0, iters, body,
                                 (p, jnp.uint32(0)))[1]

    int(run_hash_chained(packed, IT1))   # compile + run
    int(run_hash_chained(packed, IT2))
    gb_hash = 0.0
    for w in range(1, 3):
        pw = packed ^ jnp.uint32(w)
        int(pw[0, 0])                     # sync the input
        t0 = time.perf_counter()
        int(run_hash_chained(pw, IT1))
        t1 = time.perf_counter()
        int(run_hash_chained(pw, IT2))
        t2 = time.perf_counter()
        dt = max((t2 - t1) - (t1 - t0), 1e-9)
        gb_hash = max(gb_hash, N * num_windows * (IT2 - IT1) / dt / 1e9)

    M = 65536
    a = jnp.asarray(rng.integers(0, N, M).astype(np.int32))
    b = jnp.asarray(rng.integers(0, N, M).astype(np.int32))
    s = jnp.asarray(rng.integers(0, L // 2, M).astype(np.int32))
    l = jnp.asarray((L - np.asarray(s)).astype(np.int32))
    W = (L + 15) // 16

    @partial(jax.jit, static_argnums=(1,))
    def run_verify_chained(a0, iters):
        def body(_, carry):
            a_, acc = carry
            mm = bitops.overlap_mismatch_count(packed, a_, s, b, l, W)
            t = jnp.sum(mm).astype(jnp.int32)
            return (a_ + (t & 1)) % N, acc + t
        return jax.lax.fori_loop(0, iters, body, (a0, jnp.int32(0)))[1]

    V1, V2 = 8, 64
    int(run_verify_chained(a, V1))
    int(run_verify_chained(a, V2))
    gb_cmp = 0.0
    bases_iter = float(np.asarray(l).sum())
    for w in range(1, 3):
        aw = (a + w) % N
        int(aw[0])
        t0 = time.perf_counter()
        int(run_verify_chained(aw, V1))
        t1 = time.perf_counter()
        int(run_verify_chained(aw, V2))
        t2 = time.perf_counter()
        dt = max((t2 - t1) - (t1 - t0), 1e-9)
        gb_cmp = max(gb_cmp, bases_iter * (V2 - V1) / dt / 1e9)

    print(f"[bench] window-hash throughput: {gb_hash:.3f} Gbases/s", file=sys.stderr)
    print(f"[bench] packed-compare throughput: {gb_cmp:.3f} Gbases/s", file=sys.stderr)
    return gb_hash, gb_cmp


def _dp_bench():
    """Banded-LCS DP throughput of the XLA kernel (`banded_lcs_batch`, the
    production LCS fallback) in Gcells/s.

    Cells = pairs x rows(len1 - p_beg) x band(2E+1).  Reference hot loop:
    ACLCS.cpp:61-150 (scalar-sequential)."""
    import jax.numpy as jnp
    from alga_tpu.ops.align import banded_lcs_batch

    rng = np.random.default_rng(0)
    N, L, E = 4096, 100, 2
    M = 1 << 17
    codes = rng.integers(0, 4, size=(N, L)).astype(np.uint8)
    lengths = np.full(N, L, dtype=np.int32)
    r1 = jnp.asarray(rng.integers(0, N, M).astype(np.int32))
    r2 = jnp.asarray(rng.integers(0, N, M).astype(np.int32))
    offs_np = rng.integers(5, L // 2, M).astype(np.int32)
    offs = jnp.asarray(offs_np)
    codes_d = jnp.asarray(codes)
    lengths_d = jnp.asarray(lengths)

    # cells actually computed: rows p in [max(0, off-E), L) x (2E+1)
    rows = (L - np.maximum(0, offs_np - E)).astype(np.int64)
    cells_per_iter = float(rows.sum()) * (2 * E + 1)

    # scalar-fetch sync + marginal between 2 and 12 dispatches (see
    # _kernel_bench); the median of 5 windows is reported
    def timed(k):
        t0 = time.perf_counter()
        acc = None
        for _ in range(k):
            acc = jnp.sum(banded_lcs_batch(codes_d, lengths_d, r1, r2, offs,
                                           L, E))
        int(acc)
        return time.perf_counter() - t0

    timed(1)                      # compile
    vals = []
    for _w in range(5):
        d1 = timed(2)
        d2 = timed(12)
        vals.append(cells_per_iter * 10 / max(d2 - d1, 1e-9) / 1e9)
    vals.sort()
    gcells = vals[len(vals) // 2]
    print(f"[bench] banded-DP (xla) windows: {['%.3f' % v for v in vals]}",
          file=sys.stderr)
    print(f"[bench] banded-DP (xla): {gcells:.3f} Gcells/s "
          f"(M={M}, band={2*E+1}, rows<=~{L})", file=sys.stderr)
    return gcells


def nvidia_smi() -> str:
    """`name, power.limit` of the first card, as nvidia-smi reports them
    (read without JAX, so it may run beside the process on the card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    # fresh-process cold starts first, while this process stays off JAX:
    # one process holds the card at a time
    cold = _fresh_process_cold_starts()

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"[bench] no GPU: JAX found {dev.platform} devices",
              file=sys.stderr)
        return 1
    from alga_tpu.config import AssemblyConfig
    from alga_tpu.pipeline import assemble

    smi = nvidia_smi()
    print(f"[bench] devices: {jax.devices()}; card: {smi}", file=sys.stderr)

    genome, reads = _simulate()
    n_reads = len(reads)
    best = None
    cold_start_s = None
    for run in range(3):   # run 0 pays one-time kernel compiles; the
                           # persistent cache makes later runs the steady
                           # state
        t0 = time.perf_counter()
        res = assemble(AssemblyConfig(), file1_seqs=reads)
        dt = time.perf_counter() - t0
        print(f"[bench] e2e run{run}: {n_reads} reads in {dt:.2f}s -> "
              f"{n_reads/dt:.0f} reads/s; contigs={res.stats['count']} "
              f"n50={res.stats['n50']}", file=sys.stderr)
        if run == 0:
            cold_start_s = dt
        best = dt if best is None else min(best, dt)
    reads_per_s = n_reads / best

    headline = {
        "metric": "assembly_reads_per_s",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_s / REF_BASELINE_READS_PER_S, 3),
        "cold_start_s": round(cold_start_s, 2),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "nvidia_smi": smi,
    }
    gb_hash, gb_cmp = _kernel_bench()
    headline["window_hash_gbases_per_s"] = round(gb_hash, 3)
    headline["packed_compare_gbases_per_s"] = round(gb_cmp, 3)
    headline["xla_dp_gcells_per_s"] = round(_dp_bench(), 3)
    headline["error_path_reads_per_s"] = round(_error_path_bench(), 1)
    headline.update(_scale_bench())
    headline.update(cold)

    # FINAL stdout line = the headline object with all secondary metrics
    sys.stderr.flush()
    print(json.dumps(headline), flush=True)
    return 0


def _error_path_bench():
    """Error-tolerant path e2e (paired reads, --error-rate 0.02): exercises
    the LI/PKB supplement and its ACLER verifier.  Secondary stderr metric
    (config-3 analogue)."""
    from alga_tpu.config import AssemblyConfig
    from alga_tpu.pipeline import assemble

    comp = str.maketrans("ACGT", "TGCA")
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, size=100_000)].tobytes().decode()
    ins, rl, npairs = 300, 100, 10_000
    r1s, r2s = [], []
    for _ in range(npairs):
        p = int(rng.integers(0, len(genome) - ins))
        frag = genome[p:p + ins]
        a, b = frag[:rl], frag[-rl:].translate(comp)[::-1]
        out = []
        for s in (a, b):
            arr = np.frombuffer(s.encode(), dtype=np.uint8).copy()
            err = rng.random(rl) < 0.02
            ne = int(err.sum())
            # substitute with a DIFFERENT base so the injected error load
            # matches the labeled 2% exactly
            repl = bases[rng.integers(0, 4, ne)]
            same = repl == arr[err]
            repl[same] = bases[(np.searchsorted(bases, repl[same]) + 1) % 4]
            arr[err] = repl
            out.append(arr.tobytes().decode())
        r1s.append(out[0])
        r2s.append(out[1])

    n_reads = 2 * npairs
    best = None
    for run in range(2):
        t0 = time.perf_counter()
        res = assemble(AssemblyConfig(error_rate=0.02),
                       file1_seqs=r1s, file2_seqs=r2s)
        dt = time.perf_counter() - t0
        print(f"[bench] error-path run{run}: {n_reads} reads in {dt:.2f}s -> "
              f"{n_reads/dt:.0f} reads/s; contigs={res.stats['count']} "
              f"n50={res.stats['n50']}", file=sys.stderr)
        best = dt if best is None else min(best, dt)
    print(f"[bench] error-path e2e: {n_reads/best:.0f} reads/s (warm)",
          file=sys.stderr)
    return n_reads / best




def _ensure_scale_dataset():
    """Generate-or-reuse the cached 920k-slot FASTQ pair (seed 42)."""
    r1p = os.path.join(SCALE_DIR, "r1.fastq")
    r2p = os.path.join(SCALE_DIR, "r2.fastq")
    if os.path.exists(r1p) and os.path.exists(r2p):
        return r1p, r2p
    os.makedirs(SCALE_DIR, exist_ok=True)
    comp = str.maketrans("ACGT", "TGCA")
    rng = np.random.default_rng(SCALE_SEED)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, size=SCALE_GENOME_LEN)].tobytes().decode()
    n_frags = int(SCALE_GENOME_LEN * SCALE_COVERAGE / 200)
    with open(r1p + ".tmp", "w") as f1, open(r2p + ".tmp", "w") as f2:
        for i in range(n_frags):
            p = int(rng.integers(0, SCALE_GENOME_LEN - 300 + 1))
            frag = genome[p : p + 300]
            a = frag[:100]
            b = frag[-100:].translate(comp)[::-1]
            if rng.random() < 0.5:
                a, b = b.translate(comp)[::-1], a.translate(comp)[::-1]
            f1.write(f"@r{i}\n{a}\n+\n{'I' * 100}\n")
            f2.write(f"@r{i}\n{b}\n+\n{'I' * 100}\n")
    os.replace(r1p + ".tmp", r1p)
    os.replace(r2p + ".tmp", r2p)
    return r1p, r2p


def _scale_bench():
    """920k-slot e2e on the attached device, in this process: best of 2
    runs after a warm-up run that pays the compiles."""
    from alga_tpu.config import AssemblyConfig
    from alga_tpu.pipeline import assemble_to_file

    r1p, r2p = _ensure_scale_dataset()
    cfg = AssemblyConfig(file1=r1p, file2=r2p,
                         output=os.path.join(SCALE_DIR, "contigs.fasta"))
    best = None
    for run in range(3):
        t0 = time.perf_counter()
        assemble_to_file(cfg)
        wall = time.perf_counter() - t0
        print(f"[bench] scale run{run}: 460000 reads in {wall:.2f}s",
              file=sys.stderr)
        if run > 0:
            best = wall if best is None else min(best, wall)
    rps = 460_000 / best
    return {
        "scale_reads_per_s": round(rps, 1),
        "scale_vs_baseline": round(rps / REF_SCALE_READS_PER_S, 3),
    }


def _fresh_process_cold_starts():
    """Cold start of 3 FRESH processes with the persistent compile cache
    enabled: best/worst wall for the standard bench dataset.  Each child
    holds the card alone, so the caller must not have opened it yet."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "sys.argv = ['bench_fresh']\n"
        "import bench, jax\n"
        "print('FRESH_PLATFORM', jax.devices()[0].platform)\n"
        "genome, reads = bench._simulate()\n"
        "from alga_tpu.config import AssemblyConfig\n"
        "from alga_tpu.pipeline import assemble\n"
        "t0 = time.perf_counter()\n"
        "assemble(AssemblyConfig(), file1_seqs=reads)\n"
        "print('FRESH_WALL', time.perf_counter() - t0)\n"
    ) % (os.path.dirname(os.path.abspath(__file__)),)
    walls = []
    for run in range(3):
        out = subprocess.run([sys.executable, "-c", code], timeout=900,
                             capture_output=True, text=True, check=True)
        fields = dict(line.split(None, 1) for line in out.stdout.splitlines()
                      if line.startswith("FRESH_"))
        if fields.get("FRESH_PLATFORM") != "gpu":
            raise RuntimeError(
                f"fresh process ran on {fields.get('FRESH_PLATFORM')}, "
                "not a GPU")
        walls.append(float(fields["FRESH_WALL"]))
        print(f"[bench] fresh-process run{run}: {walls[-1]:.2f}s",
              file=sys.stderr)
    return {
        "cold_start_fresh_best_s": round(min(walls), 2),
        "cold_start_fresh_worst_s": round(max(walls), 2),
    }


if __name__ == "__main__":
    sys.exit(main())
