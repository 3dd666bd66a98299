#!/usr/bin/env python3
"""Smoke test of the assembler on NVIDIA GPUs, with exact checks.

    python chip_smoke.py              # one card: kernels, GCPS, CLI runs
    python chip_smoke.py --chips 4    # only the sharded path, on four cards

Every device result is compared with the repo's own host path, exactly
(all device work is integer: hashes, packed compares, DP, sorts):

  * kernels at real widths: the window hash against its numpy twin, the
    packed verify kernels against numpy, the banded-LCS DP against the
    literal ACLCS transcription (and its Gcells/s);
  * the device GCPS engines (`device_join` on the 40k-read bench set,
    `device_scale` on the 920k-slot set) against the native C++ GCPS;
  * `python -m alga_tpu.cli` on the GPU against the same input assembled
    by a `JAX_PLATFORMS=cpu` child, byte for byte: the 920k-slot default
    run (cold and warm process) and the 2% error path, plus the error path
    with the banded-LCS fallback on (`use_acler_instead_of_aclcs=False`).

This process never opens a card: it generates the data, runs the CPU
references, and hands the card to one child at a time: the CLI runs
first, then the kernel and GCPS checks (started with
`JAX_PLATFORMS=cuda`, so a child without a GPU fails at start-up).  It
exits non-zero, printing no result, if any phase fails.  The last line of
stdout is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke")
GPU_ENV = {"JAX_PLATFORMS": "cuda"}
GPU_PLATFORM = "gpu"
CPU_ENV = {"JAX_PLATFORMS": "cpu"}

# error-path set: paired 2x100 reads (insert 300) of a random genome with
# 2% substitutions at 30x coverage, sized so the supplement's ACH batches
# reach the device branch of ops.align.ach_batch_auto (>= 200k unique pairs
# per batch; a CPU run measured ~20k per batch per 100 kb at 30x, ~8k at
# 20x, ~2k at 10x)
ERR_GENOME_LEN = 1_200_000
ERR_PAIRS = 180_000
ERR_SEED = 7
ERR_RATE = 0.02

# kernel parity widths
HASH_N, HASH_L, HASH_K = 80_000, 100, 55
VERIFY_M, VERIFY_N, VERIFY_L = 1 << 17, 8192, 112
LCS_M, LCS_N, LCS_L, LCS_E, LCS_SAMPLE = 1 << 17, 4096, 100, 2, 400


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# parent: data, CPU references, children on the card

def make_error_dataset() -> tuple[str, str]:
    import numpy as np

    d = os.path.join(WORK, "err")
    r1p, r2p = os.path.join(d, "r1.fastq"), os.path.join(d, "r2.fastq")
    if os.path.exists(r1p) and os.path.exists(r2p):
        return r1p, r2p
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(ERR_SEED)
    genome = rng.integers(0, 4, ERR_GENOME_LEN).astype(np.uint8)
    pos = rng.integers(0, ERR_GENOME_LEN - 300 + 1, ERR_PAIRS)
    cols = np.arange(100)
    r1 = genome[pos[:, None] + cols]
    r2 = 3 - genome[pos[:, None] + 299 - cols]        # revcomp of the tail
    for r in (r1, r2):
        err = rng.random(r.shape) < ERR_RATE
        # substitute a DIFFERENT base so the error load is exactly ERR_RATE
        r[err] = (r[err] + rng.integers(1, 4, int(err.sum()))) % 4
    acgt = np.frombuffer(b"ACGT", np.uint8)
    qual = "I" * 100
    for path, reads in ((r1p, r1), (r2p, r2)):
        seqs = acgt[reads]
        with open(path + ".tmp", "w") as f:
            for i in range(ERR_PAIRS):
                f.write(f"@p{i}\n{seqs[i].tobytes().decode()}\n+\n{qual}\n")
        os.replace(path + ".tmp", path)
    return r1p, r2p


def run_child(argv: list[str], env_over: dict, tag: str,
              timeout: float) -> tuple[float, str, str]:
    """Run one child to completion; raise with its log tail on failure."""
    env = {**os.environ, **env_over}
    t0 = time.perf_counter()
    p = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    with open(os.path.join(WORK, f"{tag}.log"), "w") as f:
        f.write(p.stdout + "\n--- stderr ---\n" + p.stderr)
    if p.returncode != 0:
        raise RuntimeError(f"{tag} exited {p.returncode}:\n"
                           f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    return wall, p.stdout, p.stderr


def run_metrics(stderr: str) -> dict:
    """The pipeline's stats JSON (the last stderr line with 'counters')."""
    for line in reversed(stderr.splitlines()):
        if line.startswith("{") and '"counters"' in line:
            return json.loads(line)
    raise RuntimeError("no run metrics in the child's stderr")


def cli(env_over: dict, tag: str, r1: str, r2: str, *extra: str,
        timeout: float = 900) -> tuple[float, dict, bytes]:
    out = os.path.join(WORK, f"{tag}.fasta")
    wall, _o, err = run_child(
        [sys.executable, "-m", "alga_tpu.cli", "--file1", r1, "--file2", r2,
         "--output", out, *extra], env_over, tag, timeout)
    with open(out, "rb") as f:
        return wall, run_metrics(err), f.read()


def lcs_assembly(env_over: dict, tag: str, r1: str, r2: str,
                 timeout: float = 900) -> tuple[float, dict, bytes]:
    """The error path with the banded-LCS fallback on, through
    pipeline.assemble_to_file (the CLI cannot switch it on)."""
    out = os.path.join(WORK, f"{tag}.fasta")
    code = (
        "from alga_tpu.config import AssemblyConfig\n"
        "from alga_tpu.pipeline import assemble_to_file\n"
        f"assemble_to_file(AssemblyConfig(file1={r1!r}, file2={r2!r}, "
        f"output={out!r}, error_rate={ERR_RATE}, "
        "use_acler_instead_of_aclcs=False))\n")
    wall, _o, err = run_child([sys.executable, "-c", code], env_over, tag,
                              timeout)
    with open(out, "rb") as f:
        return wall, run_metrics(err), f.read()


def same_bytes(what: str, got: bytes, want: bytes) -> None:
    if got != want:
        raise AssertionError(f"{what}: contigs differ from the CPU child "
                             f"({len(got)} vs {len(want)} bytes)")
    log(f"[smoke] {what}: contigs.fasta byte-identical to the CPU child "
        f"({len(got)} bytes, {got.count(b'>')} contigs)")


def device_child(phase: str, timeout: float) -> dict:
    _w, out, _e = run_child([sys.executable, os.path.abspath(__file__),
                             "--phase", phase], GPU_ENV, f"gpu_{phase}",
                            timeout)
    result = None
    for line in out.splitlines():
        if line.startswith("SMOKE_RESULT "):
            result = json.loads(line[len("SMOKE_RESULT "):])
        else:
            log(line)
    if result is None:
        raise RuntimeError(f"{phase} child printed no result")
    return result


def check_native() -> None:
    from alga_tpu import native
    if not native.available():
        raise RuntimeError("native host engine did not build (make -C native)")


def one_card() -> dict:
    import bench

    smi = bench.nvidia_smi()
    log(f"[smoke] card: {smi}")
    check_native()
    s1, s2 = bench._ensure_scale_dataset()
    e1, e2 = make_error_dataset()

    # CPU references (these children never open the card)
    t, _m, cpu_scale = cli(CPU_ENV, "cpu_scale", s1, s2)
    log(f"[smoke] CPU child, 920k-slot default run: {t:.1f}s")
    t, _m, cpu_err = cli(CPU_ENV, "cpu_err", e1, e2, "--error-rate",
                         str(ERR_RATE))
    log(f"[smoke] CPU child, error path: {t:.1f}s")
    t, _m, cpu_lcs = lcs_assembly(CPU_ENV, "cpu_lcs", e1, e2)
    log(f"[smoke] CPU child, error path with LCS fallback: {t:.1f}s")

    # the card, one child at a time; the first CLI process starts with
    # whatever compile cache the machine has
    card = f"[{smi}]"
    for run in ("cold", "warm"):
        t, m, got = cli(GPU_ENV, f"gpu_scale_{run}", s1, s2)
        same_bytes(f"920k-slot default run via CLI ({run} process)", got,
                   cpu_scale)
        c = m["counters"]
        log(f"[smoke] 920k-slot CLI {run} process: {t:.2f}s wall, "
            f"pipeline total {m['phase_seconds']['total']:.2f}s, "
            f"GCPS {m['phase_seconds'].get('graph_creator_prefsuf', 0):.2f}s"
            f", peak_bytes_in_use "
            f"{m['memory_peaks_mb'].get('device_peak_bytes')} {card}")
        if run == "cold":
            assert c.get("gcps_candidates", 0) > 0, \
                "GCPS did not run on the device"

    t, m, got = cli(GPU_ENV, "gpu_err", e1, e2, "--error-rate", str(ERR_RATE))
    same_bytes("error path via CLI (--error-rate 0.02)", got, cpu_err)
    c = m["counters"]
    assert c.get("ach_device_batches", 0) > 0, \
        f"device ACH branch not taken: {c}"
    log(f"[smoke] error path CLI: {t:.2f}s wall, device ACH batches "
        f"{c['ach_device_batches']}, alignments "
        f"{c.get('ach_total_alignments')}, peak_bytes_in_use "
        f"{m['memory_peaks_mb'].get('device_peak_bytes')} {card}")

    t, m, got = lcs_assembly(GPU_ENV, "gpu_lcs", e1, e2)
    same_bytes("error path with LCS fallback (use_acler_instead_of_aclcs"
               "=False)", got, cpu_lcs)
    c = m["counters"]
    assert c.get("ach_device_batches", 0) > 0 and \
        c.get("ach_lcs_alignments", 0) > 0, \
        f"device banded-LCS branch not taken: {c}"
    log(f"[smoke] LCS-fallback run: {t:.2f}s wall, device ACH batches "
        f"{c['ach_device_batches']}, LCS alignments "
        f"{c['ach_lcs_alignments']}, peak_bytes_in_use "
        f"{m['memory_peaks_mb'].get('device_peak_bytes')} {card}")

    # kernels at real widths + the device GCPS engines
    res = device_child("device", 900)
    return {"smi": smi, **res}


def four_cards() -> dict:
    import bench

    smi = bench.nvidia_smi()
    log(f"[smoke] cards: {smi}")
    check_native()
    s1, s2 = bench._ensure_scale_dataset()
    t, _m, cpu_scale = cli(CPU_ENV, "cpu_scale", s1, s2)
    log(f"[smoke] CPU child, 920k-slot default run: {t:.1f}s")
    res = device_child("sharded", 1500)
    for tag in ("gpu4_sharded", "gpu4_distributed"):
        with open(os.path.join(WORK, f"{tag}.fasta"), "rb") as f:
            same_bytes(f"920k-slot {tag[5:]} run on 4 cards", f.read(),
                       cpu_scale)
    return {"smi": smi, **res}


# ---------------------------------------------------------------------------
# children on the card

def _device_check(n_cards: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != GPU_PLATFORM or len(devs) < n_cards:
        raise RuntimeError(f"need {n_cards} GPU(s), JAX found {devs}")
    from alga_tpu import native
    assert native.available(), "native host engine unavailable"
    log(f"[smoke] JAX devices: {len(devs)} x {devs[0].device_kind}")
    return devs


def _eq(what: str, got, want) -> None:
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{what}: device != reference "
                             f"(shape {got.shape} vs {want.shape}, "
                             f"{bad} differing)")


def _hash_parity() -> None:
    import jax.numpy as jnp
    import numpy as np

    from alga_tpu.core import packing
    from alga_tpu.ops import hashes

    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, (HASH_N, HASH_L)).astype(np.uint8)
    lengths = rng.integers(HASH_K - 5, HASH_L + 1, HASH_N).astype(np.int64)
    packed = packing.codes_to_packed(codes, lengths)
    codes = packing.packed_to_codes(packed, HASH_L)     # zero past length
    nw = HASH_L - HASH_K + 1
    k1, k2, v = hashes.window_kmer_keys_u32(
        jnp.asarray(packed), jnp.asarray(lengths), HASH_K, nw)
    w1, w2, wv = hashes.np_window_kmer_keys(codes, lengths, HASH_K, nw)
    _eq("window hash h1", k1, w1)
    _eq("window hash h2", k2, w2)
    _eq("window hash valid", v, wv)
    log(f"[smoke] window_kmer_keys_u32 == numpy twin at {HASH_N}x{HASH_L} "
        f"(k={HASH_K}, {nw} windows): exact")


def _verify_parity() -> None:
    import jax.numpy as jnp
    import numpy as np

    from alga_tpu.core import packing
    from alga_tpu.ops import bitops

    rng = np.random.default_rng(2)
    M, N0, L = VERIFY_M, VERIFY_N, VERIFY_L
    half = M // 2
    codes = rng.integers(0, 4, (N0 + half, L)).astype(np.uint8)
    a = rng.integers(0, N0, M)
    s = rng.integers(0, L // 2, M)
    ln = rng.integers(1, L - s + 1)
    b = rng.integers(0, N0, M)
    # half the pairs get a planted suffix copy (own row each) with 0-3
    # substitutions, so equality and mismatch counts are non-trivial
    b[:half] = N0 + np.arange(half)
    cols = np.arange(L)
    src = np.minimum(s[:half, None] + cols, L - 1)
    planted = codes[a[:half, None], src]
    keep = cols[None, :] < (L - s[:half, None])
    codes[N0:] = np.where(keep, planted, codes[N0:])
    nerr = rng.integers(0, 4, half)
    for j in range(3):
        hit = np.flatnonzero(nerr > j)
        p = rng.integers(0, np.maximum(ln[hit], 1))
        codes[N0 + hit, p] = (codes[N0 + hit, p] + 1) % 4
    lengths = np.full(len(codes), L, np.int64)
    packed = packing.codes_to_packed(codes, lengths)
    W = packing.words_for(L)
    args = [jnp.asarray(x.astype(np.int32)) for x in (a, s, b, ln)]
    eq = bitops.substr_equal(jnp.asarray(packed), *args, W)
    mm = bitops.overlap_mismatch_count(jnp.asarray(packed), *args, W)
    want_eq = bitops.np_substr_equal_batch(codes, a, s, b, ln)
    av = codes[a[:, None], np.minimum(s[:, None] + cols, L - 1)]
    bv = codes[b[:, None], cols]
    want_mm = ((av != bv) & (cols[None, :] < ln[:, None])).sum(1)
    _eq("substr_equal", eq, want_eq)
    _eq("overlap_mismatch_count", mm, want_mm)
    assert want_eq.sum() > M // 16 and (want_mm > 0).sum() > M // 4
    log(f"[smoke] substr_equal / overlap_mismatch_count == numpy at {M} "
        f"pairs ({int(want_eq.sum())} equal): exact")


def _lcs_parity(card: str) -> float:
    import jax.numpy as jnp
    import numpy as np

    from alga_tpu.ops import align

    rng = np.random.default_rng(3)
    M, N, L, E = LCS_M, LCS_N, LCS_L, LCS_E
    codes = rng.integers(0, 4, (N, L)).astype(np.uint8)
    # noisy overlaps between rows 2i and 2i+1 (offset o, ~3% errors)
    o = rng.integers(5, L // 2, N // 2)
    for i in range(N // 2):
        seg = codes[2 * i, o[i]:].copy()
        noise = rng.random(len(seg)) < 0.03
        seg[noise] = rng.integers(0, 4, int(noise.sum()))
        codes[2 * i + 1, : len(seg)] = seg
    lengths = rng.integers(L - 20, L + 1, N).astype(np.int32)
    pick = rng.integers(0, N // 2, M)
    r1 = 2 * pick
    r2 = 2 * pick + 1
    offs = o[pick] + rng.integers(-2, 3, M)
    rand = rng.random(M) < 0.5
    r2[rand] = rng.integers(0, N, int(rand.sum()))
    offs = offs.astype(np.int32)
    d = [jnp.asarray(x) for x in (codes, lengths, r1.astype(np.int32),
                                  r2.astype(np.int32), offs)]
    got = np.asarray(align.banded_lcs_batch(*d, L, E))
    sample = rng.choice(M, LCS_SAMPLE, replace=False)
    want = np.array([align.np_banded_lcs(codes, lengths, int(r1[i]),
                                         int(r2[i]), int(offs[i]), E)
                     for i in sample])
    _eq("banded_lcs_batch", got[sample], want)
    assert len(np.unique(want)) > 10

    import bench
    g = bench._dp_bench()        # bench's Gcells/s at the same widths
    log(f"[smoke] banded_lcs_batch == np_banded_lcs on {LCS_SAMPLE} of "
        f"M={M} pairs (L={L}, E={E}): exact; XLA kernel {g:.3f} Gcells/s "
        f"(bench.py's DP leg) {card}")
    return g


def _gcps_input(r1: str | None, r2: str | None, reads=None):
    """The GCPS phase's input exactly as pipeline.assemble builds it."""
    from alga_tpu.config import AssemblyConfig, autotune
    from alga_tpu.io import fastx
    from alga_tpu.pipeline import remap_paired_offsets

    cfg = AssemblyConfig()
    pre_kw = dict(trim_left=cfg.read_end_trim_left,
                  trim_right=cfg.read_end_trim_right,
                  remove_reads_with_n=cfg.remove_reads_with_n,
                  rna=cfg.rna, str_period=cfg.str_period_threshold)
    if reads is not None:
        batch, paired = fastx.build_read_batch(reads, None, **pre_kw), False
    else:
        batch = fastx.load_read_batch(r1, r2,
                                      add_paired_reads=cfg.add_paired_reads,
                                      **pre_kw)
        paired = True
    tcfg = autotune(cfg, batch.avg_read_length())
    batch.valid &= ~fastx.mark_prefix_reads(batch)
    batch = remap_paired_offsets(batch, paired=paired)
    batch.valid &= ~(batch.lengths < tcfg.li_kmer_intervals
                     + tcfg.li_kmer_length)
    return batch, tcfg


def _host_gcps(batch, tcfg):
    """Native C++ GCPS: prefix keys + fused join/verify + post-join."""
    import numpy as np

    from alga_tpu import native
    from alga_tpu.graph.prefsuf import OverlapMatches
    from alga_tpu.ops import hashes

    packed = np.asarray(batch.packed)
    lengths = np.asarray(batch.lengths, np.int64)
    valid = np.asarray(batch.valid, bool)
    k, cap, n = tcfg.min_overlap_pref_suf, tcfg.read_length_cap, len(batch)
    pref_ids = np.flatnonzero((lengths >= k) & valid)
    pk = native.prefix_keys(packed, pref_ids, k, hashes.A1, hashes.A2)
    order = np.argsort(pk, kind="stable")
    src, dst, ell = native.gcps_join_verify_packed(
        n, int(lengths.max()) - k + 1, lengths, valid & (lengths >= k), k,
        cap, hashes.A1, hashes.A2, pk[order],
        pref_ids[order].astype(np.int32), packed)
    m = OverlapMatches(src.astype(np.int64), dst.astype(np.int64),
                       ell.astype(np.int64))
    return native.gcps_from_matches(n, m, packed, lengths,
                                    tcfg.rsoe_min_overlap, tcfg.soes)


def _edges(g):
    import numpy as np

    o = np.lexsort((g.offset, g.dst, g.src))
    return np.stack([g.src[o], g.dst[o], g.offset[o]]).astype(np.int64)


def _gcps_parity(name: str, engine, batch, tcfg, card: str) -> None:
    g_host = _host_gcps(batch, tcfg)
    args = (batch.packed, batch.lengths, len(batch),
            tcfg.min_overlap_pref_suf, tcfg.read_length_cap,
            tcfg.rsoe_min_overlap, tcfg.soes, batch.valid, batch.valid)
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        g_dev = engine(*args)
        walls.append(time.perf_counter() - t0)
    _eq(f"{name} edges", _edges(g_dev), _edges(g_host))
    assert g_host.num_edges > 0
    log(f"[smoke] {name} == native GCPS on {len(batch)} slots "
        f"({g_host.num_edges} edges): exact; first call {walls[0]:.2f}s, "
        f"second {walls[1]:.2f}s {card}")


def phase_device() -> dict:
    import bench
    from alga_tpu.graph.device_join import gcps_graph_device
    from alga_tpu.graph.device_scale import gcps_graph_device_scale

    devs = _device_check(1)
    card = f"[{devs[0].device_kind}]"
    _hash_parity()
    _verify_parity()
    gcells = _lcs_parity(card)
    _genome, reads = bench._simulate()
    batch, tcfg = _gcps_input(None, None, reads=reads)
    _gcps_parity("device_join", gcps_graph_device, batch, tcfg, card)
    s1, s2 = bench._ensure_scale_dataset()
    batch, tcfg = _gcps_input(s1, s2)
    _gcps_parity("device_scale", gcps_graph_device_scale, batch, tcfg, card)
    peak = (devs[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"[smoke] kernel phase peak_bytes_in_use {peak} {card}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "xla_lcs_gcells_per_s": gcells}


def phase_sharded() -> dict:
    import bench

    from alga_tpu.config import AssemblyConfig
    from alga_tpu.parallel.distributed import assemble_distributed
    from alga_tpu.parallel.mesh import make_mesh
    from alga_tpu.pipeline import assemble_to_file
    from alga_tpu.utils.timers import counters_report, reset_counters

    devs = _device_check(4)[:4]
    card = f"[4 x {devs[0].device_kind}]"
    s1, s2 = bench._ensure_scale_dataset()

    def report(tag, c, wall):
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
                 for d in devs]
        a2a = {k: v for k, v in c.items() if k.startswith("a2a_bytes")}
        rows, rows_max = (c.get("sharded_store_rows", 0),
                          c.get("sharded_store_rows_max_device", 0))
        log(f"[smoke] {tag}: {wall:.2f}s; per-card peak_bytes_in_use "
            f"{peaks}; {a2a}; store rows {rows}, most on one card "
            f"{rows_max} {card}")
        assert rows > 0 and a2a.get("a2a_bytes_gcps_total", 0) > 0, \
            f"{tag} did not run the sharded GCPS: {c}"
        assert rows_max * 4 == rows, \
            f"{tag}: one card holds {rows_max} of {rows} store rows"

    for tag, run in (
            ("sharded", lambda cfg: assemble_to_file(cfg)),
            ("distributed",
             lambda cfg: assemble_distributed(cfg, mesh=make_mesh(4)))):
        out = os.path.join(WORK, f"gpu4_{tag}.fasta")
        reset_counters()
        t0 = time.perf_counter()
        run(AssemblyConfig(file1=s1, file2=s2, output=out))
        report(f"pipeline {tag} 920k-slot run", counters_report(),
               time.perf_counter() - t0)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=[1, 4])
    ap.add_argument("--phase", choices=["device", "sharded"],
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    os.makedirs(WORK, exist_ok=True)
    if args.phase:
        res = phase_device() if args.phase == "device" else phase_sharded()
        print("SMOKE_RESULT " + json.dumps(res), flush=True)
        return 0
    plat = os.environ.get("JAX_PLATFORMS", "")
    if plat and not {"cuda", "gpu"} & set(plat.split(",")):
        print(f"[smoke] FAILED: JAX_PLATFORMS={plat} leaves JAX no GPU",
              file=sys.stderr)
        return 1
    try:
        res = one_card() if args.chips == 1 else four_cards()
    except Exception as e:
        print(f"[smoke] FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    log(f"[smoke] nvidia-smi name, power.limit: {res['smi']}")
    print(json.dumps({"ok": True, "device": {
        "platform": res["platform"], "kind": res["kind"],
        "count": res["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
