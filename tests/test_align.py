"""Differential tests for the error-path alignment kernels."""

import numpy as np
import pytest

from alga_tpu.core import packing
from alga_tpu.ops import align


def _batch(rng, n, L):
    codes = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    lengths = np.full(n, L, dtype=np.int64)
    return codes, lengths, packing.codes_to_packed(codes, lengths)


def _overlapping_pairs(rng, codes, lengths, m, err=0.03):
    """Make r2 a noisy suffix-shift of r1."""
    n, L = codes.shape
    r1 = rng.integers(0, n, m)
    offs = rng.integers(0, L // 2, m)
    for i, (a, o) in enumerate(zip(r1, offs)):
        seg = codes[a, o:].copy()
        noise = rng.random(len(seg)) < err
        seg[noise] = rng.integers(0, 4, noise.sum())
        codes[(a + 1) % n, : len(seg)] = seg
    r2 = (r1 + 1) % n
    return r1, r2, offs


def test_acler_batch_vs_oracle(rng):
    codes, lengths, _ = _batch(rng, 40, 80)
    r1, r2, offs = _overlapping_pairs(rng, codes, lengths, 60)
    packed = packing.codes_to_packed(codes, lengths)
    kw = dict(max_offset_percent=70, min_overlap_area=20,
              min_overlap_for_lcs_low_error=90, same_ends_length=3)
    got = np.asarray(align.acler_batch(
        packed, lengths, r1, r2, offs, packing.words_for(80),
        kw["max_offset_percent"], kw["min_overlap_area"],
        kw["min_overlap_for_lcs_low_error"], kw["same_ends_length"]))
    want = np.array([
        align.np_acler(codes, lengths, a, b, int(o), **kw)
        for a, b, o in zip(r1, r2, offs)])
    np.testing.assert_array_equal(got, want)
    assert want.any(), "test data produced no accepted alignments"
    assert not want.all(), "test data produced no rejections"


def test_acler_exact_overlap_accepts(rng):
    codes, lengths, _ = _batch(rng, 4, 60)
    codes[1, :40] = codes[0, 20:]   # exact overlap of 40 at offset 20
    packed = packing.codes_to_packed(codes, lengths)
    got = np.asarray(align.acler_batch(
        packed, lengths, np.array([0]), np.array([1]), np.array([20]),
        4, 70, 20, 95, 3))
    assert got[0]


def test_banded_lcs_vs_oracle_random(rng):
    codes, lengths, _ = _batch(rng, 30, 70)
    r1, r2, offs = _overlapping_pairs(rng, codes, lengths, 50, err=0.05)
    got = np.asarray(align.banded_lcs_batch(
        codes, lengths, r1, r2, offs, 70, 2))
    want = np.array([
        align.np_banded_lcs(codes, lengths, a, b, int(o), 2)
        for a, b, o in zip(r1, r2, offs)])
    np.testing.assert_array_equal(got, want)


def test_banded_lcs_perfect_overlap(rng):
    codes, lengths, _ = _batch(rng, 4, 50)
    codes[1, :30] = codes[0, 20:]
    got = int(np.asarray(align.banded_lcs_batch(
        codes, lengths, np.array([0]), np.array([1]), np.array([20]), 50, 2))[0])
    want = align.np_banded_lcs(codes, lengths, 0, 1, 20, 2)
    assert got == want == 30


def test_banded_lcs_detects_indel(rng):
    # one deletion inside the overlap: LCS should be overlap-1 (band
    # half-width 2 absorbs the shift)
    codes, lengths, _ = _batch(rng, 4, 50)
    seg = codes[0, 20:].copy()           # 30 bases
    with_del = np.concatenate([seg[:10], seg[11:], [0]])  # delete one base
    codes[1, : len(with_del)] = with_del
    got = int(np.asarray(align.banded_lcs_batch(
        codes, lengths, np.array([0]), np.array([1]), np.array([20]), 50, 2))[0])
    want = align.np_banded_lcs(codes, lengths, 0, 1, 20, 2)
    assert got == want
    assert got >= 28


def test_varied_lengths(rng):
    # different read lengths exercise the p*/q* clamping
    seqs = []
    for _ in range(12):
        seqs.append("".join("ACGT"[i] for i in rng.integers(0, 4, rng.integers(30, 70))))
    codes, lengths = packing.strings_to_codes(seqs)
    m = 40
    r1 = rng.integers(0, 12, m)
    r2 = rng.integers(0, 12, m)
    offs = np.array([int(rng.integers(0, max(1, lengths[a] - 10))) for a in r1])
    got = np.asarray(align.banded_lcs_batch(
        codes, lengths.astype(np.int64), r1, r2, offs, codes.shape[1], 2))
    want = np.array([
        align.np_banded_lcs(codes, lengths, a, b, int(o), 2)
        for a, b, o in zip(r1, r2, offs)])
    np.testing.assert_array_equal(got, want)


def test_acler_batch_native_matches_numpy(rng):
    """Native packed ACLER == _np_ach_chunk (ACLER-only config) over
    randomized pairs incl. same-ends quirk boundaries."""
    from alga_tpu import native as native_mod
    from alga_tpu.config import AssemblyConfig, autotune
    from alga_tpu.core import packing
    from alga_tpu.ops.align import np_ach_batch

    if not native_mod.available():
        pytest.skip("native engine not built")
    n, L = 200, 100
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, size=2000))
    seqs = []
    for _ in range(n):
        p = int(rng.integers(0, 2000 - L))
        s = list(genome[p : p + L])
        for _e in range(int(rng.integers(0, 4))):
            s[int(rng.integers(0, L))] = "ACGT"[int(rng.integers(0, 4))]
        seqs.append("".join(s))
    packed, lengths = packing.pack_strings(seqs)
    codes = packing.packed_to_codes(packed, L)
    cfg = autotune(AssemblyConfig(error_rate=0.02), 100.0)
    from alga_tpu.config import supplement_retune
    cfg = supplement_retune(cfg, 100.0)
    assert cfg.use_acler_instead_of_aclcs

    # half random pairs (mostly rejects), half genuinely tiled pairs
    M = 4000
    r1 = rng.integers(0, n, M).astype(np.int64)
    r2 = rng.integers(0, n, M).astype(np.int64)
    off = rng.integers(-2, 60, M).astype(np.int64)
    step = 10
    tiled = [genome[p : p + L] for p in range(0, 2000 - L, step)]
    nt = len(tiled)
    packed2, lengths2 = packing.pack_strings(seqs + tiled)
    codes2 = packing.packed_to_codes(packed2, L)
    for t in range(0, M, 2):
        i = int(rng.integers(0, nt - 3))
        d = int(rng.integers(1, 4))
        r1[t] = n + i
        r2[t] = n + i + d
        off[t] = d * step
    want = np_ach_batch(codes2, lengths2.astype(np.int64), r1, r2, off, cfg)
    got = native_mod.acler_batch_native(packed2, lengths2, r1, r2, off, cfg)
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def test_acler_batch_native_min_offset(rng):
    """ADVICE r4: the native ACLER batch must honor
    cfg.min_offset_for_alignment (the numpy twin's offsets >= min_off
    guard, _np_ach_chunk), not a hardcoded off < 0."""
    import dataclasses

    from alga_tpu import native as native_mod
    from alga_tpu.config import AssemblyConfig, autotune, supplement_retune
    from alga_tpu.core import packing
    from alga_tpu.ops.align import np_ach_batch

    if not native_mod.available():
        pytest.skip("native engine not built")
    L = 80
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, size=1000))
    step = 4
    tiled = [genome[p : p + L] for p in range(0, 1000 - L, step)]
    packed, lengths = packing.pack_strings(tiled)
    codes = packing.packed_to_codes(packed, L)
    cfg = supplement_retune(autotune(AssemblyConfig(error_rate=0.02), float(L)),
                            float(L))
    cfg = dataclasses.replace(cfg, min_offset_for_alignment=9)

    nt = len(tiled)
    M = 600
    r1 = rng.integers(0, nt - 8, M).astype(np.int64)
    d = rng.integers(1, 8, M)
    r2 = (r1 + d).astype(np.int64)
    off = (d * step).astype(np.int64)   # offsets 4..28 straddle min_off=9
    want = np_ach_batch(codes, lengths.astype(np.int64), r1, r2, off, cfg)
    got = native_mod.acler_batch_native(packed, lengths, r1, r2, off, cfg)
    np.testing.assert_array_equal(got, want)
    # the guard must actually bite: some offsets below 9 would otherwise pass
    cfg0 = dataclasses.replace(cfg, min_offset_for_alignment=0)
    want0 = np_ach_batch(codes, lengths.astype(np.int64), r1, r2, off, cfg0)
    assert want0.sum() > want.sum()
    got0 = native_mod.acler_batch_native(packed, lengths, r1, r2, off, cfg0)
    np.testing.assert_array_equal(got0, want0)


def test_banded_lcs_entry_is_xla_kernel(rng):
    """The production entry runs the XLA batch kernel on every backend; no
    hand-written DP kernel package remains."""
    import importlib.util

    codes, lengths, _ = _batch(rng, 20, 60)
    r1, r2, offs = _overlapping_pairs(rng, codes, lengths, 30, err=0.05)
    a = np.asarray(align.banded_lcs(codes, lengths, r1, r2, offs, 60, 2))
    b = np.asarray(align.banded_lcs_batch(codes, lengths, r1, r2, offs, 60, 2))
    np.testing.assert_array_equal(a, b)
    assert importlib.util.find_spec("alga_tpu.ops.pallas") is None


@pytest.mark.parametrize("E", [1, 3, 7, 8])
def test_banded_lcs_band_widths_ragged(rng, E):
    """XLA kernel == literal ACLCS transcription for several band
    half-widths over ragged read lengths."""
    seqs = ["".join("ACGT"[i] for i in rng.integers(0, 4, rng.integers(25, 61)))
            for _ in range(14)]
    # plant noisy overlaps so the LCS values are not all near-random
    for i in range(0, 14, 2):
        o = int(rng.integers(0, len(seqs[i]) // 2))
        tail = list(seqs[i][o:])
        for _e in range(2):
            tail[int(rng.integers(0, len(tail)))] = "ACGT"[int(rng.integers(0, 4))]
        seqs[i + 1] = "".join(tail) + seqs[i + 1][len(tail):]
    codes, lengths = packing.strings_to_codes(seqs)
    m = 36
    r1 = rng.integers(0, 14, m)
    r2 = rng.integers(0, 14, m)
    r1[: m // 2] = np.arange(0, 14, 2).repeat(3)[: m // 2]
    r2[: m // 2] = r1[: m // 2] + 1
    offs = np.array([int(rng.integers(0, max(1, lengths[a] - 10))) for a in r1])
    got = np.asarray(align.banded_lcs_batch(
        codes, lengths.astype(np.int64), r1, r2, offs, codes.shape[1], E))
    want = np.array([
        align.np_banded_lcs(codes, lengths, a, b, int(o), E)
        for a, b, o in zip(r1, r2, offs)])
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 3


def test_ach_batch_auto_device_lcs_branch(rng):
    """The device ACH branch with the LCS fallback on equals the numpy
    batch twin and the scalar ACH oracle."""
    import dataclasses

    from alga_tpu.config import AssemblyConfig, autotune
    from alga_tpu.utils.timers import counters_report, reset_counters

    L = 60
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, size=700))
    seqs = []
    for p in range(0, 700 - L, 6):
        s = list(genome[p : p + L])
        for _e in range(int(rng.integers(0, 3))):
            s[int(rng.integers(0, L))] = "ACGT"[int(rng.integers(0, 4))]
        seqs.append("".join(s))
    packed, lengths = packing.pack_strings(seqs)
    codes = packing.packed_to_codes(packed, L)
    cfg = autotune(AssemblyConfig(error_rate=0.02), float(L))
    cfg = dataclasses.replace(cfg, use_acler_instead_of_aclcs=False)
    n = len(seqs)
    M = 300
    r1 = rng.integers(0, n - 6, M).astype(np.int64)
    d = rng.integers(1, 6, M)
    r2 = r1 + d
    off = (d * 6 + rng.integers(-2, 3, M)).astype(np.int64)
    lengths64 = lengths.astype(np.int64)
    reset_counters()
    got = align.ach_batch_auto(packed, codes, lengths64, r1, r2, off, cfg,
                               min_device_batch=1)
    assert counters_report().get("ach_lcs_alignments", 0) > 0
    want = align.np_ach_batch(codes, lengths64, r1, r2, off, cfg)
    np.testing.assert_array_equal(got, want)
    oracle = np.array([align.np_ach_can_align(codes, lengths64, a, b, int(o), cfg)
                       for a, b, o in zip(r1, r2, off)])
    np.testing.assert_array_equal(got, oracle)
    assert want.any() and not want.all()
