"""Alignment kernels for the error-tolerant path.

Ref: src/AlignmentControllers/:
  * ACLER (AlignmentControllerLowErrorRate.cpp:15-49) — the cheap
    XOR/popcount mismatch filter with same-ends requirement.
  * ACLCS (AlignmentControllerLCS.cpp:30-150) — banded LCS DP, band
    half-width E = MAX_ERROR_RATE_FOR_LCS (2), catching indels.
  * ACH (AlignmentControllerHybrid.cpp:46-86) — guard checks + dispatch
    (by default USE_ACLER_INSTEAD_OF_ACLCS=1: an ACLER reject is final).

Device versions are batched over M candidate pairs (the "Gcells/s"
kernel target); scalar host versions mirror the reference loop for the
sequential PKB supplement and for differential testing.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from alga_tpu.ops.bitops import _pad_words, _shifted_words


# ---------------------------------------------------------------------------
# ACLER — batched device kernel

@partial(jax.jit, static_argnums=(5, 6, 7, 8))
def acler_batch(packed, lengths, r1, r2, offsets, num_words: int,
                max_offset_percent: int, min_overlap_area: int,
                min_overlap_for_lcs_low_error: int,
                same_ends_length: int = 3):
    """bool[M]: replicates ACLER.canAlign for pairs (r1[i], r2[i], offset).

    Counting note (ref ACLER.cpp:29-36): matched = overlap - popcount(xor
    over the overlap BITS)/2 — bit-level, not base-level; a 1-bit base
    difference costs only half a mismatch after the shift.  The same-ends
    check covers bit range [0, 2*SEL] inclusive at the front (2*SEL+1
    bits — a reference quirk we replicate) and [2*(ov-SEL), 2*ov-1] at the
    back.
    """
    packed = packed.astype(jnp.uint32)
    packed_pad = _pad_words(packed)
    lengths = lengths.astype(jnp.int32)
    r1 = r1.astype(jnp.int32)
    r2 = r2.astype(jnp.int32)
    offsets = offsets.astype(jnp.int32)

    len1 = lengths[r1]
    len2 = lengths[r2]
    overlap = jnp.minimum(len1, len2 + offsets) - offsets

    ok_guard = (100 * offsets <= max_offset_percent * len1) & \
               (overlap >= min_overlap_area) & (offsets >= 0)

    # bit-level XOR of r1 shifted by `offset` bases against r2, over the
    # overlap region; also track the front/back same-ends windows.
    bitdiff = jnp.zeros(r1.shape[0], dtype=jnp.int32)
    front_bits = jnp.zeros(r1.shape[0], dtype=jnp.int32)
    back_bits = jnp.zeros(r1.shape[0], dtype=jnp.int32)

    ov_bits = (overlap * 2).astype(jnp.int32)
    sel = same_ends_length
    front_hi = 2 * sel               # inclusive bit index (ref quirk)
    back_lo = ov_bits - 2 * sel

    for w in range(num_words):
        a_word = _shifted_words(packed_pad, r1, offsets, w)
        b_word = packed_pad[r2, jnp.minimum(w, packed.shape[1] - 1)]
        diff = a_word ^ b_word
        base_bit = 32 * w
        # mask to bits < ov_bits
        rem = jnp.clip(ov_bits - base_bit, 0, 32)
        mask = jnp.where(rem >= 32, jnp.uint32(0xFFFFFFFF),
                         (jnp.uint32(1) << rem.astype(jnp.uint32)) - 1)
        mdiff = diff & mask
        bitdiff += jax.lax.population_count(mdiff).astype(jnp.int32)

        # front window bits [0, front_hi] inclusive
        fr = jnp.clip(front_hi + 1 - base_bit, 0, 32)
        fmask = jnp.where(fr >= 32, jnp.uint32(0xFFFFFFFF),
                          (jnp.uint32(1) << fr.astype(jnp.uint32)) - 1)
        front_bits += jax.lax.population_count(mdiff & fmask).astype(jnp.int32)

        # back window bits [back_lo, ov_bits): mdiff already excludes
        # >= ov_bits, so just cut bits below back_lo
        lowcut = jnp.clip(back_lo - base_bit, 0, 32)
        bmask = jnp.where(lowcut >= 32, jnp.uint32(0),
                          jnp.uint32(0xFFFFFFFF) << lowcut.astype(jnp.uint32))
        back_bits += jax.lax.population_count(mdiff & bmask).astype(jnp.int32)

    seq_overlap = (ov_bits - bitdiff) >> 1
    same_ends = (front_bits == 0) & (back_bits == 0)
    accept = 100 * seq_overlap >= min_overlap_for_lcs_low_error * overlap
    return ok_guard & same_ends & accept


# ---------------------------------------------------------------------------
# banded LCS — batched device kernel (lax.scan over rows, band width 2E+1)

@partial(jax.jit, static_argnums=(5, 6))
def banded_lcs_batch(codes, lengths, r1, r2, offsets, max_len: int, E: int = 2):
    """int32[M]: LCS of the banded region, replicating ACLCS::calculateLCS
    (ref AlignmentControllerLCS.cpp:61-150): rows p in [max(0, offset-E),
    len1), band q in [p-offset-E, p-offset+E] clipped to [0, len2); result
    cell p* = min(len1-1, len2-1+offset), q* = min(len2-1, p*-offset+E).

    codes: uint8[N, L] base codes (unpacked).  Each band row is updated
    with the classic LCS recurrence; within-row dependency is unrolled
    over the 2E+1 diagonals.
    """
    codes = codes.astype(jnp.int32)
    lengths = lengths.astype(jnp.int32)
    r1 = r1.astype(jnp.int32)
    r2 = r2.astype(jnp.int32)
    offsets = offsets.astype(jnp.int32)

    M = r1.shape[0]
    B = 2 * E + 1
    len1 = lengths[r1]
    len2 = lengths[r2]
    p_beg = jnp.maximum(0, offsets - E)

    c1 = codes[r1]   # [M, L]
    c2 = codes[r2]

    # result cell (ref :128-150): p* = min(len1-1, len2-1+offset);
    # q* = min(len2-1, p*-offset+E).  Freeze the scan carry past p* so the
    # final carry IS row p*.
    p_star = jnp.minimum(len1 - 1, len2 - 1 + offsets)
    q_star = jnp.minimum(len2 - 1, p_star - offsets + E)

    def row_step(carry, p):
        prev = carry                       # [M, B]: prev[e] = L[p-1][q(e)]
        q_of = p - offsets[:, None] + jnp.arange(-E, E + 1)[None, :]  # [M, B]
        in_row = (p >= p_beg) & (p <= p_star) & (p < len1)
        q_valid = (q_of >= 0) & (q_of < len2[:, None]) & in_row[:, None]

        a = jnp.take_along_axis(
            c1, jnp.full((M, 1), 0, jnp.int32) + jnp.clip(p, 0, max_len - 1),
            axis=1)[:, 0]
        b = jnp.take_along_axis(c2, jnp.clip(q_of, 0, max_len - 1), axis=1)
        match = (a[:, None] == b) & q_valid

        # prev[e] = L[p-1][q-1] (diag), prev_up[e] = L[p-1][q] = prev[e+1]
        prev_up = jnp.concatenate(
            [prev[:, 1:], jnp.zeros((M, 1), jnp.int32)], axis=1)

        left = jnp.zeros(M, dtype=jnp.int32)   # L[p][q-1] running value
        cols = []
        for e in range(B):
            diag = prev[:, e]
            up = prev_up[:, e]
            val = jnp.where(match[:, e], diag + 1, jnp.maximum(up, left))
            val = jnp.where(q_valid[:, e], val, 0)
            left = val
            cols.append(val)
        new = jnp.stack(cols, axis=1)
        out = jnp.where(in_row[:, None], new, prev)
        return out, None

    init = jnp.zeros((M, B), dtype=jnp.int32)
    final, _ = jax.lax.scan(row_step, init, jnp.arange(max_len, dtype=jnp.int32))

    e_star = jnp.clip(q_star - (p_star - offsets) + E, 0, B - 1)
    return final[jnp.arange(M), e_star]


def banded_lcs(codes, lengths, r1, r2, offsets, max_len: int, E: int = 2):
    """Production entry of the banded-LCS fallback: the XLA batch kernel
    on every backend."""
    return banded_lcs_batch(codes, lengths, r1, r2, offsets, max_len, E)


# ---------------------------------------------------------------------------
# batched ACH (guards + ACLER [+ banded LCS fallback]) with host/device
# dispatch — the production verifier for the LI/PKB supplement
# (ref ACHybrid.cpp:46-86 semantics over M pairs at once).

def np_ach_batch(codes, lengths, r1, r2, offsets, cfg,
                 chunk: int = 1 << 18) -> np.ndarray:
    """bool[M]: vectorized numpy twin of np_ach_can_align over pairs."""
    r1 = np.asarray(r1, dtype=np.int64)
    r2 = np.asarray(r2, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    m = len(r1)
    out = np.zeros(m, dtype=bool)
    for a in range(0, m, chunk):
        b = min(a + chunk, m)
        out[a:b] = _np_ach_chunk(codes, lengths, r1[a:b], r2[a:b],
                                 offsets[a:b], cfg)
    return out


def _np_ach_chunk(codes, lengths, r1, r2, offsets, cfg):
    len1 = lengths[r1]
    len2 = lengths[r2]
    ok = 100 * offsets <= cfg.max_offset_considered_for_alignment * len1
    ok &= offsets >= cfg.min_offset_for_alignment
    overlap = np.minimum(len1, len2 + offsets) - offsets
    ok &= overlap >= cfg.min_overlap_area
    ok &= (len2 + offsets - len1) >= 0
    if not ok.any():
        return ok

    lpad = codes.shape[1]
    ovmax = int(np.where(ok, overlap, 0).max())
    cols = np.arange(ovmax, dtype=np.int64)[None, :]
    av = codes[r1[:, None], np.minimum(offsets[:, None] + cols, lpad - 1)]
    bv = codes[r2[:, None], np.minimum(cols, lpad - 1)]
    in_ov = cols < overlap[:, None]
    x = (av ^ bv).astype(np.uint8)
    x = np.where(in_ov, x, 0)
    # bit-level diff count (ref ACLER.cpp:29-36)
    bitdiff = ((x & 1) + (x >> 1)).sum(axis=1, dtype=np.int64)
    seq_overlap = (2 * overlap - bitdiff) >> 1

    sel = cfg.alignment_controller_same_ends_length
    front_bad = ((x != 0) & (cols < sel)).any(axis=1)
    # the front window covers bit [0, 2*sel] inclusive: the low bit of base
    # `sel` also participates (reference quirk, ref ACLER.cpp:42-45)
    if ovmax > sel:
        front_bad |= ((x[:, sel] & 1) != 0) & (overlap > sel)
    back_bad = ((x != 0) & (cols >= (overlap - sel)[:, None])).any(axis=1)

    acler = ok & ~front_bad & ~back_bad & \
        (100 * seq_overlap >= cfg.minimal_overlap_for_lcs_low_error * overlap)

    if cfg.use_acler_instead_of_aclcs:
        return acler

    # banded-LCS fallback for ACLER rejects (ref ACHybrid.cpp:64-75)
    need = ok & ~acler
    if need.any():
        idx = np.flatnonzero(need)
        max_len = codes.shape[1]
        lcs = np.asarray(banded_lcs(
            jnp.asarray(codes), jnp.asarray(lengths.astype(np.int32)),
            jnp.asarray(r1[idx].astype(np.int32)),
            jnp.asarray(r2[idx].astype(np.int32)),
            jnp.asarray(offsets[idx].astype(np.int32)),
            max_len, cfg.max_error_rate_for_lcs))
        acler[idx] = 100 * lcs > cfg.minimal_overlap_rate_for_lcs * overlap[idx]
    return acler


def ach_batch_auto(packed, codes, lengths, r1, r2, offsets, cfg,
                   min_device_batch: int = 200_000) -> np.ndarray:
    """bool[M]: ACH over pairs with backend dispatch — numpy twin for small
    batches, the XLA device kernels (padded to a power-of-two batch
    so compiled executables are reused) for large ones."""
    from alga_tpu.utils.timers import bump
    m = len(r1)
    bump("ach_total_alignments", m)     # ref ACHybrid.h:31-36 counters
    if m == 0:
        return np.zeros(0, dtype=bool)
    if m < min_device_batch or packed is None:
        if packed is not None and cfg.use_acler_instead_of_aclcs:
            # native packed ACLER (the error path's hot verifier): popcount
            # over funnel-shifted words, no code-matrix unpack at all
            from alga_tpu import native as _native
            if _native.available():
                return _native.acler_batch_native(
                    np.asarray(packed), lengths, r1, r2, offsets, cfg)
        if codes is None:
            # unpack only the rows this batch touches (memory diet)
            from alga_tpu.core import packing
            uniq, inv = np.unique(np.concatenate([r1, r2]),
                                  return_inverse=True)
            codes_sub = packing.packed_to_codes(np.asarray(packed)[uniq])
            lens_sub = np.asarray(lengths)[uniq]
            return np_ach_batch(codes_sub, lens_sub, inv[:m], inv[m:],
                                offsets, cfg)
        return np_ach_batch(codes, lengths, r1, r2, offsets, cfg)

    from alga_tpu.ops.bitops import _pad_pow2
    bump("ach_device_batches")
    cap = 1 << (m - 1).bit_length()
    r1p = _pad_pow2(np.asarray(r1, dtype=np.int32), cap)
    r2p = _pad_pow2(np.asarray(r2, dtype=np.int32), cap)
    # pad offsets with -1 so padded lanes fail the offsets>=0 guard
    op = _pad_pow2(np.asarray(offsets, dtype=np.int32), cap, fill=-1)
    num_words = packed.shape[1]
    acler = np.asarray(acler_batch(
        packed, np.asarray(lengths, dtype=np.int32), r1p, r2p, op, num_words,
        cfg.max_offset_considered_for_alignment, cfg.min_overlap_area,
        cfg.minimal_overlap_for_lcs_low_error,
        cfg.alignment_controller_same_ends_length))[:m]

    lengths = np.asarray(lengths, dtype=np.int64)
    r1 = np.asarray(r1, dtype=np.int64)
    r2 = np.asarray(r2, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)
    len1 = lengths[r1]
    len2 = lengths[r2]
    # ACH-level guards the device ACLER kernel does not apply
    guards = (offsets >= cfg.min_offset_for_alignment) & \
             (len2 + offsets - len1 >= 0)
    ok = acler & guards
    bump("ach_low_error_approved", int(ok.sum()))
    if cfg.use_acler_instead_of_aclcs:
        return ok

    overlap = np.minimum(len1, len2 + offsets) - offsets
    full_guard = guards & (100 * offsets <= cfg.max_offset_considered_for_alignment * len1) & \
        (overlap >= cfg.min_overlap_area)
    need = full_guard & ~ok
    if need.any():
        bump("ach_lcs_alignments", int(need.sum()))
        if codes is None:
            from alga_tpu.core import packing
            codes = packing.packed_to_codes(packed)
        idx = np.flatnonzero(need)
        max_len = codes.shape[1]
        lcs = np.asarray(banded_lcs(
            jnp.asarray(codes), jnp.asarray(lengths.astype(np.int32)),
            jnp.asarray(r1[idx].astype(np.int32)),
            jnp.asarray(r2[idx].astype(np.int32)),
            jnp.asarray(offsets[idx].astype(np.int32)),
            max_len, cfg.max_error_rate_for_lcs))
        ok[idx] = 100 * lcs > cfg.minimal_overlap_rate_for_lcs * overlap[idx]
    return ok


# ---------------------------------------------------------------------------
# host scalar oracles / sequential implementations (used by the PKB
# supplement oracle loop and tests)

def np_acler(codes, lengths, i1, i2, offset, *, max_offset_percent,
             min_overlap_area, min_overlap_for_lcs_low_error,
             same_ends_length=3) -> bool:
    len1, len2 = int(lengths[i1]), int(lengths[i2])
    if 100 * offset > max_offset_percent * len1:
        return False
    overlap = min(len1, len2 + offset) - offset
    if overlap < min_overlap_area:
        return False
    a = codes[i1, offset : offset + overlap].astype(np.int32)
    b = codes[i2, :overlap].astype(np.int32)
    # bit-level difference count
    x = a ^ b
    bitdiff = int((x & 1).sum() + ((x >> 1) & 1).sum())
    seq_overlap = (2 * overlap - bitdiff) >> 1
    sel = same_ends_length
    # front window: bits [0, 2*sel] inclusive = sel bases + low bit of base sel
    front = a[:sel] != b[:sel]
    extra_bit = ((a[sel] ^ b[sel]) & 1) if overlap > sel else 0
    if front.any() or extra_bit:
        return False
    if (a[overlap - sel:] != b[overlap - sel:]).any():
        return False
    return 100 * seq_overlap >= min_overlap_for_lcs_low_error * overlap


def np_banded_lcs(codes, lengths, i1, i2, offset, E=2) -> int:
    """Literal transcription of ACLCS::calculateLCS."""
    len1, len2 = int(lengths[i1]), int(lengths[i2])
    table: dict[tuple[int, int], int] = {}
    p_beg = max(0, offset - E)
    for p in range(p_beg, len1):
        q_beg = max(0, p - offset - E)
        q_end = min(len2 - 1, p - offset + E)
        for q in range(q_beg, q_end + 1):
            if codes[i1, p] == codes[i2, q]:
                table[(p, q)] = table.get((p - 1, q - 1), 0) + 1
            else:
                table[(p, q)] = max(table.get((p - 1, q), 0),
                                    table.get((p, q - 1), 0))
    p = min(len1 - 1, len2 - 1 + offset)
    q = min(len2 - 1, p - offset + E)
    return table.get((p, q), 0)


def np_ach_can_align(codes, lengths, i1, i2, offset, cfg) -> bool:
    """ACH::canAlign guards + dispatch (ref ACHybrid.cpp:46-86)."""
    len1, len2 = int(lengths[i1]), int(lengths[i2])
    if 100 * offset > cfg.max_offset_considered_for_alignment * len1:
        return False
    if offset < cfg.min_offset_for_alignment:
        return False
    overlap = min(len1, len2 + offset) - offset
    if overlap < cfg.min_overlap_area:
        return False
    if len2 + offset - len1 < 0:
        return False
    if np_acler(codes, lengths, i1, i2, offset,
                max_offset_percent=cfg.max_offset_considered_for_alignment,
                min_overlap_area=cfg.min_overlap_area,
                min_overlap_for_lcs_low_error=cfg.minimal_overlap_for_lcs_low_error,
                same_ends_length=cfg.alignment_controller_same_ends_length):
        return True
    if cfg.use_acler_instead_of_aclcs:
        return False
    lcs = np_banded_lcs(codes, lengths, i1, i2, offset, cfg.max_error_rate_for_lcs)
    return 100 * lcs > cfg.minimal_overlap_rate_for_lcs * overlap


def ach_batch_mesh(mesh, packed, lengths, r1, r2, offsets, cfg) -> np.ndarray:
    """bool[M]: ACH verification SHARDED over the mesh (no reference
    counterpart — SURVEY §2.10): pairs split on the 'r' axis via
    shard_map, the packed store replicated on every device, results
    all-gathered.  ACLER-only configuration (the supplement's retuned
    default, use_acler_instead_of_aclcs=True); callers with the LCS
    fallback enabled must use ach_batch_auto."""
    import jax
    from functools import partial
    from jax.sharding import PartitionSpec as P

    assert cfg.use_acler_instead_of_aclcs, \
        "mesh ACH path is ACLER-only (the supplement's live configuration)"
    from alga_tpu.utils.timers import bump
    m = len(r1)
    bump("ach_total_alignments", m)
    if m == 0:
        return np.zeros(0, dtype=bool)
    d = int(mesh.devices.size)
    # pad to a multiple of d (plus lane quantum) with offset -1 lanes that
    # fail the offsets >= 0 guard
    q = d * 128
    cap = -(-m // q) * q
    r1p = np.zeros(cap, dtype=np.int32)
    r2p = np.zeros(cap, dtype=np.int32)
    op = np.full(cap, -1, dtype=np.int32)
    r1p[:m] = r1
    r2p[:m] = r2
    op[:m] = offsets
    num_words = packed.shape[1]
    lengths32 = np.asarray(lengths, dtype=np.int32)

    @partial(jax.shard_map, mesh=mesh, check_vma=False,
             in_specs=(P(), P(), P("r"), P("r"), P("r")), out_specs=P("r"))
    def step(packed_l, lens_l, a, b, o):
        return acler_batch(
            packed_l, lens_l, a, b, o, num_words,
            cfg.max_offset_considered_for_alignment, cfg.min_overlap_area,
            cfg.minimal_overlap_for_lcs_low_error,
            cfg.alignment_controller_same_ends_length)

    import jax.numpy as jnp
    acler = np.asarray(step(jnp.asarray(packed), jnp.asarray(lengths32),
                            jnp.asarray(r1p), jnp.asarray(r2p),
                            jnp.asarray(op)))[:m]
    lengths = np.asarray(lengths, dtype=np.int64)
    len1 = lengths[np.asarray(r1, dtype=np.int64)]
    len2 = lengths[np.asarray(r2, dtype=np.int64)]
    offsets = np.asarray(offsets, dtype=np.int64)
    guards = (offsets >= cfg.min_offset_for_alignment) & \
             (len2 + offsets - len1 >= 0)
    ok = acler & guards
    bump("ach_low_error_approved", int(ok.sum()))
    return ok
