"""Packed-bit comparison kernels (JAX) — the XOR/shift workhorse.

Replaces the reference's Bitset shift/XOR/ctz machinery used for
  * exact overlap verification (we verify every hash candidate; the
    reference trusts its double hash — ref GCPS.cpp:385-395),
  * the inline transitive-edge check (ref GCPS.cpp:434-451:
    A shifted by offsetDiff block-compared against B), and
  * the low-error mismatch counter ACLER (ref
    src/AlignmentControllers/AlignmentControllerLowErrorRate.cpp:15-49).

Layout: uint32 words, base i at bits (2*(i%16), +1) of word i//16
(see core/packing.py).  A "substring view" of read A starting at base s
is produced by a funnel shift of adjacent words — vectorized over a batch
of (a_id, a_start, b_id, length) queries, W words each, pure VPU work.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _pad_words(packed):
    """Append one zero word column so funnel shifts never index OOB."""
    n = packed.shape[0]
    return jnp.concatenate(
        [packed, jnp.zeros((n, 1), dtype=packed.dtype)], axis=1)


def _shifted_words(packed_pad, ids, start, w):
    """Word w of the 2-bit stream of read `ids` starting at base `start`."""
    sw = (start >> 4) + w                      # word index of low part
    sb = ((start & 15) * 2).astype(jnp.uint32)  # bit shift within word
    wmax = packed_pad.shape[1] - 1
    lo = packed_pad[ids, jnp.minimum(sw, wmax)]
    hi = packed_pad[ids, jnp.minimum(sw + 1, wmax)]
    # funnel shift; when sb == 0 the hi part must contribute nothing
    hi_part = jnp.where(sb == 0, jnp.uint32(0), hi << (32 - sb))
    return (lo >> sb) | hi_part


@partial(jax.jit, static_argnums=(5,))
def substr_equal(packed, a_ids, a_starts, b_ids, match_lens, num_words: int):
    """bool[M]: for each query, A[a_start + t] == B[t] for all t < match_len.

    num_words must be >= ceil(max(match_lens)/16) (static).
    """
    packed = packed.astype(jnp.uint32)
    packed_pad = _pad_words(packed)
    a_ids = a_ids.astype(jnp.int32)
    b_ids = b_ids.astype(jnp.int32)
    a_starts = a_starts.astype(jnp.int32)
    match_lens = match_lens.astype(jnp.int32)

    ok = jnp.ones(a_ids.shape[0], dtype=bool)
    for w in range(num_words):
        a_word = _shifted_words(packed_pad, a_ids, a_starts, w)
        b_word = packed_pad[b_ids, jnp.minimum(w, packed.shape[1] - 1)]
        diff = a_word ^ b_word
        # bases covered by this word: [16w, 16w+16); mask beyond match_len
        rem = jnp.clip(match_lens - 16 * w, 0, 16)
        mask = jnp.where(
            rem >= 16,
            jnp.uint32(0xFFFFFFFF),
            (jnp.uint32(1) << (rem.astype(jnp.uint32) * 2)) - jnp.uint32(1),
        )
        ok &= (diff & mask) == 0
    return ok


@partial(jax.jit, static_argnums=(5,))
def overlap_mismatch_count(packed, a_ids, a_starts, b_ids, match_lens,
                           num_words: int):
    """int32[M]: number of mismatching BASES between A[a_start+t] and B[t],
    t < match_len.  (XOR + popcount of base-level OR of both bits —
    device formulation of ref ACLER.cpp:29-36 which counts matched bases as
    overlap - popcount(xor)/2; we count mismatched bases directly:
    a base differs iff either of its two bits differs.)
    """
    packed = packed.astype(jnp.uint32)
    packed_pad = _pad_words(packed)
    a_ids = a_ids.astype(jnp.int32)
    b_ids = b_ids.astype(jnp.int32)
    a_starts = a_starts.astype(jnp.int32)
    match_lens = match_lens.astype(jnp.int32)

    total = jnp.zeros(a_ids.shape[0], dtype=jnp.int32)
    lo_mask = jnp.uint32(0x55555555)
    for w in range(num_words):
        a_word = _shifted_words(packed_pad, a_ids, a_starts, w)
        b_word = packed_pad[b_ids, jnp.minimum(w, packed.shape[1] - 1)]
        diff = a_word ^ b_word
        rem = jnp.clip(match_lens - 16 * w, 0, 16)
        mask = jnp.where(
            rem >= 16,
            jnp.uint32(0xFFFFFFFF),
            (jnp.uint32(1) << (rem.astype(jnp.uint32) * 2)) - jnp.uint32(1),
        )
        diff &= mask
        # collapse bit-pairs: base differs iff (diff | diff>>1) has low bit set
        per_base = (diff | (diff >> 1)) & lo_mask
        total += jax.lax.population_count(per_base).astype(jnp.int32)
    return total


# ----------------------------------------------------------------------------
# numpy oracles (for tests)

def np_substr_equal(codes, lengths, a_id, a_start, b_id, match_len) -> bool:
    a = codes[a_id, a_start : a_start + match_len]
    b = codes[b_id, :match_len]
    return bool(np.array_equal(a, b))


def np_mismatch_count(codes, a_id, a_start, b_id, match_len) -> int:
    a = codes[a_id, a_start : a_start + match_len]
    b = codes[b_id, :match_len]
    return int((a != b).sum())


# ----------------------------------------------------------------------------
# batched host twin + auto dispatch with shape-stable padding

def np_substr_equal_batch(codes, a_ids, a_starts, b_ids, match_lens):
    """Vectorized numpy twin of substr_equal over a base-code matrix."""
    a_ids = np.asarray(a_ids, dtype=np.int64)
    b_ids = np.asarray(b_ids, dtype=np.int64)
    a_starts = np.asarray(a_starts, dtype=np.int64)
    match_lens = np.asarray(match_lens, dtype=np.int64)
    m = len(a_ids)
    if m == 0:
        return np.zeros(0, dtype=bool)
    lmax = max(1, int(match_lens.max()))
    lpad = codes.shape[1]
    cols = np.arange(lmax, dtype=np.int64)[None, :]
    asrc = np.minimum(a_starts[:, None] + cols, lpad - 1)
    av = codes[a_ids[:, None], asrc]
    bv = codes[b_ids[:, None], np.minimum(cols, lpad - 1)]
    ok = (av == bv) | (cols >= match_lens[:, None])
    return ok.all(axis=1)


def _pad_pow2(arr, cap, fill=0):
    out = np.full(cap, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def substr_equal_auto(packed, codes, a_ids, a_starts, b_ids, match_lens,
                      num_words: int, min_device_batch: int = 200_000):
    """Backend dispatch for batched verification: numpy for small batches,
    device (padded to power-of-two batch so executables are reused) for
    large ones."""
    m = len(a_ids)
    if m == 0:
        return np.zeros(0, dtype=bool)
    if m < min_device_batch:
        if codes is None:
            from alga_tpu.core import packing
            codes = packing.packed_to_codes(packed)
        return np_substr_equal_batch(codes, a_ids, a_starts, b_ids, match_lens)
    cap = 1 << (m - 1).bit_length()
    a = _pad_pow2(np.asarray(a_ids, dtype=np.int32), cap)
    s = _pad_pow2(np.asarray(a_starts, dtype=np.int32), cap)
    b = _pad_pow2(np.asarray(b_ids, dtype=np.int32), cap)
    l = _pad_pow2(np.asarray(match_lens, dtype=np.int32), cap)
    ok = np.asarray(substr_equal(packed, a, s, b, l, num_words))
    return ok[:m]
