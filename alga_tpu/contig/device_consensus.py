"""Per-column SNP consensus on device (VERDICT r3 item 8).

Ref Contig::correctSnipsInContig (src/DataStructures/Contig.cpp:33-92):
majority vote per contig column over the contained reads, ties toward the
smallest base code, then trim both ends while column support <= 3.

SURVEY §7.1 item 6 calls this "a perfect segment_sum fit": here the whole
pass is three jitted stages over the CONCATENATED column space of every
contig —

  1. voting: read chunks are unpacked from the 2-bit store on device
     (select chains over the word axis, no host code matrix) and their
     votes land in a donated (G, 4) count matrix via one scatter-add per
     chunk;
  2. decision: argmax per column (first-max == lowest code, the
     reference's max_element tie rule) + support mask;
  3. trim bounds: per-contig first/last supported column via masked
     scatter-min/max keyed by a cumsum'd contig-id map.

Only the decided base row (uint8[G]) and the per-contig (p, q) bounds
cross device->host; the host assembles the final strings.  Bit-identical
to contig/consensus.correct_all (the oracle) — tests/test_contig.py.

ROUTING DECISION: the consensus pass is a small share of end-to-end
wall time on the native host engine, and no measurement has favoured
this path yet.  It stays OPT-IN (ALGA_DEVICE_CONSENSUS=1),
bit-parity-tested, as the building block a multi-host deployment (store
device-resident, contigs sharded, no host engine on the hosts) would
route to.  The production default is the host native engine everywhere;
its GPU cost is not measured yet.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from alga_tpu.contig.consensus import COVERAGE_TRIM_THRESHOLD

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@partial(jax.jit, static_argnums=(5, 6), donate_argnums=(4,))
def _vote_chunk(packed, ids_c, start_c, len_c, counts, L: int, G: int):
    """Scatter the votes of one read chunk into counts int32[G, 4].

    ids_c/start_c/len_c: int32[CR] (SENT rows have len 0).  L = padded
    read length (16 * W)."""
    W = packed.shape[1]
    rows = packed[jnp.clip(ids_c, 0, packed.shape[0] - 1)]   # [CR, W]
    # unpack [CR, L]: base t of row = (word[t>>4] >> 2*(t&15)) & 3
    t = jnp.arange(L, dtype=jnp.int32)
    words = rows[:, t >> 4]                                   # [CR, L]
    codes = (words >> ((t & 15).astype(jnp.uint32) * 2)[None, :]) & 3
    live = t[None, :] < len_c[:, None]
    pos = start_c[:, None] + t[None, :]
    flat = jnp.where(live, pos * 4 + codes.astype(jnp.int32), 4 * G)
    return counts.at[flat.ravel()].add(1, mode="drop")


@partial(jax.jit, static_argnums=(2,))
def _decide_trim(counts_flat, ctg_starts_marks, NC: int):
    """(best uint8[G], p int32[NC], q int32[NC], empty bool[NC])."""
    G = counts_flat.shape[0] // 4
    counts = counts_flat.reshape(G, 4)
    best = jnp.argmax(counts, axis=1).astype(jnp.uint8)  # first-max tie
    freqs = jnp.max(counts, axis=1)
    ok = freqs > COVERAGE_TRIM_THRESHOLD

    ctg_of = jnp.cumsum(ctg_starts_marks) - 1            # int32[G]
    col = jnp.arange(G, dtype=jnp.int32)
    tgt = jnp.where(ok, ctg_of, NC)
    p = jnp.full(NC, jnp.int32(0x7FFFFFFF)).at[tgt].min(col, mode="drop")
    q = jnp.full(NC, jnp.int32(-1)).at[tgt].max(col, mode="drop")
    return best, p, q, q < 0


def correct_all_device(contigs, batch, chunk_reads: int = 1 << 20) -> None:
    """Device twin of contig/consensus.correct_all (bit-identical)."""
    if not contigs:
        return
    lengths = batch.lengths.astype(np.int64)

    ctg_total = np.zeros(len(contigs), dtype=np.int64)
    all_ids, all_starts, all_ctg = [], [], []
    for ci, c in enumerate(contigs):
        offs = np.array([0] + [off for _, off in c.reads[1:]], dtype=np.int64)
        starts = np.cumsum(offs)
        ids = np.array([rid for rid, _ in c.reads], dtype=np.int64)
        ctg_total[ci] = starts[-1] + lengths[ids[-1]]
        all_ids.append(ids)
        all_starts.append(starts)
        all_ctg.append(np.full(len(ids), ci, dtype=np.int64))
    ids = np.concatenate(all_ids)
    starts = np.concatenate(all_starts)
    ctg_of = np.concatenate(all_ctg)

    ctg_base = np.zeros(len(contigs) + 1, dtype=np.int64)
    np.cumsum(ctg_total, out=ctg_base[1:])
    G = int(ctg_base[-1])
    assert 4 * G < (1 << 31), "device consensus: column space over int32"

    lens_c = np.minimum(lengths[ids], ctg_total[ctg_of] - starts)
    lens_c = np.maximum(lens_c, 0)
    abs_start = (ctg_base[ctg_of] + starts).astype(np.int32)

    packed_d = jnp.asarray(np.asarray(batch.packed))
    L = 16 * batch.packed.shape[1]
    counts = jnp.zeros(4 * G + 1, dtype=jnp.int32)
    R = len(ids)
    CR = min(chunk_reads, max(1, R))
    for i in range(0, R, CR):
        sl = slice(i, i + CR)
        ids_c = np.full(CR, 0, dtype=np.int32)
        st_c = np.zeros(CR, dtype=np.int32)
        ln_c = np.zeros(CR, dtype=np.int32)
        m = min(CR, R - i)
        ids_c[:m] = ids[sl]
        st_c[:m] = abs_start[sl]
        ln_c[:m] = lens_c[sl]
        counts = _vote_chunk(packed_d, jnp.asarray(ids_c),
                             jnp.asarray(st_c), jnp.asarray(ln_c),
                             counts, L, G)

    # marks COUNT contig starts per column (empty contigs collapse onto
    # the next start and must still advance the cumsum'd contig id)
    marks = np.bincount(ctg_base[:-1][ctg_base[:-1] < G],
                        minlength=max(G, 1)).astype(np.int32)[:G]
    best, p, q, empty = _decide_trim(counts[: 4 * G],
                                     jnp.asarray(marks), len(contigs))
    best_h = np.asarray(best)
    p_h, q_h, e_h = np.asarray(p), np.asarray(q), np.asarray(empty)

    from alga_tpu.utils.timers import sample_memory
    sample_memory("consensus_device", log=False)

    for ci, c in enumerate(contigs):
        if e_h[ci]:
            c.seq = ""
            continue
        c.seq = _BASES[best_h[p_h[ci] : q_h[ci] + 1]].tobytes().decode(
            "ascii")
