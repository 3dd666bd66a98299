"""Device-side candidate join for the overlap sweep.

Replaces the host sort-join in graph/prefsuf.py for large batches: window
keys never leave the device, and only the compacted surviving matches
(src, dst, ell) are transferred.  This reduces device→host traffic from
O(N * windows) keys to O(matches) — the difference between ~3.5 GB and
~100 MB at E. coli scale (SURVEY.md §7.3-4).

Join direction favours sorts over gathers: a device sort of all window keys
is cheaper than as many gather-heavy binary-search probes, so we SORT the
big side (all windows of all reads) and binary-search the small side (one
prefix key per read) into it — the reverse of the textbook
build-on-small-side hash join, and of the reference's bucket design
(ref GraphCreatorPrefSuf.cpp:41-48 buckets the prefixes and probes
suffixes).  Candidate expansion is a scatter+cumsum segmented iota, not a
searchsorted, for the same reason.

Capacities are rounded to multiples of 64Ki so executables are reused
across similarly-sized chunks without paying power-of-two padding waste.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from alga_tpu.core import packing
from alga_tpu.ops import hashes
from alga_tpu.ops.bitops import _pad_words, _shifted_words


def _word_at(rows, idx):
    """rows[m, idx[m]] for u32 rows[M, Wp] with a per-row word index — a
    select chain over the (small, static) word axis instead of an element
    gather (Wp elementwise selects, fused by XLA)."""
    out = jnp.zeros(rows.shape[0], dtype=jnp.uint32)
    for w in range(rows.shape[1]):
        out = jnp.where(idx == w, rows[:, w], out)
    return out


def _substr_eq_rows(rows_a, start, rows_b, match_len, num_words: int):
    """bool[M]: A[start+t] == B[t] for t < match_len, operating on
    PREFETCHED padded rows (one cheap row gather upstream replaces
    3*num_words element gathers here)."""
    wa = rows_a.shape[1] - 1
    wb = rows_b.shape[1] - 1
    sb = ((start & 15) * 2).astype(jnp.uint32)
    sw0 = start >> 4
    ml = match_len.astype(jnp.int32)
    eq = jnp.ones(rows_a.shape[0], dtype=bool)
    for w in range(num_words):
        lo = _word_at(rows_a, jnp.minimum(sw0 + w, wa))
        hi = _word_at(rows_a, jnp.minimum(sw0 + w + 1, wa))
        a_word = (lo >> sb) | jnp.where(sb == 0, jnp.uint32(0),
                                        hi << (32 - sb))
        b_word = rows_b[:, min(w, wb - 1)]
        diff = a_word ^ b_word
        rem = jnp.clip(ml - 16 * w, 0, 16)
        mask = jnp.where(rem >= 16, jnp.uint32(0xFFFFFFFF),
                         (jnp.uint32(1) << (rem.astype(jnp.uint32) * 2)) - 1)
        eq &= (diff & mask) == 0
    return eq


@partial(jax.jit, static_argnums=(4, 5, 6))
def _keys_and_counts(packed, lengths, af, at, k: int, num_windows: int,
                     cap: int):
    """Stage 1: hash all windows, sort window keys, count candidates/read.

    A window (B, p) is a live suffix-side candidate iff
      p + k <= len_B           (window in range)
      af[B]                    (read participates as source)
      p >= len_B - cap         (overlap ell = len_B - p <= cap)
    Invalid windows get sentinel key 0xFFFFFFFF; any spurious sentinel
    matches are re-checked and dropped in stage 2.
    """
    k1, k2, valid = hashes.window_kmer_keys_u32(packed, lengths, k, num_windows)
    lengths = lengths.astype(jnp.int32)

    pos = jnp.arange(num_windows, dtype=jnp.int32)[None, :]
    wvalid = valid & af[:, None] & (pos >= (lengths[:, None] - cap))
    wkeys = jnp.where(wvalid, k1, jnp.uint32(0xFFFFFFFF)).ravel()

    worder = jnp.argsort(wkeys).astype(jnp.int32)
    wkeys_sorted = wkeys[worder]

    # prefix side: one key per read (window 0), probed into the sorted
    # window keys — n probes, not n*num_windows
    pvalid = (lengths >= k) & at
    pk1 = k1[:, 0]
    lo = jnp.searchsorted(wkeys_sorted, pk1, side="left").astype(jnp.int32)
    hi = jnp.searchsorted(wkeys_sorted, pk1, side="right").astype(jnp.int32)
    counts = jnp.where(pvalid, hi - lo, 0)
    total = counts.sum()
    # k2 is not needed: every candidate is verified by exact packed compare
    # (the reference trusts its double hash instead, GCPS.cpp:385-387)
    return worder, lo, counts, total, pvalid


@partial(jax.jit, static_argnums=(7, 8, 9, 10, 11))
def _expand_verify(packed, lengths, worder, lo, counts,
                   pvalid, af, num_windows: int, k: int, cap: int,
                   C: int, num_words: int):
    """Stage 2: materialize up to C candidates, verify, compact.

    Candidate t belongs to prefix-read Cid = segment of t under counts;
    its window is worder[lo[Cid] + rank(t)] = (B, p); the claimed overlap
    is B[p : len_B] == Cid[0 : ell], ell = len_B - p.
    """
    n = packed.shape[0]
    lengths = lengths.astype(jnp.int32)

    csum = jnp.cumsum(counts)
    total = csum[-1]
    csum_ex = csum - counts            # exclusive prefix sum, int32[n]

    # segmented iota: j[t] = rank (among reads with counts>0) of the read
    # whose candidate block holds t; nz_ids maps that rank back to the
    # read id (reads with zero candidates occupy no block)
    marks = jnp.zeros(C, dtype=jnp.int32)
    marks = marks.at[jnp.where(counts > 0, csum_ex, C)].add(1, mode="drop")
    j = jnp.cumsum(marks) - 1                       # int32[C], -1 before 1st
    t = jnp.arange(C, dtype=jnp.int32)
    in_range = (t < total) & (j >= 0)
    nz_rank = jnp.cumsum((counts > 0).astype(jnp.int32)) - 1
    nz_ids = jnp.zeros(n, dtype=jnp.int32).at[
        jnp.where(counts > 0, nz_rank, n)].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")
    Cid = nz_ids[jnp.clip(j, 0, n - 1)]

    rank = t - csum_ex[Cid]
    widx = jnp.clip(lo[Cid] + rank, 0, worder.shape[0] - 1)
    win = worder[widx]
    B = (win // num_windows).astype(jnp.int32)
    p = (win - B * num_windows).astype(jnp.int32)

    lenB = lengths[B]
    ell = lenB - p
    # window validity is re-checked here (not only via the sentinel key):
    # a read whose prefix key happens to equal the sentinel would otherwise
    # collect invalid windows — and an invalid window's ell <= 0 would make
    # the masked compare below vacuously true.
    ok = (in_range & pvalid[Cid] & (B != Cid) & (lengths[Cid] >= ell)
          & af[B]
          & (p + k <= lenB)              # window inside read B
          & (p >= lenB - cap))           # overlap ell <= cap

    # exact packed verification: B[p : p+ell] == Cid[0 : ell] — the two
    # packed rows are prefetched with ROW gathers (cheap) and the funnel
    # shift runs on the prefetched rows (select chain, no element gathers)
    packed_pad = _pad_words(packed.astype(jnp.uint32))
    rows_b = packed_pad[jnp.clip(B, 0, n - 1)]
    rows_c = packed_pad[jnp.clip(Cid, 0, n - 1)]
    ok &= _substr_eq_rows(rows_b, p, rows_c,
                          jnp.where(ok, ell, 0), num_words)

    # compact survivors to the front with a stable scatter
    nok = jnp.cumsum(ok.astype(jnp.int32))
    out_pos = jnp.where(ok, nok - 1, C)
    Bo = jnp.zeros(C, dtype=jnp.int32).at[out_pos].set(B, mode="drop")
    Co = jnp.zeros(C, dtype=jnp.int32).at[out_pos].set(Cid, mode="drop")
    Eo = jnp.zeros(C, dtype=jnp.int32).at[out_pos].set(ell, mode="drop")
    return Bo, Co, Eo, nok[-1]


def _round_cap(x: int, q: int = 1 << 16) -> int:
    return max(q, ((int(x) + q - 1) // q) * q)


# ---------------------------------------------------------------------------
# Device-side GCPS post-join: regime split, ring-buffer survivors, pair
# dedup, and domination pruning (the order-free reformulation documented in
# graph/prefsuf.py, ref GraphCreatorPrefSuf.cpp:397-483) — so only the final
# edge list leaves the device.  The C++ engine (native.gcps_from_matches)
# and the Python fallback remain the differential oracles.

_I32MAX = np.int32(0x7FFFFFFF)


@partial(jax.jit, static_argnums=(4, 5))
def _post_join_stage(B, Cd, E, lengths, rsoe: int, soes: int):
    """From padded match arrays (invalid entries have B == I32MAX) produce:
      pair arrays (psrc, pdst, pell, p_off, p_rs) sorted by (src, dst),
      regime-2 removers sorted by (dst, off) as (rsrc, rell, roff),
      per-pair domination-expansion counts and their total.

    Sort keys are PACKED into single uint32 keys (id * 1024 + small-field)
    so XLA's single/two-key sort path applies instead of a 3-key
    comparator sort.
    Requires ids < 2^22 and ell/off < 1024, guaranteed by the caller's
    routing guard (gcps_graph_device is only entered for short-read
    batches; larger graphs take the host or sharded paths).
    """
    Cap = B.shape[0]
    n = lengths.shape[0]
    lengths = lengths.astype(jnp.int32)
    SENTU = jnp.uint32(0xFFFFFFFF)
    valid = B != _I32MAX
    Bu = B.astype(jnp.uint32)
    Cu = Cd.astype(jnp.uint32)
    Eu = E.astype(jnp.uint32)

    # --- regime-1 ring survivors: per src, last `soes` matches with
    # ell < rsoe in canonical arrival order (ell asc, dst asc) -------------
    r1 = valid & (E < rsoe)
    k1 = jnp.where(r1, (Bu << 10) | Eu, SENTU)       # (src, ell)
    k2 = jnp.where(r1, Cu, SENTU)                    # dst tiebreak
    s1, s2 = jax.lax.sort((k1, k2), num_keys=2)
    s_srck = s1 >> 10
    t = jnp.arange(Cap, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones(1, bool), s_srck[1:] != s_srck[:-1]])
    gid = jnp.cumsum(is_start.astype(jnp.int32)) - 1
    glast = jnp.zeros(Cap, dtype=jnp.int32).at[gid].max(t)
    ring_keep = (s1 != SENTU) & (glast[gid] - t < soes)

    # --- pair instances = ring survivors + all regime-2 matches;
    # dedup by (src, dst) keeping max ell ----------------------------------
    r2 = valid & (E >= rsoe)
    i1 = jnp.concatenate([jnp.where(ring_keep, s_srck, SENTU),
                          jnp.where(r2, Bu, SENTU)])
    i2 = jnp.concatenate([jnp.where(ring_keep, (s2 << 10) | (s1 & 1023),
                                    SENTU),
                          jnp.where(r2, (Cu << 10) | Eu, SENTU)])
    p1, p2 = jax.lax.sort((i1, i2), num_keys=2)
    is_last = jnp.concatenate(
        [(p1[:-1] != p1[1:]) | ((p2[:-1] >> 10) != (p2[1:] >> 10)),
         jnp.ones(1, bool)])
    pair_valid = is_last & (p1 != SENTU)
    psrc = p1.astype(jnp.int32)
    pdst = (p2 >> 10).astype(jnp.int32)
    pell = (p2 & 1023).astype(jnp.int32)
    p_off = jnp.where(pair_valid,
                      lengths[jnp.clip(psrc, 0, n - 1)] - pell, 0)

    # --- removers: regime-2 matches keyed (dst, off) ascending ------------
    # (off = len_src - ell); only removers with offB <= offA can dominate a
    # pair (offA >= offB is part of the predicate, ref GCPS.cpp:414), so
    # with removers sorted by (dst, off) each pair's eligible removers are
    # a PREFIX of its dst run — counted by ONE binary search per pair.
    r_off = (lengths[jnp.clip(B, 0, n - 1)] - E).astype(jnp.uint32)
    rkey = jnp.where(r2, (Cu << 10) | r_off, SENTU)
    rk_s, rs, re_, ro = jax.lax.sort(
        (rkey, jnp.where(r2, Bu, SENTU),
         jnp.where(r2, Eu, SENTU), r_off), num_keys=1)
    rd_s = jnp.where(rk_s != SENTU, (rk_s >> 10).astype(jnp.int32), n)
    r_counts = jnp.zeros(n, dtype=jnp.int32).at[rd_s].add(1, mode="drop")
    r_start = jnp.cumsum(r_counts) - r_counts

    # eligible removers per pair: removers in the pair's dst group with
    # off <= offA (remover-first at equal off = side='right')
    pkey = jnp.where(pair_valid,
                     (pdst.astype(jnp.uint32) << 10)
                     | p_off.astype(jnp.uint32), SENTU)
    ub = jnp.searchsorted(rk_s, pkey, side="right").astype(jnp.int32)
    p_rs = r_start[jnp.clip(pdst, 0, n - 1)]
    cnt = jnp.where(pair_valid, ub - p_rs, 0)
    exp_total = cnt.sum()
    return (psrc, pdst, pell, p_off, p_rs, pair_valid,
            rs.astype(jnp.int32), re_.astype(jnp.int32),
            ro.astype(jnp.int32), cnt, exp_total)


@partial(jax.jit, static_argnums=(11, 12, 13))
def _dominate_and_compact(packed, psrc, pdst, pell, p_off, p_rs,
                          pair_valid, rs, re_, ro, cnt,
                          C3: int, num_words: int, CE: int = 0):
    """Expand (pair x same-dst regime-2 remover), apply the reference's
    domination predicate (ref GCPS.cpp:403-483 reformulated), compact the
    surviving edges (src, dst, offset) to the front.

    All per-slot pair/remover fields arrive via two ROW gathers of stacked
    matrices instead of 7 element gathers, and
    lengths are reconstructed as off + ell — no lengths[] gathers at all."""
    n = packed.shape[0]
    Cap = psrc.shape[0]

    csum = jnp.cumsum(cnt)
    total = csum[-1]
    csum_ex = csum - cnt

    marks = jnp.zeros(C3, dtype=jnp.int32)
    marks = marks.at[jnp.where(cnt > 0, csum_ex, C3)].add(1, mode="drop")
    j = jnp.cumsum(marks) - 1
    t = jnp.arange(C3, dtype=jnp.int32)
    in_range = (t < total) & (j >= 0)
    nz_rank = jnp.cumsum((cnt > 0).astype(jnp.int32)) - 1
    nz_ids = jnp.zeros(Cap, dtype=jnp.int32).at[
        jnp.where(cnt > 0, nz_rank, Cap)].set(
        jnp.arange(Cap, dtype=jnp.int32), mode="drop")
    pj = nz_ids[jnp.clip(j, 0, Cap - 1)]

    rank = t - csum_ex[pj]
    pmat = jnp.stack([psrc, pell, p_off, p_rs], axis=1)
    prow = pmat[pj]                                  # row gather [C3, 4]
    A = prow[:, 0]
    ellA = prow[:, 1]
    offA = prow[:, 2]
    lenA = offA + ellA

    ridx = jnp.clip(prow[:, 3] + rank, 0, rs.shape[0] - 1)
    rmat = jnp.stack([rs, re_, ro], axis=1)
    rrow = rmat[ridx]                                # row gather [C3, 3]
    Br = rrow[:, 0]
    ellB = rrow[:, 1]
    offB = rrow[:, 2]
    lenB = offB + ellB

    later = (ellB > ellA) | ((ellB == ellA) & (Br > A))
    cond = (in_range & later & (Br != A) & (offB > 0) & (offA >= offB)
            & (lenB + (offA - offB) - lenA >= 0))

    # A[offA-offB : offA] == B[0 : offB] on row-prefetched packed words
    packed_pad = _pad_words(packed.astype(jnp.uint32))
    rows_a = packed_pad[jnp.clip(A, 0, n - 1)]
    rows_b = packed_pad[jnp.clip(Br, 0, n - 1)]
    eq = _substr_eq_rows(rows_a, jnp.maximum(offA - offB, 0), rows_b,
                         jnp.where(cond, offB, 0), num_words)
    dominated = cond & eq

    removed = jnp.zeros(Cap, dtype=bool).at[
        jnp.where(dominated, pj, Cap)].set(True, mode="drop")

    keep = pair_valid & ~removed
    nkeep = jnp.cumsum(keep.astype(jnp.int32))
    out_pos = jnp.where(keep, nkeep - 1, Cap)
    # single interleaved output array -> ONE device->host transfer.
    # CE > 0 bounds the output at an edge-count capacity hint (overflow is
    # detected from the returned nkeep); edges past CE scatter out of range
    # and are dropped — +2 pad so a partial triple can't land in-bounds.
    E = CE if CE > 0 else Cap
    out_pos = jnp.where(out_pos < E, out_pos, E + 2)
    out = jnp.zeros(3 * E, dtype=jnp.int32)
    out = out.at[3 * out_pos].set(psrc, mode="drop")
    out = out.at[3 * out_pos + 1].set(pdst, mode="drop")
    out = out.at[3 * out_pos + 2].set(p_off, mode="drop")
    return out, nkeep[-1]


# capacity hints: (k, cap, rsoe, soes, n-bucket) -> (total, exp_total) of
# the last run.  With a hint the whole GCPS chain below executes as ONE
# dispatch (overflow checked on the result fetch) instead of four
# host-synchronized stages, each of which waits on a capacity scalar
# fetched from the device.  Hints persist in the jax compilation cache
# directory (jax_cache.cache_dir) so warm processes go single-dispatch
# immediately.
#
# Warm-state stability contract (the round-2 regression fix): capacities
# are ALWAYS derived from totals through the single function _caps(), and
# a GCPS call only returns once it has executed at the canonical
# _caps(actual totals) — so every warm run re-dispatches the exact same
# executable (in-process jit cache / persistent XLA cache hit), never a
# fresh compile inside a timed region.
_cap_hints: dict = {}
_hints_dirty = False


def _caps(total: int, exp_total: int, nkeep: int) -> tuple[int, int, int]:
    """Canonical capacity derivation (shared by every path): 1.25x headroom
    over the observed totals, rounded to the 64Ki executable-reuse quantum.
    The third capacity bounds the edge OUTPUT array — behind a slow link the
    result fetch is bandwidth-bound, so it is sized by the edge count, not
    by the pair capacity."""
    return (_round_cap(max(int(total), 1) * 5 // 4),
            _round_cap(max(int(exp_total), 1) * 5 // 4),
            _round_cap(max(int(nkeep), 1) * 5 // 4))


def _hints_path():
    import os

    from alga_tpu.jax_cache import cache_dir
    return os.path.join(cache_dir(), "gcps_cap_hints.json")


def _load_hints():
    import json
    try:
        with open(_hints_path()) as f:
            for k, v in json.load(f).items():
                if len(v) == 3:   # older 2-tuple hint files are ignored
                    _cap_hints[tuple(int(x) for x in k.split(","))] = tuple(v)
    except Exception:
        pass


def _save_hints():
    global _hints_dirty
    if not _hints_dirty:
        return
    import json
    import os
    try:
        path = _hints_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({",".join(str(x) for x in k): list(v)
                       for k, v in _cap_hints.items()}, f)
        os.replace(tmp, path)
        _hints_dirty = False
    except Exception:
        pass


def _update_hint(key, total: int, exp_total: int, nkeep: int):
    """Record observed totals; persist only when the derived capacities
    change (totals jitter within a 64Ki quantum costs no recompile, so
    rewriting the file for it would be pure churn)."""
    global _hints_dirty
    old = _cap_hints.get(key)
    _cap_hints[key] = (int(total), int(exp_total), int(nkeep))
    if old is None or _caps(*old) != _caps(total, exp_total, nkeep):
        _hints_dirty = True
        _save_hints()


_load_hints()


@partial(jax.jit, static_argnums=(4, 5, 6, 7, 8, 9, 10, 11, 12, 13))
def _gcps_fused(packed, lengths, af, at, k: int, num_windows: int, cap: int,
                rsoe: int, soes: int, C: int, C3: int, CE: int,
                W: int, W3: int):
    """All four GCPS stages chained under one jit with hinted capacities.
    Returns ONE int32 array [edges*3 ... nkeep, total, nok, exp_total] so a
    warm call is a single dispatch + a single device->host fetch; the
    caller retries exactly when total > C, exp_total > C3, or nkeep > CE."""
    worder, lo, counts, total, pvalid = _keys_and_counts(
        packed, lengths, af, at, k, num_windows, cap)
    Bv, Cv, Ev, nok = _expand_verify(
        packed, lengths, worder, lo, counts, pvalid, af,
        num_windows, k, cap, C, W)
    t = jnp.arange(C, dtype=jnp.int32)
    Bm = jnp.where(t < nok, Bv, _I32MAX)
    (psrc, pdst, pell, p_off, p_rs, pair_valid, rs, re_, ro, cnt,
     exp_total) = _post_join_stage(Bm, Cv, Ev, lengths, rsoe, soes)
    out, nkeep = _dominate_and_compact(
        packed, psrc, pdst, pell, p_off, p_rs, pair_valid, rs, re_, ro,
        cnt, C3, W3, CE)
    scal = jnp.stack([nkeep.astype(jnp.int32), total.astype(jnp.int32),
                      nok.astype(jnp.int32), exp_total.astype(jnp.int32)])
    return jnp.concatenate([out, scal])


def gcps_graph_device(packed_np, lengths_np, n: int, ell_min: int, cap: int,
                      rsoe: int, soes: int, align_from=None, align_to=None):
    """Full GCPS graph on device: join + regime/ring/dedup/domination.
    Only the final edge arrays cross device->host."""
    from alga_tpu.graph.overlap_graph import OverlapGraph
    from alga_tpu.utils.timers import bump

    lengths = np.asarray(lengths_np, dtype=np.int64)
    max_len = int(lengths.max()) if n else 0
    k = int(ell_min)
    if n == 0 or max_len < k:
        return OverlapGraph.empty(n)

    if n >= (1 << 22) or max_len >= 1024:
        raise ValueError(
            "gcps_graph_device requires n < 2^22 and read length < 1024 "
            "(packed sort keys); route larger inputs through the host or "
            "sharded paths")

    af = np.ones(n, dtype=bool) if align_from is None else np.asarray(align_from, bool)
    at = np.ones(n, dtype=bool) if align_to is None else np.asarray(align_to, bool)

    num_windows = max_len - k + 1
    packed_d = jnp.asarray(packed_np)
    lengths_d = jnp.asarray(lengths.astype(np.int32))
    af_d = jnp.asarray(af)

    W = packing.words_for(min(max_len, cap))
    # domination compare width must match the host oracle's W_verify
    # (prefsuf.py:315); W3 < W under-compares reads longer than cap
    W3 = W
    at_d = jnp.asarray(at)
    hint_key = (k, int(cap), int(rsoe), int(soes), n >> 10)
    # target totals: last observed for this shape family, else a guess from
    # measured candidate densities (~8 candidates + ~14 domination pairs per
    # read on 20x short-read coverage; the retry loop corrects any input)
    tgt = _cap_hints.get(hint_key, (12 * n, 24 * n, 4 * n))
    for _attempt in range(8):
        C, C3, CE = _caps(*tgt)
        res = np.asarray(_gcps_fused(
            packed_d, lengths_d, af_d, at_d, k, num_windows,
            int(cap), int(rsoe), int(soes), C, C3, CE, W, W3))
        nkeep_i, total, nok_i, exp_total = (int(x) for x in res[-4:])
        if total <= C and exp_total <= C3 and nkeep_i <= CE:
            if (C, C3, CE) != _caps(total, exp_total, nkeep_i):
                # ran at non-canonical capacities (cold-start guess or a
                # shrunken input): redo at the canonical ones so the NEXT
                # call — the timed warm run — hits this exact executable
                tgt = (total, exp_total, nkeep_i)
                continue
            _update_hint(hint_key, total, exp_total, nkeep_i)
            # sample while the packed store / join buffers are still live
            # (phase-boundary samples see no device arrays)
            from alga_tpu.utils.timers import sample_memory
            sample_memory("gcps_device", log=False)
            bump("gcps_candidates", total)
            bump("gcps_matches", nok_i)
            bump("gcps_domination_checks", exp_total)
            edges = res[: 3 * nkeep_i].reshape(nkeep_i, 3)
            return OverlapGraph(n, edges[:, 0].copy(), edges[:, 1].copy(),
                                edges[:, 2].copy())
        # undershoot: total is exact regardless of C; once total fits,
        # exp_total is exact; once both fit, nkeep is exact — so growing
        # each target monotonically converges in <= 3 retries
        tgt = (max(total, tgt[0]), max(exp_total, tgt[1]),
               max(nkeep_i, tgt[2]))
    raise RuntimeError("gcps_graph_device: capacity retry did not converge")


def find_exact_overlaps_device(packed_np, lengths_np, ell_min: int, cap: int,
                               align_from=None, align_to=None):
    """Device-join twin of prefsuf.find_exact_overlaps."""
    from alga_tpu.graph.prefsuf import OverlapMatches

    lengths = np.asarray(lengths_np, dtype=np.int64)
    n = len(lengths)
    max_len = int(lengths.max()) if n else 0
    k = int(ell_min)
    if n == 0 or max_len < k:
        z = np.zeros(0, dtype=np.int64)
        return OverlapMatches(z, z.copy(), z.copy())

    af = np.ones(n, dtype=bool) if align_from is None else np.asarray(align_from, bool)
    at = np.ones(n, dtype=bool) if align_to is None else np.asarray(align_to, bool)

    num_windows = max_len - k + 1
    packed_d = jnp.asarray(packed_np)
    lengths_d = jnp.asarray(lengths.astype(np.int32))
    af_d = jnp.asarray(af)

    worder, lo, counts, total, pvalid = _keys_and_counts(
        packed_d, lengths_d, af_d, jnp.asarray(at), k, num_windows, cap)
    total = int(total)
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return OverlapMatches(z, z.copy(), z.copy())

    C = _round_cap(total)
    W = packing.words_for(min(max_len, cap))
    Bv, Cv, Ev, nok = _expand_verify(
        packed_d, lengths_d, worder, lo, counts, pvalid, af_d,
        num_windows, k, int(cap), C, W)
    m = int(nok)
    return OverlapMatches(
        np.asarray(Bv[:m]).astype(np.int64),
        np.asarray(Cv[:m]).astype(np.int64),
        np.asarray(Ev[:m]).astype(np.int64),
    )
