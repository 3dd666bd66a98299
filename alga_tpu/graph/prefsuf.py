"""Exact suffix–prefix overlap graph construction (GCPS equivalent).

Device-first redesign of the reference's default graph creator
(ref: src/GraphCreators/GraphCreatorPrefSuf.cpp).  The reference runs ~450
sequential rounds (one per overlap length ℓ), each round probing per-read
rolling hashes into shared buckets and mutating the graph in place under
striped node mutexes, with two order-dependent heuristics:

  * regime 1 (ℓ < REMOVE_SMALL_OVERLAP_EDGES_MIN_OVERLAP): a size-3 ring
    buffer per suffix read keeps only the last 3 short-overlap edges
    (ref GCPS.cpp:397-401),
  * regime 2 (ℓ >= threshold): each arriving edge B→C evicts existing
    in-edges A→C that B "dominates" — A's bases [offsetDiff, offset_A)
    equal B's bases [0, offset_B), verified by Bitset block compare
    (ref GCPS.cpp:403-483) — and always supersedes a previous B→C.

Here the whole computation is reformulated as an order-free batch program
(the reference's own result is thread-schedule-dependent; we fix the
canonical order ℓ ascending, then source-id ascending — the order its
sequential execution would produce):

  1. every (B, C, ℓ) exact match is found by ONE window-k-mer hash join
     (k = min overlap) + packed-bit verification — ops/hashes.py +
     ops/bitops.py on device;
  2. regime-1 ring survivors = per-B last 3 matches below the threshold;
  3. per (B, C) the latest instance wins (the reference's always-supersede
     rule collapses to max-ℓ);
  4. an edge (A→C, offset_a) is deleted iff some regime-2 match
     (B→C, offset_b) with a later stamp satisfies the reference's exact
     domination predicate:
         offset_b > 0, offset_a >= offset_b, A != B,
         len_B + (offset_a-offset_b) - len_A >= 0        (right offset)
         A[offset_a-offset_b : offset_a] == B[0 : offset_b]
     (batched packed compare on device).

Derivation notes: the reference's removal scans run at arrival time against
the then-current neighborhood, but (a) every arrival is pushed regardless,
(b) same-source arrivals always evict their predecessor, so at any moment a
pair is represented by its latest instance, and (c) eviction of A by B does
not depend on A's own eviction history.  Hence "pair survives iff its last
instance is dominated by no later arrival", which needs no sequential loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from alga_tpu.core import packing
from alga_tpu.graph.overlap_graph import OverlapGraph
from alga_tpu.ops import bitops, hashes


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.repeat(np.cumsum(counts) - counts, counts)
    return np.arange(total, dtype=np.int64) - starts


@dataclass
class OverlapMatches:
    """All exact suffix(B)–prefix(C) matches: B[lenB-ell:] == C[:ell]."""
    src: np.ndarray   # B  int64[M]
    dst: np.ndarray   # C  int64[M]
    ell: np.ndarray   # overlap length int64[M]


def find_exact_overlaps(packed, lengths, ell_min: int, cap: int,
                        align_from=None, align_to=None,
                        chunk: int = 4_000_000,
                        codes=None) -> OverlapMatches:
    """Find every exact suffix-prefix overlap of length in [ell_min, cap].

    Conditions (matching ref GCPS sweep semantics):
      ell_min <= ell <= min(len_B, len_C, cap);  B != C;
      offset = len_B - ell >= 0.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    n = len(lengths)
    if n == 0 or ell_min <= 0:
        z = np.zeros(0, dtype=np.int64)
        return OverlapMatches(z, z.copy(), z.copy())
    max_len = int(lengths.max())
    k = int(ell_min)
    if max_len < k:
        z = np.zeros(0, dtype=np.int64)
        return OverlapMatches(z, z.copy(), z.copy())

    af = np.ones(n, dtype=bool) if align_from is None else np.asarray(align_from, dtype=bool)
    at = np.ones(n, dtype=bool) if align_to is None else np.asarray(align_to, dtype=bool)

    from alga_tpu import native as _nat0
    import jax as _jax0
    if _nat0.available() and _jax0.default_backend() == "cpu":
        # the native fused join rolls only windows p in [len-cap, len-k]
        # per row, so it handles long sequences (the contig-trim graph)
        # directly — no tail-compacted matrix, no codes unpack (round 5:
        # the old tail branch unpacked a [3004, 83k] codes matrix twice
        # at the flagship config)
        pvalid = (lengths >= k) & at
        pref_ids = np.flatnonzero(pvalid)
        pk = _nat0.prefix_keys(np.asarray(packed), pref_ids, k,
                               hashes.A1, hashes.A2)
        order = np.argsort(pk, kind="stable")
        num_windows = max_len - k + 1
        src, dst, ell = _nat0.gcps_join_verify_packed(
            n, num_windows, lengths, af & (lengths >= k), k, cap,
            hashes.A1, hashes.A2,
            pk[order], pref_ids[order].astype(np.int32),
            np.asarray(packed))
        from alga_tpu.utils.timers import bump
        bump("gcps_matches", len(src))
        return OverlapMatches(src.astype(np.int64), dst.astype(np.int64),
                              ell.astype(np.int64))

    if max_len > cap + (cap >> 2):
        # long sequences (the contig-trim graph): only the last `cap`
        # positions of each sequence can be a suffix window (ell <= cap),
        # so hash a TAIL-compacted matrix instead of all max_len windows —
        # ~max_len/cap less hashing/joining work.  Prefix keys (window 0)
        # are hashed separately.
        from alga_tpu.core import packing as _packing
        if codes is None:
            codes = _packing.packed_to_codes(packed, max_len)
        eff = np.minimum(lengths, cap)
        start = lengths - eff
        capm = int(eff.max())
        cols = np.arange(capm, dtype=np.int64)[None, :]
        src = np.minimum(start[:, None] + cols, max_len - 1)
        tail = np.take_along_axis(codes[:, :max_len], src, axis=1)
        num_windows = capm - k + 1
        keys, wvalid = hashes.window_keys(None, tail, eff, k, num_windows)
        wvalid = wvalid & af[:, None]
        pkeys, pvalid_w = hashes.window_keys(None, codes[:, :k], lengths, k, 1)
        pref_key_arr = pkeys[:, 0]
        wB, wp_t = np.nonzero(wvalid)
        wp = start[wB] + wp_t                 # original window position
        wkeys = keys[wB, wp_t]
    else:
        num_windows = max_len - k + 1
        from alga_tpu import native as _nat
        import jax as _jax
        if _nat.available() and _jax.default_backend() == "cpu":
            # fully fused native path: probe-side window hashes roll INLINE
            # from the 2-bit packed store (round 5: no codes unpack, no
            # uint64[n, nw] key materialization — 231 MB of traffic saved
            # at the 920k config); match order identical to the numpy chain
            pvalid = (lengths >= k) & at
            pref_ids = np.flatnonzero(pvalid)
            pk = _nat.prefix_keys(np.asarray(packed), pref_ids, k,
                                  hashes.A1, hashes.A2)
            order = np.argsort(pk, kind="stable")
            src, dst, ell = _nat.gcps_join_verify_packed(
                n, num_windows, lengths, af & (lengths >= k), k, cap,
                hashes.A1, hashes.A2,
                pk[order], pref_ids[order].astype(np.int32),
                np.asarray(packed))
            from alga_tpu.utils.timers import bump
            bump("gcps_matches", len(src))
            return OverlapMatches(src.astype(np.int64),
                                  dst.astype(np.int64),
                                  ell.astype(np.int64))
        keys, wvalid = hashes.window_keys(packed, codes, lengths, k,
                                          num_windows)
        # window (B, p) encodes candidate overlap ell = len_B - p; restrict
        # to ell <= cap  <=>  p >= len_B - cap
        pos = np.arange(num_windows, dtype=np.int64)[None, :]
        wvalid = wvalid & af[:, None] & (pos >= (lengths[:, None] - cap))
        pref_key_arr = keys[:, 0]
        wB, wp = np.nonzero(wvalid)
        wkeys = keys[wB, wp]

    # prefix side
    pvalid = (lengths >= k) & at
    pref_ids = np.flatnonzero(pvalid)
    pref_keys = pref_key_arr[pref_ids]
    order = np.argsort(pref_keys, kind="stable")
    pref_ids_sorted = pref_ids[order]
    pref_keys_sorted = pref_keys[order]

    out_src, out_dst, out_ell = [], [], []
    W_verify = packing.words_for(min(max_len, cap))

    from alga_tpu import native as _native
    use_native_join = _native.available()

    for lo_i in range(0, len(wB), chunk):
        sl = slice(lo_i, lo_i + chunk)
        cB, cp, ck = wB[sl], wp[sl], wkeys[sl]
        if use_native_join:
            # hash-join range lookup (~10x the searchsorted probes: binary
            # search over a multi-million-key table is cache-miss bound)
            lo, counts = _native.join_ranges(pref_keys_sorted, ck)
        else:
            lo = np.searchsorted(pref_keys_sorted, ck, side="left")
            hi = np.searchsorted(pref_keys_sorted, ck, side="right")
            counts = hi - lo
        if counts.sum() == 0:
            continue
        B_rep = np.repeat(cB, counts)
        p_rep = np.repeat(cp, counts)
        idx = _ragged_arange(counts) + np.repeat(lo, counts)
        C = pref_ids_sorted[idx]
        ell = lengths[B_rep] - p_rep
        keep = (B_rep != C) & (lengths[C] >= ell)
        B_rep, p_rep, C, ell = B_rep[keep], p_rep[keep], C[keep], ell[keep]
        if len(B_rep) == 0:
            continue
        ok = bitops.substr_equal_auto(
            packed, codes, B_rep, p_rep, C, ell, W_verify)
        out_src.append(B_rep[ok])
        out_dst.append(C[ok])
        out_ell.append(ell[ok])

    if not out_src:
        z = np.zeros(0, dtype=np.int64)
        return OverlapMatches(z, z.copy(), z.copy())
    m = OverlapMatches(
        np.concatenate(out_src), np.concatenate(out_dst), np.concatenate(out_ell))
    from alga_tpu.utils.timers import bump
    bump("gcps_matches", len(m.src))   # ref GCPS.h:111-118 counters
    return m


def _regime1_ring_survivors(m: OverlapMatches, rsoe: int, soes: int):
    """Per source B, keep the last `soes` matches with ell < rsoe, in the
    canonical arrival order (ell asc, then dst asc) — the ring buffer of
    ref GCPS.cpp:397-401."""
    r1 = m.ell < rsoe
    src, dst, ell = m.src[r1], m.dst[r1], m.ell[r1]
    if len(src) == 0:
        return src, dst, ell
    order = np.lexsort((dst, ell, src))
    src, dst, ell = src[order], dst[order], ell[order]
    # position within each src group, from the end
    group_start = np.ones(len(src), dtype=bool)
    group_start[1:] = src[1:] != src[:-1]
    starts_idx = np.flatnonzero(group_start)
    group_id = np.cumsum(group_start) - 1
    counts = np.diff(np.append(starts_idx, len(src)))
    pos_in_group = np.arange(len(src)) - starts_idx[group_id]
    keep = pos_in_group >= (counts[group_id] - soes)
    return src[keep], dst[keep], ell[keep]


def build_gcps_graph(packed, lengths, n: int, ell_min: int, cap: int,
                     rsoe: int, soes: int = 3,
                     align_from=None, align_to=None,
                     pair_chunk: int = 4_000_000,
                     matches: OverlapMatches | None = None,
                     codes=None) -> OverlapGraph:
    """Full GCPS-equivalent graph: orientation src→dst where dst's prefix
    equals src's suffix, offset = len(src) - ell.  Deterministic."""
    lengths = np.asarray(lengths, dtype=np.int64)
    if matches is None:
        import os as _os

        import jax as _jax
        n_windows = max(0, int(lengths.max(initial=0)) - int(ell_min) + 1)
        max_len = int(lengths.max(initial=0))
        # device routing (override with ALGA_GCPS_DEVICE=small|wide|off):
        #   * the fused single-dispatch path (device_join) for short-read
        #     batches under its packed-sort-key gates (ids < 2^22,
        #     len < 1024, n_windows <= 4096) — lowest warm latency;
        #   * the scale path (device_scale) for everything larger, as long
        #     as sequences are short enough that tail compaction isn't the
        #     better formulation (contig-trim graphs stay on host);
        #   * host numpy/native otherwise.
        force = _os.environ.get("ALGA_GCPS_DEVICE", "")
        on_accel = _jax.default_backend() != "cpu"
        big_enough = len(lengths) * n_windows >= 1 << 18
        # the fused single-dispatch path serves small batches; above ~0.5M
        # reads larger batches take the staged wide path (thresholds not
        # yet re-derived from GPU measurements)
        fits_small = (n_windows <= 4096 and n < (1 << 19)
                      and max_len < 1024)
        # hard preconditions of the fused path's packed sort keys — a
        # forced override may relax the heuristic n < 2^19 threshold but
        # never these (ids must fit the key's id field, windows its grid)
        small_safe = (n_windows <= 4096 and n < (1 << 22)
                      and max_len < 1024)
        short_reads = max_len <= cap + (cap >> 2)
        if force == "small" and not small_safe:
            import sys as _sys
            print("[alga_tpu] ALGA_GCPS_DEVICE=small ignored: input "
                  f"violates fused-path preconditions (n={n}, "
                  f"max_len={max_len}, n_windows={n_windows}); "
                  "falling through to wide/host routing", file=_sys.stderr)
            force = ""
        if force != "off":
            if ((force == "small" and small_safe) or
                    (not force and on_accel and big_enough and fits_small)):
                from alga_tpu.graph.device_join import gcps_graph_device
                return gcps_graph_device(packed, lengths, n, ell_min, cap,
                                         rsoe, soes, align_from, align_to)
            if (force == "wide" or
                    (not force and on_accel and big_enough and short_reads)):
                from alga_tpu.graph.device_scale import \
                    gcps_graph_device_scale
                return gcps_graph_device_scale(
                    packed, lengths, n, ell_min, cap, rsoe, soes,
                    align_from, align_to)
        matches = find_exact_overlaps(packed, lengths, ell_min, cap,
                                      align_from, align_to, codes=codes)
    from alga_tpu import native as _native
    if _native.available():
        return _native.gcps_from_matches(n, matches, packed, lengths,
                                         rsoe, soes)
    m = matches

    # regime split
    s1, d1, e1 = _regime1_ring_survivors(m, rsoe, soes)
    r2 = m.ell >= rsoe
    s2, d2, e2 = m.src[r2], m.dst[r2], m.ell[r2]

    # pair instances = ring survivors + all regime-2 matches;
    # latest instance per (src, dst) wins = max ell
    ps = np.concatenate([s1, s2])
    pd = np.concatenate([d1, d2])
    pe = np.concatenate([e1, e2])
    if len(ps) == 0:
        return OverlapGraph.empty(n)
    order = np.lexsort((pe, pd, ps))
    ps, pd, pe = ps[order], pd[order], pe[order]
    last = np.ones(len(ps), dtype=bool)
    last[:-1] = (ps[1:] != ps[:-1]) | (pd[1:] != pd[:-1])
    ps, pd, pe = ps[last], pd[last], pe[last]
    p_off = lengths[ps] - pe

    # ---- domination pruning by regime-2 arrivals --------------------------
    removed = np.zeros(len(ps), dtype=bool)
    if len(s2):
        r_off = lengths[s2] - e2
        # group removers by dst
        rorder = np.lexsort((s2, e2, d2))
        rs, rd, re_, ro = s2[rorder], d2[rorder], e2[rorder], r_off[rorder]
        r_start = np.searchsorted(rd, np.arange(n))
        r_end = np.searchsorted(rd, np.arange(n), side="right")

        cnt = r_end[pd] - r_start[pd]
        total = int(cnt.sum())
        W_verify = packing.words_for(int(min(lengths.max(), cap)))
        # chunk over pair instances to bound the cross-product
        i = 0
        csum = np.cumsum(cnt)
        while i < len(ps):
            # choose j so that pairs i..j expand to <= pair_chunk entries
            base = csum[i - 1] if i > 0 else 0
            j = int(np.searchsorted(csum, base + pair_chunk)) + 1
            j = min(max(j, i + 1), len(ps))
            sl = slice(i, j)
            c = cnt[sl]
            if c.sum() > 0:
                pair_rep = np.repeat(np.arange(i, j), c)
                ridx = _ragged_arange(c) + np.repeat(r_start[pd[sl]], c)
                A = ps[pair_rep]
                offA = p_off[pair_rep]
                ellA = pe[pair_rep]
                B = rs[ridx]
                offB = ro[ridx]
                ellB = re_[ridx]
                # stamp order: (ell, src) lexicographic, remover strictly later
                later = (ellB > ellA) | ((ellB == ellA) & (B > A))
                cond = (later & (B != A) & (offB > 0) & (offA >= offB)
                        & (lengths[B] + (offA - offB) - lengths[A] >= 0))
                if cond.any():
                    ci = np.flatnonzero(cond)
                    okm = bitops.substr_equal_auto(
                        packed, codes, A[ci], (offA - offB)[ci], B[ci],
                        offB[ci], W_verify)
                    removed[pair_rep[ci[okm]]] = True
            i = j

    keep = ~removed
    return OverlapGraph(
        n,
        ps[keep].astype(np.int32),
        pd[keep].astype(np.int32),
        p_off[keep].astype(np.int32),
    )
