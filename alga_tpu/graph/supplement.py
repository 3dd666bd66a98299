"""Error-tolerant graph supplement: LI minimizer k-mers + pairwise-kmer
branch candidate verification.

Ref: src/GraphCreators/GraphCreatorLI.cpp (4 passes, one per rotation of the
nucleotide priority permutation), src/DataStructures/Read.cpp:145-226
(getLIKmers — per-interval minimum-hash k-mer under the remapped alphabet),
src/GraphCreators/GraphCreatorPairwiseKmerBranch.cpp (PKB — pair loop within
equal-hash runs with transitive branch markers + hybrid alignment check),
wired from main.cpp:300-355: only nodes with (indeg==0 && outdeg>0) get
alignTo and (indeg>0 && outdeg==0) get alignFrom — the supplement stitches
dead ends to orphan starts.

The LI hash of a window is its sequence remapped through the priority
permutation read as a big-endian base-4 number, so "minimum hash" ==
lexicographically smallest remapped window; we compare via a (hi, lo)
uint64 pair instead of the reference's __int128 and group by the exact pair
(the reference groups by hash mod 10^18+3, which can only merge groups —
the merged pairs are then rejected by the alignment check).

Execution model (device-first redesign of the reference's clone-per-thread
bucket loop, ref GraphCreatorKmerBased.cpp:108-136): per rotation,

  1. extract all LI minimizer records vectorized (`li_kmers`),
  2. canonical-sort records and find equal-key runs,
  3. emit every candidate pair (i, j>i) within a run up to the monotone
     offset cutoff (the reference's `break`, PKB.cpp:52-62), with the
     static `continue` guards evaluated vectorized,
  4. batch-verify alignment for the unique (id1, id2, offset) triples on
     device (`ach_batch_auto` — ACLER XOR/popcount, banded-LCS fallback),
  5. replay the reference's sequential branch-marker loop host-side with
     the verification results as pure lookups (`_replay_runs`).

Step 5 preserves the reference's exact transitive-skip semantics (which
edges are *not* added because the pair is already reachable within the
run), while all alignment math runs as one large device batch.  The
original sequential implementation is kept as `pkb_supplement_ref` — it is
the oracle `tests/test_supplement.py` checks the fast path against.
"""

from __future__ import annotations

import numpy as np

from alga_tpu.ops.align import ach_batch_auto, np_ach_can_align

_U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def li_kmers(codes: np.ndarray | None, lengths: np.ndarray, valid: np.ndarray,
             priorities: list[int], k: int, intervals: int,
             chunk_cells: int = 1 << 24, packed: np.ndarray | None = None):
    """Per-read LI minimizer k-mers, fully vectorized.

    Returns arrays (read_id, ind_in_read, key_hi, key_lo): for each read and
    each of `intervals` position intervals, the window whose remapped
    sequence is lexicographically smallest (first window wins ties,
    ref Read.cpp:206 strict '<').  Reads shorter than k are skipped
    (callers exclude them, ref main.cpp:253-257 removes them globally).

    Row output order is (interval, read) rather than the reference's
    (read, interval) — callers re-sort canonically, so only the multiset
    matters (asserted vs `li_kmers_ref` in tests).
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    ids_all = np.flatnonzero(np.asarray(valid, dtype=bool) & (lengths >= k))
    empty = (np.zeros(0, dtype=np.int64),) * 2 + (np.zeros(0, dtype=np.uint64),) * 2
    if len(ids_all) == 0:
        return empty

    if packed is not None:
        # native streaming pass (one rolling (hi, lo) update per window vs
        # ~k full-matrix u64 numpy passes — the error path's top host cost)
        from alga_tpu import native as _native
        if _native.available():
            return _native.li_kmers_native(packed, lengths, ids_all,
                                           priorities, k, intervals)

    pr = np.asarray(priorities, dtype=np.uint64)
    hi_len = min(k, 32)

    out_id, out_ind, out_hi, out_lo = [], [], [], []
    nwin_all = lengths[ids_all] - k + 1
    rows_per_chunk = max(1, chunk_cells // max(1, int(nwin_all.max())))
    for c0 in range(0, len(ids_all), rows_per_chunk):
        ids = ids_all[c0 : c0 + rows_per_chunk]
        nwin = nwin_all[c0 : c0 + rows_per_chunk]
        nwin_max = int(nwin.max())
        need = nwin_max + k - 1
        if codes is None:
            # memory diet: unpack only this chunk's rows from the 2-bit
            # store — the full uint8[N, L] matrix is never materialized
            from alga_tpu.core import packing as _packing
            sub = _packing.packed_to_codes(np.asarray(packed)[ids], need)
        else:
            sub = codes[ids, :min(need, codes.shape[1])]
        if sub.shape[1] < need:
            sub = np.pad(sub, ((0, 0), (0, need - sub.shape[1])))
        rc = pr[sub]  # remapped codes, uint64

        # big-endian base-4 window keys via Horner over the k window slots
        hi = np.zeros((len(ids), nwin_max), dtype=np.uint64)
        for t in range(hi_len):
            hi = hi * np.uint64(4) + rc[:, t : t + nwin_max]
        lo = np.zeros((len(ids), nwin_max), dtype=np.uint64)
        for t in range(hi_len, k):
            lo = lo * np.uint64(4) + rc[:, t : t + nwin_max]

        p = np.arange(nwin_max, dtype=np.int64)[None, :]
        win_ok = p < nwin[:, None]
        il = -(-nwin // intervals)          # ceil (ref Read.cpp:180)
        iv = p // il[:, None]               # interval of window p (ref :199)

        for v in range(intervals):
            m = win_ok & (iv == v)
            has = m.any(axis=1)
            if not has.any():
                break                        # iv is monotone in p per read
            # hierarchical (hi, lo, first-position) minimum per read
            h1 = np.where(m, hi, _U64MAX).min(axis=1)
            m2 = m & (hi == h1[:, None])
            l1 = np.where(m2, lo, _U64MAX).min(axis=1)
            m3 = m2 & (lo == l1[:, None])
            p1 = np.where(m3, p, np.int64(1) << 62).min(axis=1)
            out_id.append(ids[has])
            out_ind.append(p1[has])
            out_hi.append(h1[has])
            out_lo.append(l1[has])

    return (np.concatenate(out_id), np.concatenate(out_ind),
            np.concatenate(out_hi), np.concatenate(out_lo))


def li_kmers_ref(codes: np.ndarray, lengths: np.ndarray, valid: np.ndarray,
                 priorities: list[int], k: int, intervals: int):
    """Per-read-loop reference implementation of `li_kmers` (oracle)."""
    pr = np.asarray(priorities, dtype=np.uint64)
    rc = pr[codes]
    out_id, out_ind, out_hi, out_lo = [], [], [], []
    lengths = np.asarray(lengths, dtype=np.int64)

    ids = np.flatnonzero(valid & (lengths >= k))
    if len(ids) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), z.copy(), z.copy()

    hi_len = min(k, 32)
    lo_len = k - hi_len

    for i in ids:
        L = int(lengths[i])
        nwin = L - k + 1
        row = rc[i]
        win = np.lib.stride_tricks.sliding_window_view(row[:L], k)  # [nwin, k]
        pw_hi = (np.uint64(4) ** np.arange(hi_len - 1, -1, -1, dtype=np.uint64))
        hi = (win[:, :hi_len].astype(np.uint64) * pw_hi[None, :]).sum(axis=1)
        if lo_len > 0:
            pw_lo = (np.uint64(4) ** np.arange(lo_len - 1, -1, -1, dtype=np.uint64))
            lo = (win[:, hi_len:].astype(np.uint64) * pw_lo[None, :]).sum(axis=1)
        else:
            lo = np.zeros(nwin, dtype=np.uint64)

        interval_len = -(-nwin // intervals)   # ceil (ref Read.cpp:180)
        for iv in range(intervals):
            a = iv * interval_len
            b = min((iv + 1) * interval_len, nwin)
            if a >= nwin:
                break
            seg_hi = hi[a:b]
            seg_lo = lo[a:b]
            best = int(np.lexsort((np.arange(b - a), seg_lo, seg_hi))[0])
            out_id.append(i)
            out_ind.append(a + best)
            out_hi.append(seg_hi[best])
            out_lo.append(seg_lo[best])

    return (np.asarray(out_id, dtype=np.int64),
            np.asarray(out_ind, dtype=np.int64),
            np.asarray(out_hi, dtype=np.uint64),
            np.asarray(out_lo, dtype=np.uint64))


def _canonical_runs(rid, ind, hi, lo, read_lens):
    """Sort kmer records by key then (ind desc, read length, id) and return
    (sorted rid, sorted ind, run starts, run ends) for runs of size >= 2
    (ref Kmer.cpp:58-64 sort order within a hash group).

    The three tie-break fields pack into ONE uint64 ((2047-ind) << 43 |
    len << 32 | id — reads are capped at 500 bases and ids fit 32 bits),
    turning the 5-key lexsort into a 3-key one (~1.7x on the error path's
    dominant sort)."""
    lens_r = np.asarray(read_lens, dtype=np.int64)[rid]
    if len(ind) and (ind.max() < 2048 and lens_r.max() < 2048
                     and (len(read_lens) >> 32) == 0):
        rest = (((2047 - ind).astype(np.uint64) << np.uint64(43))
                | (lens_r.astype(np.uint64) << np.uint64(32))
                | rid.astype(np.uint64))
        from alga_tpu import native as _nat
        if _nat.available():
            # 2-way parallel native stable sort (the supplement's
            # dominant host cost at scale)
            order = _nat.sort3_u64(hi, lo, rest)
        else:
            order = np.lexsort((rest, lo, hi))
    else:
        order = np.lexsort((rid, lens_r, -ind, lo, hi))
    rid_s, ind_s = rid[order], ind[order]
    hi_s, lo_s = hi[order], lo[order]
    boundary = np.ones(len(order), dtype=bool)
    boundary[1:] = (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])
    starts = np.flatnonzero(boundary)
    ends = np.append(starts[1:], len(order))
    big = (ends - starts) >= 2
    return rid_s, ind_s, starts[big], ends[big]


def _gen_candidate_pairs(rid_s, ind_s, starts, ends, read_lens, cfg,
                         align_from, align_to):
    """Vectorized emission of all (i, j) PKB candidate pairs.

    For each record i (sorted ind-descending within its run), the j window
    is (i, j_hi): all later run entries up to the reference's monotone
    `break` cutoff 100*(ind_i - ind_j) > MOC*len_i (PKB.cpp:52-62 — ind_j
    is non-increasing in j, so the cutoff is a prefix property).

    Returns (pi, pj, pass_static): global kmer indices of each pair plus
    the vectorized `continue`-guard results.  Pairs are ordered by
    (i asc, j asc) and grouped contiguously per i — `_replay_runs` relies
    on this layout.
    """
    nrec = len(rid_s)
    if nrec == 0 or len(starts) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), np.zeros(0, dtype=bool)

    from alga_tpu import native as _nat
    if _nat.available():
        # native twin (two-pass count+fill; the numpy formulation below is
        # the oracle, differential-tested in tests/test_supplement.py)
        return _nat.pkb_pairgen(
            rid_s, ind_s, starts, ends, read_lens,
            cfg.max_offset_considered_for_alignment,
            cfg.min_offset_for_alignment, cfg.min_overlap_area,
            align_from, align_to)

    sizes = ends - starts
    tot_members = int(sizes.sum())
    member = np.repeat(starts, sizes) + (
        np.arange(tot_members, dtype=np.int64)
        - np.repeat(np.cumsum(sizes) - sizes, sizes))
    run_id = np.full(nrec, -1, dtype=np.int64)
    run_id[member] = np.repeat(np.arange(len(starts), dtype=np.int64), sizes)
    in_run = run_id >= 0

    lens = np.asarray(read_lens, dtype=np.int64)
    moc = cfg.max_offset_considered_for_alignment
    # composite key (run, -ind): globally non-decreasing over run entries
    K = 2048
    keys = run_id * K + (1024 - ind_s)
    keys_sorted = keys[in_run]
    gidx = np.flatnonzero(in_run)

    id1 = rid_s
    # keep j iff 100*ind_j >= 100*ind_i - moc*len_i  <=>  ind_j >= T_i
    a = 100 * ind_s - moc * lens[id1]
    T = -((-a) // 100)
    T = np.clip(T, -1023, 1023)
    probe = run_id * K + (1024 - T)
    j_hi_local = np.searchsorted(keys_sorted, probe, side="right")
    j_hi = np.where(j_hi_local > 0, gidx[np.maximum(j_hi_local - 1, 0)] + 1, 0)

    i_pos = np.arange(nrec, dtype=np.int64)
    counts = np.clip(j_hi - (i_pos + 1), 0, None)
    counts = np.where(in_run & align_from[rid_s], counts, 0)

    total = int(counts.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), np.zeros(0, dtype=bool)

    cum = np.zeros(nrec + 1, dtype=np.int64)
    np.cumsum(counts, out=cum[1:])
    pi = np.repeat(i_pos, counts)
    pj = np.arange(total, dtype=np.int64) - cum[pi] + pi + 1

    a1 = rid_s[pi]
    a2 = rid_s[pj]
    off = ind_s[pi] - ind_s[pj]
    len1 = lens[a1]
    len2 = lens[a2]
    overlap = np.minimum(len1, len2 + off) - off
    ok = align_to[a2] & (a1 != a2)
    ok &= off >= cfg.min_offset_for_alignment
    ok &= overlap >= cfg.min_overlap_area
    ok &= (len2 + off - len1) >= 0
    return pi, pj, ok


def _verify_pairs(a1, a2, off, codes, packed, read_lens, cfg,
                  min_device_batch, mesh=None):
    """Batch ACH verification over unique (id1, id2, offset) triples."""
    if len(a1) == 0:
        return np.zeros(0, dtype=bool)
    n_reads = len(read_lens)
    if n_reads < (1 << 27) and off.min() >= 0 and off.max() < 1024:
        # pack (a1, a2, off) into ONE u64: unique on a flat u64 is ~6x
        # np.unique(axis=0)'s structured-sort path
        key = ((a1.astype(np.uint64) << np.uint64(37))
               | (a2.astype(np.uint64) << np.uint64(10))
               | off.astype(np.uint64))
        ukey, inv = np.unique(key, return_inverse=True)
        u1 = (ukey >> np.uint64(37)).astype(np.int64)
        u2 = ((ukey >> np.uint64(10)) & np.uint64((1 << 27) - 1)).astype(np.int64)
        uo = (ukey & np.uint64(1023)).astype(np.int64)
    else:
        trip = np.stack([a1, a2, off], axis=1)
        uniq, inv = np.unique(trip, axis=0, return_inverse=True)
        u1, u2, uo = uniq[:, 0], uniq[:, 1], uniq[:, 2]
    if mesh is not None and cfg.use_acler_instead_of_aclcs:
        from alga_tpu.ops.align import ach_batch_mesh
        can = ach_batch_mesh(mesh, np.asarray(packed), read_lens,
                             u1, u2, uo, cfg)
    else:
        can = ach_batch_auto(packed, codes, read_lens, u1, u2, uo, cfg,
                             min_device_batch=min_device_batch)
    return can[inv]


def _replay_runs(adj_add, rid_s, ind_s, starts, ends, pi, pj, pass_static,
                 pair_can):
    """Replay the reference's sequential PKB loop (PKB.cpp:16-98) with
    alignment results as precomputed lookups.

    Branch markers: reach[i] = bitmask of run-local j reachable from i
    through edges known so far; a pair (i, j) already covered is skipped
    without adding an edge — this transitive skip is semantic (it decides
    the final edge set), so it is replayed exactly."""
    nrec = len(rid_s)
    counts = np.bincount(pi, minlength=nrec).astype(np.int64)
    cum = np.zeros(nrec + 1, dtype=np.int64)
    np.cumsum(counts, out=cum[1:])

    rid_l = rid_s.tolist()
    pj_l = pj.tolist()
    off_all = (ind_s[pi] - ind_s[pj]).tolist()
    ok_l = pass_static.tolist()
    can_l = pair_can.tolist()
    cum_l = cum.tolist()

    get_offset = adj_add.get_offset
    add_min = adj_add.add_min

    for s, e in zip(starts.tolist(), ends.tolist()):
        if cum_l[e] == cum_l[s]:
            continue
        reach = [0] * (e - s)
        for gi in range(e - 1, s - 1, -1):
            p0, p1 = cum_l[gi], cum_l[gi + 1]
            if p0 == p1:
                continue
            i_local = gi - s
            ri = reach[i_local]
            id1 = rid_l[gi]
            for idx in range(p0, p1):
                if not ok_l[idx]:
                    continue
                j_local = pj_l[idx] - s
                if (ri >> j_local) & 1:
                    continue
                id2 = rid_l[pj_l[idx]]
                o = off_all[idx]
                cur = get_offset(id1, id2)
                if cur is None or cur > o:
                    if can_l[idx]:
                        add_min(id1, id2, o)
                        cur = o
                if cur is not None:
                    ri |= (1 << j_local) | reach[j_local]
            reach[i_local] = ri


def pkb_supplement(adj_add, codes, lengths, read_lens, cfg,
                   align_from: np.ndarray, align_to: np.ndarray,
                   priorities_rotations: int = 4, packed=None,
                   min_device_batch: int = 200_000, mesh=None):
    """Run the LI/PKB supplement (vectorized + device-batched verification).

    `adj_add` is a small adapter object with .get_offset(a, b) -> int|None
    and .add_min(a, b, offset); the caller owns the graph.  `packed` is the
    uint32[N, W] 2-bit read store enabling the device ACLER kernel for
    large batches.
    """
    k = cfg.li_kmer_length
    intervals = cfg.li_kmer_intervals
    valid = (align_from | align_to) & (np.asarray(read_lens) >= k)
    # masks gate kmer EXTRACTION only: the reference's pair loop runs on a
    # clone() of the creator (GraphCreatorKmerBased.cpp:109), and PKB::clone
    # constructs a fresh object whose alignFrom/alignTo default to ALL TRUE
    # (GraphCreator.cpp:10-13) — so any kmer-extracted read may act as
    # either pair side.  Verified candidate-for-candidate against an
    # instrumented build of the reference sources.
    all_true = np.ones(len(valid), dtype=bool)

    priorities = [0, 1, 2, 3]
    for _rot in range(min(4, priorities_rotations)):
        rid, ind, hi, lo = li_kmers(codes, read_lens, valid, priorities, k,
                                    intervals, packed=packed)
        if len(rid):
            rid_s, ind_s, starts, ends = _canonical_runs(
                rid, ind, hi, lo, read_lens)
            pi, pj, ok = _gen_candidate_pairs(
                rid_s, ind_s, starts, ends, read_lens, cfg,
                all_true, all_true)
            sel = np.flatnonzero(ok)
            can = np.zeros(len(pi), dtype=bool)
            if len(sel):
                can[sel] = _verify_pairs(
                    rid_s[pi[sel]], rid_s[pj[sel]],
                    ind_s[pi[sel]] - ind_s[pj[sel]],
                    codes, packed, read_lens, cfg, min_device_batch,
                    mesh=mesh)
            _replay_runs_auto(adj_add, rid_s, ind_s, starts, ends, pi, pj,
                              ok, can)
        priorities = priorities[1:] + priorities[:1]   # rotate (ref LI.cpp:25)


def _replay_runs_auto(adj_add, rid_s, ind_s, starts, ends, pi, pj,
                      pass_static, pair_can):
    """Route the branch-marker replay to the native engine when the
    adapter exposes the sorted base-key arrays (SupplementAdj); the Python
    loop (`_replay_runs`, the oracle) otherwise.  The native pass removes
    the dominant error-path host cost: per-pair adjacency searchsorted +
    the Python bitmask loop (ref PKB.cpp:16-98)."""
    from alga_tpu import native as _native
    if (_native.available() and hasattr(adj_add, "_keys")
            and hasattr(adj_add, "overlay")):
        overlay = _native.pkb_replay(
            rid_s, ind_s, starts, ends, pi, pj, pass_static, pair_can,
            adj_add.n, adj_add._keys, adj_add._offs, adj_add.overlay)
        adj_add.overlay = overlay
        return
    _replay_runs(adj_add, rid_s, ind_s, starts, ends, pi, pj, pass_static,
                 pair_can)


def pkb_supplement_ref(adj_add, codes, lengths, read_lens, cfg,
                       align_from: np.ndarray, align_to: np.ndarray,
                       priorities_rotations: int = 4):
    """Sequential per-pair oracle: the literal transcription of the
    reference loop (4 rotations x bucket runs x scalar ACH), kept for
    differential testing of `pkb_supplement`."""
    k = cfg.li_kmer_length
    intervals = cfg.li_kmer_intervals
    valid = (align_from | align_to) & (np.asarray(read_lens) >= k)
    all_true = np.ones(len(valid), dtype=bool)   # clone() quirk, see above

    priorities = [0, 1, 2, 3]
    for _rot in range(min(4, priorities_rotations)):
        rid, ind, hi, lo = li_kmers_ref(codes, read_lens, valid, priorities,
                                        k, intervals)
        if len(rid):
            order = np.lexsort((rid, np.asarray(read_lens)[rid], -ind, lo, hi))
            rid_s, ind_s = rid[order], ind[order]
            hi_s, lo_s = hi[order], lo[order]
            boundary = np.ones(len(order), dtype=bool)
            boundary[1:] = (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])
            starts = np.flatnonzero(boundary)
            ends = np.append(starts[1:], len(order))
            for s, e in zip(starts, ends):
                if e - s >= 2:
                    _pkb_group(adj_add, codes, read_lens, cfg,
                               rid_s[s:e], ind_s[s:e], all_true, all_true)
        priorities = priorities[1:] + priorities[:1]   # rotate (ref LI.cpp:25)


def _pkb_group(adj_add, codes, read_lens, cfg, rids, inds, align_from, align_to):
    """PKB pair loop within one equal-hash run
    (ref GraphCreatorPairwiseKmerBranch.cpp:16-98).  The run arrives sorted
    by indInRead DESC; iterate i from the END (ascending indInRead), pair
    with j > i (descending indInRead -> offset >= 0)."""
    D = len(rids)
    # branch markers: reach[i] = set of js reachable within the run
    reach = [set() for _ in range(D)]
    for i in range(D - 1, -1, -1):
        id1 = int(rids[i])
        if not align_from[id1]:
            continue
        ind1 = int(inds[i])
        for j in range(i + 1, D):
            id2 = int(rids[j])
            if not align_to[id2]:
                continue
            if id1 == id2:
                continue
            ind2 = int(inds[j])
            offset = ind1 - ind2
            if offset < cfg.min_offset_for_alignment:
                continue
            len1 = int(read_lens[id1])
            len2 = int(read_lens[id2])
            if 100 * offset > cfg.max_offset_considered_for_alignment * len1:
                break
            overlap = min(len1, len2 + offset) - offset
            if overlap < cfg.min_overlap_area:
                continue
            if len2 + offset - len1 < 0:
                continue

            if j not in reach[i]:
                cur = adj_add.get_offset(id1, id2)
                if cur is None or cur > offset:
                    if np_ach_can_align(codes, read_lens, id1, id2, offset, cfg):
                        adj_add.add_min(id1, id2, offset)
                        cur = offset
                if cur is not None:
                    reach[i].add(j)
                    reach[i] |= reach[j]
