"""Fully de-replicated multi-device GCPS: all_to_all key routing + remote
row fetch + sharded post-join.

The round-1 sharded sweep (removed in round 3) sharded only candidate
generation and replicated the whole packed read store on every device —
per-device memory O(N).  This module is the real scale-out design
(SURVEY.md §2.10): per-device memory is O(N/d) end to end.

  * Reads are block-sharded over mesh axis 'r' (read g lives on shard
    g // per).  The packed store is NEVER gathered or replicated.
  * Window (suffix) and prefix key records are routed to their KEY OWNER
    shard (owner = k1 % d) with `all_to_all`; the owner sort-joins them
    locally — the device re-expression of the reference's hash buckets
    (ref GraphCreatorPrefSuf.cpp:41-48, probed under striped locks there).
  * Candidate verification fetches the two packed rows of each candidate
    from their home shards with a request/response `all_to_all` pair
    (a remote gather riding ICI) and runs the exact packed-bit compare
    locally — traffic O(matches * words), not O(N).
  * The post-join (regime split, SOES ring survivors, pair dedup,
    domination pruning — ref GCPS.cpp:397-483, reformulated order-free in
    graph/prefsuf.py) is itself sharded: matches are routed to their
    SRC-owner shard (ring buffer + dedup are per-src semantics), then
    pairs and regime-2 removers are routed to their DST-owner shard
    (domination groups by dst), with the packed rows of the compared reads
    fetched remotely again.

Capacity model: SPMD needs static shapes, so every routed buffer has a
per-destination capacity.  Capacities derived from data (candidate totals,
match counts, pair/remover counts, domination expansion totals) are
measured exactly by the previous stage; the remaining ones (initial record
routing, fetch blocks) start from uniform-hash estimates and retry with
doubled capacity on an overflow flag — the sharded analogue of the
capacity-retry loop in native.py:contract_and_walk.

Differential contract: the final edge set equals build_gcps_graph /
gcps_graph_device on the same inputs (tests/test_sharded_gcps.py), for any
mesh size, including align_from/align_to masks.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from alga_tpu.core import packing
from alga_tpu.ops import hashes

_SENT = 0xFFFFFFFF        # buffer fill marker (invalid slot)
_KMAX = 0xFFFFFFFE        # valid routing keys are clamped below the fill


def _round_cap(x: int, q: int = 256) -> int:
    # coarse quantization so nearby datasets reuse compiled executables
    return max(q, ((int(x) + q - 1) // q) * q)


def _host(x) -> np.ndarray:
    """Device array -> host numpy, multi-process safe: under
    jax.distributed a stage output spans non-addressable devices, so it is
    gathered across processes first (every process gets the global value)."""
    if x.is_fully_addressable:
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def _put(np_arr: np.ndarray, sharding):
    """Host numpy -> sharded device array; works single- and multi-process
    (each process feeds only its addressable shards)."""
    return jax.make_array_from_callback(
        np_arr.shape, sharding, lambda idx: np_arr[idx])


# ---------------------------------------------------------------------------
# in-shard_map helpers


def _scatter_to_blocks(owner, payload, d: int, S: int):
    """Bucket `payload` rows by destination shard into a [d, S, F] buffer.

    owner int32[M] in [0, d] (d = drop), payload uint32[M, F].
    Returns (buf, order, owner_sorted, pos, overflow): buf is SENT-filled
    where unoccupied; (order, owner_sorted, pos) record where each source
    row landed so fetch responses can be unsorted; overflow is 1 if any
    destination bucket exceeded S.
    """
    m = owner.shape[0]
    order = jnp.argsort(owner)
    owner_s = owner[order]
    counts = jnp.zeros(d + 1, jnp.int32).at[owner_s].add(1)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(m, dtype=jnp.int32) - starts[owner_s]
    valid = owner_s < d
    row = jnp.where(valid & (pos < S), owner_s, d)
    buf = jnp.full((d + 1, S, payload.shape[1]), _SENT, dtype=jnp.uint32)
    buf = buf.at[row, jnp.minimum(pos, S - 1)].set(payload[order],
                                                   mode="drop")
    overflow = jnp.max(jnp.where(valid, pos, -1), initial=-1) >= S
    return buf[:d], order, owner_s, pos, overflow.astype(jnp.int32)


def _route(owner, payload, d: int, S: int):
    """Route payload rows to their owner shards; returns the received
    [d*S, F] rows (SENT-filled empties) + overflow flag (psum'd)."""
    buf, _, _, _, ovf = _scatter_to_blocks(owner, payload, d, S)
    recv = jax.lax.all_to_all(buf, "r", split_axis=0, concat_axis=0)
    return recv.reshape(d * S, payload.shape[1]), jax.lax.psum(ovf, "r")


def _fetch_table_rows(table_l, gids, gvalid, per: int, d: int, F: int):
    """Remote gather of arbitrary uint32 table rows by global id — the
    request/response all_to_all pair shared by the packed-row fetch, the
    dangling-walk node fetch and the pointer-doubling rounds.

    Request ids are routed to their home shard (gid // per), the home
    shard gathers its local rows, and responses ride back on a second
    all_to_all in the same slot order.  Rows for ~gvalid entries are
    junk — callers must mask.  Returns (rows uint32[M, K], overflow)."""
    k = table_l.shape[1]
    owner = jnp.where(gvalid, gids.astype(jnp.int32) // per, d)
    buf, order, owner_s, pos, ovf = _scatter_to_blocks(
        owner, gids.astype(jnp.uint32)[:, None], d, F)
    req = jax.lax.all_to_all(buf, "r", split_axis=0, concat_axis=0)
    my = jax.lax.axis_index("r")
    lid = jnp.clip(req[..., 0].astype(jnp.int32) - my * per, 0, per - 1)
    resp = jax.lax.all_to_all(table_l[lid].astype(jnp.uint32),
                              "r", split_axis=0, concat_axis=0)  # [d, F, K]
    got = resp[jnp.minimum(owner_s, d - 1), jnp.minimum(pos, F - 1)]
    out = jnp.zeros((gids.shape[0], k), jnp.uint32).at[order].set(got)
    return out, jax.lax.psum(ovf, "r")


def _fetch_rows(packed_l, lengths_l, gids, gvalid, per: int, d: int, F: int):
    """Remote gather of packed read rows (+ length as a trailing word) by
    global id; see _fetch_table_rows.  Returns (rows uint32[M, W],
    lens int32[M], overflow)."""
    w = packed_l.shape[1]
    table_l = jnp.concatenate(
        [packed_l.astype(jnp.uint32),
         lengths_l.astype(jnp.uint32)[:, None]], axis=-1)
    out, ovf = _fetch_table_rows(table_l, gids, gvalid, per, d, F)
    return out[:, :w], out[:, w].astype(jnp.int32), ovf


def _funnel_word(rows_pad, start, w: int):
    """Word w of each row's 2-bit stream starting at base `start` —
    row-wise funnel shift (rows_pad uint32[M, W+1], start int32[M])."""
    m = rows_pad.shape[0]
    r = jnp.arange(m, dtype=jnp.int32)
    sw = (start >> 4) + w
    sb = ((start & 15) * 2).astype(jnp.uint32)
    wmax = rows_pad.shape[1] - 1
    lo = rows_pad[r, jnp.minimum(sw, wmax)]
    hi = rows_pad[r, jnp.minimum(sw + 1, wmax)]
    hi_part = jnp.where(sb == 0, jnp.uint32(0), hi << (32 - sb))
    return (lo >> sb) | hi_part


def _substr_eq_rows(rows_a, start_a, rows_b, match_len, num_words: int):
    """bool[M]: rows_a[i][start_a[i] + t] == rows_b[i][t] for t < match_len
    (both operands are materialized per-candidate rows)."""
    m = rows_a.shape[0]
    pad = jnp.zeros((m, 1), jnp.uint32)
    a_pad = jnp.concatenate([rows_a, pad], axis=1)
    ml = match_len.astype(jnp.int32)
    eq = jnp.ones(m, dtype=bool)
    wmax = rows_b.shape[1] - 1
    for w in range(num_words):
        a_word = _funnel_word(a_pad, start_a, w)
        b_word = rows_b[:, min(w, wmax)]
        diff = a_word ^ b_word
        rem = jnp.clip(ml - 16 * w, 0, 16)
        mask = jnp.where(rem >= 16, jnp.uint32(0xFFFFFFFF),
                         (jnp.uint32(1) << (rem.astype(jnp.uint32) * 2)) - 1)
        eq &= (diff & mask) == 0
    return eq


def _segmented_slots(counts, C: int):
    """For capacity C expansion slots over ragged segments sized `counts`
    (int32[n]): returns (seg int32[C] — segment of each slot, clipped;
    rank int32[C]; in_range bool[C])."""
    n = counts.shape[0]
    csum = jnp.cumsum(counts)
    csum_ex = csum - counts
    marks = jnp.zeros(C, dtype=jnp.int32)
    marks = marks.at[jnp.where(counts > 0, csum_ex, C)].add(1, mode="drop")
    j = jnp.cumsum(marks) - 1
    t = jnp.arange(C, dtype=jnp.int32)
    in_range = (t < csum[-1]) & (j >= 0)
    nz_rank = jnp.cumsum((counts > 0).astype(jnp.int32)) - 1
    nz_ids = jnp.zeros(n, dtype=jnp.int32).at[
        jnp.where(counts > 0, nz_rank, n)].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")
    seg = nz_ids[jnp.clip(j, 0, n - 1)]
    rank = t - csum_ex[seg]
    return seg, rank, in_range


# ---------------------------------------------------------------------------
# stage factory (cached per static config)


@lru_cache(maxsize=64)
def _make_stages(mesh: Mesh, d: int, per: int, w_full: int, w_verify: int,
                 k: int, num_windows: int, cap: int, rsoe: int, soes: int):
    spec_r = P("r")
    spec_rn = P("r", None)

    @lru_cache(maxsize=16)
    def stage1_fn(S_suf: int, S_pre: int):
        @jax.jit
        @partial(jax.shard_map, mesh=mesh, check_vma=False,
                 in_specs=(spec_rn, spec_r, spec_r, spec_r),
                 out_specs=(spec_rn, spec_rn, spec_r, spec_r, spec_r,
                            spec_r))
        def stage1(packed_l, lengths_l, af_l, at_l):
            my = jax.lax.axis_index("r")
            base = (my * per).astype(jnp.int32)
            lengths_l = lengths_l.astype(jnp.int32)
            k1, k2, valid = hashes.window_kmer_keys_u32(
                packed_l, lengths_l, k, num_windows)
            pos = jnp.arange(num_windows, dtype=jnp.int32)[None, :]
            wvalid = valid & af_l[:, None] & (pos >= lengths_l[:, None] - cap)
            b_g = jnp.broadcast_to(
                (jnp.arange(per, dtype=jnp.int32) + base)[:, None],
                (per, num_windows))
            ell = jnp.broadcast_to(lengths_l[:, None] - pos,
                                   (per, num_windows))

            fk1 = jnp.minimum(k1.ravel(), jnp.uint32(_KMAX))
            fv = wvalid.ravel()
            owner = jnp.where(fv, (fk1 % d).astype(jnp.int32), d)
            payload = jnp.stack(
                [fk1, k2.ravel(), b_g.ravel().astype(jnp.uint32),
                 ell.ravel().astype(jnp.uint32)], axis=1)
            suf, ovf1 = _route(owner, payload, d, S_suf)

            pvalid = (lengths_l >= k) & at_l
            pk1 = jnp.minimum(k1[:, 0], jnp.uint32(_KMAX))
            powner = jnp.where(pvalid, (pk1 % d).astype(jnp.int32), d)
            ppayload = jnp.stack(
                [pk1, k2[:, 0],
                 (jnp.arange(per, dtype=jnp.int32) + base).astype(jnp.uint32),
                 lengths_l.astype(jnp.uint32)], axis=1)
            pre, ovf2 = _route(powner, ppayload, d, S_pre)

            # owner-local join counting: sort my received window records by
            # key, probe my received prefix keys (fills have key SENT > any
            # valid key, so they sort to the tail and are never probed)
            sk1, sk2, sB, sell = jax.lax.sort(
                (suf[:, 0], suf[:, 1], suf[:, 2], suf[:, 3]), num_keys=1)
            suf_sorted = jnp.stack([sk1, sk2, sB, sell], axis=1)
            pre_ok = pre[:, 2] != jnp.uint32(_SENT)
            lo = jnp.searchsorted(sk1, pre[:, 0], side="left").astype(jnp.int32)
            hi = jnp.searchsorted(sk1, pre[:, 0], side="right").astype(jnp.int32)
            counts = jnp.where(pre_ok, hi - lo, 0)
            return (suf_sorted, pre, lo, counts, counts.sum()[None],
                    (ovf1 + ovf2)[None])
        return stage1

    @lru_cache(maxsize=16)
    def stage2_fn(C: int, F: int):
        @jax.jit
        @partial(jax.shard_map, mesh=mesh, check_vma=False,
                 in_specs=(spec_rn, spec_r, spec_rn, spec_rn, spec_r,
                           spec_r),
                 out_specs=(spec_rn, spec_rn, spec_r))
        def stage2(packed_l, lengths_l, suf_sorted, pre, lo, counts):
            seg, rank, in_range = _segmented_slots(counts, C)
            widx = jnp.clip(lo[seg] + rank, 0, suf_sorted.shape[0] - 1)
            b_gid = suf_sorted[widx, 2]
            ell = suf_sorted[widx, 3].astype(jnp.int32)
            c_gid = pre[seg, 2]
            len_c = pre[seg, 3].astype(jnp.int32)
            ok = (in_range & (b_gid != jnp.uint32(_SENT))
                  & (suf_sorted[widx, 1] == pre[seg, 1])     # k2 check
                  & (b_gid != c_gid) & (len_c >= ell))

            ids = jnp.concatenate([b_gid, c_gid]).astype(jnp.int32)
            gv = jnp.concatenate([ok, ok])
            rows, lens, ovf = _fetch_rows(packed_l, lengths_l, ids, gv,
                                          per, d, F)
            rows_b, rows_c = rows[:C], rows[C:]
            len_b = lens[:C]
            p = jnp.maximum(len_b - ell, 0)
            okv = ok & _substr_eq_rows(rows_b, p,
                                       rows_c, jnp.where(ok, ell, 0),
                                       w_verify)

            # compact matches (src, dst, ell, off) and count per src owner
            nok = jnp.cumsum(okv.astype(jnp.int32))
            out_pos = jnp.where(okv, nok - 1, C)
            match = jnp.full((C, 4), _SENT, dtype=jnp.uint32)
            match = match.at[out_pos, 0].set(b_gid, mode="drop")
            match = match.at[out_pos, 1].set(c_gid, mode="drop")
            match = match.at[out_pos, 2].set(ell.astype(jnp.uint32),
                                             mode="drop")
            match = match.at[out_pos, 3].set(
                (len_b - ell).astype(jnp.uint32), mode="drop")
            owner = jnp.where(okv, b_gid.astype(jnp.int32) // per, d)
            cnt = jnp.zeros(d + 1, jnp.int32).at[owner].add(1)[:d]
            return match[None], cnt[None], ovf[None]
        return stage2

    @lru_cache(maxsize=16)
    def stage3_fn(S_match: int):
        @jax.jit
        @partial(jax.shard_map, mesh=mesh, check_vma=False,
                 in_specs=(spec_rn,),
                 out_specs=(spec_rn, spec_rn, spec_r, spec_r))
        def stage3(match_buf):
            # route matches to their src-owner shard
            match_buf = match_buf[0]          # local [1, C, 4] -> [C, 4]
            src = match_buf[:, 0]
            mval = src != jnp.uint32(_SENT)
            owner = jnp.where(mval, src.astype(jnp.int32) // per, d)
            recv, ovf = _route(owner, match_buf, d, S_match)
            lm = recv.shape[0]
            rsrc = recv[:, 0]
            rdst = recv[:, 1]
            rell = recv[:, 2].astype(jnp.int32)
            roff = recv[:, 3]
            rv = rsrc != jnp.uint32(_SENT)

            # regime-1 ring survivors: per src, last `soes` matches with
            # ell < rsoe in canonical (ell asc, dst asc) order
            r1 = rv & (rell < rsoe)
            s_src, s_ell, s_dst, s_off = jax.lax.sort(
                (jnp.where(r1, rsrc, jnp.uint32(_SENT)),
                 jnp.where(r1, recv[:, 2], jnp.uint32(_SENT)),
                 jnp.where(r1, rdst, jnp.uint32(_SENT)),
                 roff), num_keys=3)
            t = jnp.arange(lm, dtype=jnp.int32)
            is_start = jnp.concatenate(
                [jnp.ones(1, bool), s_src[1:] != s_src[:-1]])
            gid = jnp.cumsum(is_start.astype(jnp.int32)) - 1
            glast = jnp.zeros(lm, dtype=jnp.int32).at[gid].max(t)
            ring_keep = (s_src != jnp.uint32(_SENT)) & (glast[gid] - t < soes)

            # pair instances = ring survivors + regime-2 matches;
            # dedup (src, dst) keeping max ell
            r2 = rv & (rell >= rsoe)
            inst_src = jnp.concatenate(
                [jnp.where(ring_keep, s_src, jnp.uint32(_SENT)),
                 jnp.where(r2, rsrc, jnp.uint32(_SENT))])
            inst_dst = jnp.concatenate(
                [jnp.where(ring_keep, s_dst, jnp.uint32(_SENT)),
                 jnp.where(r2, rdst, jnp.uint32(_SENT))])
            inst_ell = jnp.concatenate(
                [jnp.where(ring_keep, s_ell, jnp.uint32(_SENT)),
                 jnp.where(r2, recv[:, 2], jnp.uint32(_SENT))])
            inst_off = jnp.concatenate([s_off, roff])
            psrc, pdst, pell, poff = jax.lax.sort(
                (inst_src, inst_dst, inst_ell, inst_off), num_keys=3)
            is_last = jnp.concatenate(
                [(psrc[:-1] != psrc[1:]) | (pdst[:-1] != pdst[1:]),
                 jnp.ones(1, bool)])
            pv = is_last & (psrc != jnp.uint32(_SENT))
            pairs = jnp.stack(
                [jnp.where(pv, psrc, jnp.uint32(_SENT)),
                 jnp.where(pv, pdst, jnp.uint32(_SENT)),
                 jnp.where(pv, pell, jnp.uint32(_SENT)),
                 poff], axis=1)
            removers = jnp.stack(
                [jnp.where(r2, rsrc, jnp.uint32(_SENT)),
                 jnp.where(r2, rdst, jnp.uint32(_SENT)),
                 jnp.where(r2, recv[:, 2], jnp.uint32(_SENT)),
                 roff], axis=1)

            pcnt = jnp.zeros(d + 1, jnp.int32).at[
                jnp.where(pv, pdst.astype(jnp.int32) // per, d)].add(1)[:d]
            rcnt = jnp.zeros(d + 1, jnp.int32).at[
                jnp.where(r2, rdst.astype(jnp.int32) // per, d)].add(1)[:d]
            return pairs[None], removers[None], jnp.stack([pcnt, rcnt])[None].reshape(1, -1), ovf[None]
        return stage3

    @lru_cache(maxsize=16)
    def stage4_fn(S_pair: int, S_rem: int):
        @jax.jit
        @partial(jax.shard_map, mesh=mesh, check_vma=False,
                 in_specs=(spec_rn, spec_rn),
                 out_specs=(spec_rn, spec_rn, spec_r, spec_r, spec_r,
                            spec_r))
        def stage4(pairs_in, removers_in):
            pairs_in = pairs_in[0]            # local [1, L, 4] -> [L, 4]
            removers_in = removers_in[0]
            my = jax.lax.axis_index("r")
            base = (my * per).astype(jnp.int32)

            pv_in = pairs_in[:, 0] != jnp.uint32(_SENT)
            powner = jnp.where(
                pv_in, pairs_in[:, 1].astype(jnp.int32) // per, d)
            pairs, ovf1 = _route(powner, pairs_in, d, S_pair)
            rv_in = removers_in[:, 0] != jnp.uint32(_SENT)
            rowner = jnp.where(
                rv_in, removers_in[:, 1].astype(jnp.int32) // per, d)
            rem, ovf2 = _route(rowner, removers_in, d, S_rem)

            # removers sorted by (local dst, off) carrying (src, ell)
            rval = rem[:, 0] != jnp.uint32(_SENT)
            rd_l = jnp.where(
                rval, rem[:, 1].astype(jnp.int32) - base, per).astype(jnp.uint32)
            rd_s, ro_s, rs_s, re_s = jax.lax.sort(
                (rd_l, jnp.where(rval, rem[:, 3], jnp.uint32(_SENT)),
                 rem[:, 0], rem[:, 2]), num_keys=2)
            r_counts = jnp.zeros(per + 1, jnp.int32).at[
                jnp.minimum(rd_s.astype(jnp.int32), per)].add(1)[:per]
            r_start = jnp.cumsum(r_counts) - r_counts
            rem_sorted = jnp.stack([rs_s, re_s, ro_s], axis=1)

            # merged rank: eligible removers per pair = removers earlier in
            # the same dst group under (dst, off, tag) order (remover tag 0)
            pval = pairs[:, 0] != jnp.uint32(_SENT)
            lp = pairs.shape[0]
            pd_l = jnp.where(
                pval, pairs[:, 1].astype(jnp.int32) - base, per).astype(jnp.uint32)
            u_dst = jnp.concatenate([rd_s, pd_l])
            u_off = jnp.concatenate(
                [ro_s, jnp.where(pval, pairs[:, 3], jnp.uint32(_SENT))])
            u_tag = jnp.concatenate(
                [jnp.zeros_like(rd_s), jnp.ones(lp, dtype=jnp.uint32)])
            u_idx = jnp.concatenate(
                [jnp.zeros(rd_s.shape[0], jnp.int32),
                 jnp.arange(lp, dtype=jnp.int32)])
            sd, so, st, si = jax.lax.sort((u_dst, u_off, u_tag, u_idx),
                                          num_keys=3)
            rem_before = jnp.cumsum((st == 0).astype(jnp.int32))
            grp_start = jnp.concatenate(
                [jnp.ones(1, bool), sd[1:] != sd[:-1]])
            ggid = jnp.cumsum(grp_start.astype(jnp.int32)) - 1
            grp_base = jnp.full(sd.shape[0], np.int32(2**31 - 1),
                                dtype=jnp.int32).at[ggid].min(
                rem_before - (st == 0).astype(jnp.int32), mode="drop")
            elig = rem_before - grp_base[ggid]
            is_pair = (st == 1) & (sd != jnp.uint32(per))
            cnt = jnp.zeros(lp, dtype=jnp.int32).at[
                jnp.where(is_pair, si, lp)].set(
                jnp.where(is_pair, elig, 0), mode="drop")
            cnt = jnp.where(pval, cnt, 0)
            return (pairs, rem_sorted, r_start, cnt, cnt.sum()[None],
                    (ovf1 + ovf2)[None])
        return stage4

    @lru_cache(maxsize=16)
    def stage5_fn(C3: int, F: int):
        @jax.jit
        @partial(jax.shard_map, mesh=mesh, check_vma=False,
                 in_specs=(spec_rn, spec_r, spec_rn, spec_rn, spec_r,
                           spec_r),
                 out_specs=(spec_rn, spec_r, spec_r))
        def stage5(packed_l, lengths_l, pairs, rem_sorted, r_start, cnt):
            my = jax.lax.axis_index("r")
            base = (my * per).astype(jnp.int32)
            lp = pairs.shape[0]

            pj, rank, in_range = _segmented_slots(cnt, C3)
            a_gid = pairs[pj, 0]
            ell_a = pairs[pj, 2].astype(jnp.int32)
            off_a = pairs[pj, 3].astype(jnp.int32)
            dst_l = jnp.clip(pairs[pj, 1].astype(jnp.int32) - base, 0,
                             per - 1)
            ridx = jnp.clip(r_start[dst_l] + rank, 0,
                            rem_sorted.shape[0] - 1)
            b_gid = rem_sorted[ridx, 0]
            ell_b = rem_sorted[ridx, 1].astype(jnp.int32)
            off_b = rem_sorted[ridx, 2].astype(jnp.int32)
            len_a = off_a + ell_a
            len_b = off_b + ell_b

            later = (ell_b > ell_a) | ((ell_b == ell_a) & (b_gid > a_gid))
            cond = (in_range & later & (b_gid != a_gid) & (off_b > 0)
                    & (off_a >= off_b)
                    & (len_b + (off_a - off_b) - len_a >= 0))

            ids = jnp.concatenate([a_gid, b_gid]).astype(jnp.int32)
            gv = jnp.concatenate([cond, cond])
            rows, _, ovf = _fetch_rows(packed_l, lengths_l, ids, gv,
                                       per, d, F)
            dominated = cond & _substr_eq_rows(
                rows[:C3], jnp.maximum(off_a - off_b, 0),
                rows[C3:], jnp.where(cond, off_b, 0), w_verify)

            removed = jnp.zeros(lp, dtype=bool).at[
                jnp.where(dominated, pj, lp)].set(True, mode="drop")
            pval = pairs[:, 0] != jnp.uint32(_SENT)
            keep = pval & ~removed
            nkeep = jnp.cumsum(keep.astype(jnp.int32))
            out_pos = jnp.where(keep, nkeep - 1, lp)
            out = jnp.full((lp, 3), _SENT, dtype=jnp.uint32)
            out = out.at[out_pos, 0].set(pairs[:, 0], mode="drop")
            out = out.at[out_pos, 1].set(pairs[:, 1], mode="drop")
            out = out.at[out_pos, 2].set(pairs[:, 3], mode="drop")
            return out[None], nkeep[-1][None], ovf[None]
        return stage5

    return stage1_fn, stage2_fn, stage3_fn, stage4_fn, stage5_fn


def gcps_graph_sharded(mesh: Mesh, packed_np, lengths_np, n: int,
                       ell_min: int, cap: int, rsoe: int, soes: int = 3,
                       align_from=None, align_to=None):
    """Multi-device twin of build_gcps_graph with O(N/d) per-device memory.

    Returns an OverlapGraph with the same edge set as the single-device
    path (canonical (src, offset, dst) order).
    """
    from alga_tpu.graph.overlap_graph import OverlapGraph

    d = int(mesh.devices.size)
    lengths = np.asarray(lengths_np, dtype=np.int32)
    max_len = int(lengths.max()) if n else 0
    k = int(ell_min)
    if n == 0 or max_len < k:
        return OverlapGraph.empty(n)

    af = np.ones(n, bool) if align_from is None else np.asarray(align_from, bool)
    at = np.ones(n, bool) if align_to is None else np.asarray(align_to, bool)

    shard = NamedSharding(mesh, P("r", None))
    shard1 = NamedSharding(mesh, P("r"))
    if isinstance(packed_np, jax.Array):
        # pre-sharded device store (the distributed pipeline's ingest
        # layout): rows beyond n are padding; masks cover validity
        npad = int(packed_np.shape[0])
        assert npad % d == 0
        packed_d = packed_np
        w_full = int(packed_np.shape[1])
        pad = npad - len(lengths)
        if pad:
            lengths = np.append(lengths, np.zeros(pad, np.int32))
            af = np.append(af, np.zeros(pad, bool))
            at = np.append(at, np.zeros(pad, bool))
    else:
        # pad reads to a multiple of the mesh size (length 0 => never joins)
        npad = -(-n // d) * d
        if npad != n:
            packed_np = np.vstack(
                [packed_np, np.zeros((npad - n, packed_np.shape[1]),
                                     dtype=packed_np.dtype)])
            lengths = np.append(lengths, np.zeros(npad - n, np.int32))
            af = np.append(af, np.zeros(npad - n, bool))
            at = np.append(at, np.zeros(npad - n, bool))
        w_full = packed_np.shape[1]
        packed_d = _put(np.ascontiguousarray(packed_np), shard)
    per = npad // d

    num_windows = max_len - k + 1
    w_verify = packing.words_for(min(max_len, cap))

    lengths_d = _put(lengths, shard1)
    af_d = _put(af, shard1)
    at_d = _put(at, shard1)

    s1f, s2f, s3f, s4f, s5f = _make_stages(
        mesh, d, per, w_full, w_verify, k, num_windows, int(cap), int(rsoe),
        int(soes))

    # ---- stage 1: route records, owner-local sort, candidate counts -----
    # ALGA_SHARDED_TINY_CAPS shrinks the initial capacity estimates so the
    # overflow-retry loops fire deterministically (dryrun/test coverage of
    # the retry machinery, VERDICT r3 item 7)
    import os as _os
    _shrink = int(_os.environ.get("ALGA_SHARDED_TINY_CAPS", "0") or 0)
    from alga_tpu.utils.timers import bump as _bump
    # placement evidence: the store's rows vs the rows the fullest local
    # device holds (== npad / d when the store is block-sharded)
    _bump("sharded_store_rows", npad)
    _bump("sharded_store_rows_max_device",
          max(sh.data.shape[0] for sh in packed_d.addressable_shards))
    s_suf = _round_cap(per * num_windows // d * 13 // 10 + 64)
    s_pre = _round_cap(per // d * 13 // 10 + 64)
    if _shrink:
        s_suf = s_pre = 256
    n_s1 = 0
    while True:
        suf, pre, lo, counts, cand_tot, ovf = s1f(s_suf, s_pre)(
            packed_d, lengths_d, af_d, at_d)
        if int(_host(ovf).max()) == 0:
            break
        s_suf *= 2
        s_pre *= 2
        n_s1 += 1
        _bump("sharded_gcps_retries", 1)
    c_cap = _round_cap(int(_host(cand_tot).max()))

    # ---- stage 2: expand + fetch rows + exact verify ---------------------
    f2 = _round_cap(2 * c_cap // d * 3 // 2 + 64)
    if _shrink:
        f2 = 256
    n_s2 = 0
    while True:
        match_buf, mcnt, ovf = s2f(c_cap, f2)(
            packed_d, lengths_d, suf, pre, lo, counts)
        if int(_host(ovf).max()) == 0:
            break
        f2 *= 2
        n_s2 += 1
        _bump("sharded_gcps_retries", 1)
    s_match = _round_cap(int(_host(mcnt).max()))

    # ---- stage 3: route by src owner; ring + dedup; count by dst owner ---
    n_s3 = 0
    while True:
        pairs, removers, prcnt, ovf = s3f(s_match)(match_buf)
        if int(_host(ovf).max()) == 0:
            break
        s_match *= 2
        n_s3 += 1
        _bump("sharded_gcps_retries", 1)
    prcnt = _host(prcnt).reshape(d, 2, d)
    s_pair = _round_cap(int(prcnt[:, 0, :].max()))
    s_rem = _round_cap(int(prcnt[:, 1, :].max()))

    # ---- stage 4: route pairs/removers by dst; eligible-remover counts ---
    pairs_r, rem_sorted, r_start, cnt, exp_tot, ovf = s4f(s_pair, s_rem)(
        pairs, removers)
    assert int(_host(ovf).max()) == 0   # capacities are exact counts
    c3 = _round_cap(int(_host(exp_tot).max()))

    # ---- stage 5: domination expand + fetch + compare + compact ----------
    # domination requests cluster on hot reads, so start with 2x slack
    f5 = _round_cap(2 * c3 // d * 2 + 64)
    if _shrink:
        f5 = 256
    n_s5 = 0
    while True:
        out, nkeep, ovf = s5f(c3, f5)(
            packed_d, lengths_d, pairs_r, rem_sorted, r_start, cnt)
        if int(_host(ovf).max()) == 0:
            break
        f5 *= 2
        n_s5 += 1
        _bump("sharded_gcps_retries", 1)

    # ---- collective-volume ledger (VERDICT r3 item 10) -------------------
    # gross bytes moved by each all_to_all stage at the capacities actually
    # executed (retries included): a _route moves one [d, S, F] u32 buffer
    # per device; a fetch moves a request [d, F, 1] plus a response
    # [d, F, w_full+1].  Cross-device traffic is (d-1)/d of gross (the
    # diagonal block stays local).  Counters are cumulative per process.
    u32 = 4
    ledger = {
        "s1_route_windows": d * d * s_suf * 4 * u32 * (n_s1 + 1),
        "s1_route_prefixes": d * d * s_pre * 4 * u32 * (n_s1 + 1),
        "s2_fetch_rows": d * d * f2 * (1 + w_full + 1) * u32 * (n_s2 + 1),
        "s3_route_matches": d * d * s_match * 4 * u32 * (n_s3 + 1),
        "s4_route_pairs": d * d * (s_pair + s_rem) * 4 * u32,
        "s5_fetch_rows": d * d * f5 * (1 + w_full + 1) * u32 * (n_s5 + 1),
    }
    total_bytes = sum(ledger.values())
    cross = total_bytes * (d - 1) // d if d > 1 else 0
    for k_, v_ in ledger.items():
        _bump(f"a2a_bytes_{k_}", v_)
    _bump("a2a_bytes_gcps_total", total_bytes)
    _bump("a2a_bytes_gcps_cross_device", cross)

    out = _host(out).reshape(d, -1, 3)
    nkeep = _host(nkeep)
    srcs, dsts, offs = [], [], []
    for s in range(d):
        m = int(nkeep[s])
        srcs.append(out[s, :m, 0])
        dsts.append(out[s, :m, 1])
        offs.append(out[s, :m, 2])
    return OverlapGraph(
        n,
        np.concatenate(srcs).astype(np.int32),
        np.concatenate(dsts).astype(np.int32),
        np.concatenate(offs).astype(np.int32),
    ).sorted_by_src_offset()
