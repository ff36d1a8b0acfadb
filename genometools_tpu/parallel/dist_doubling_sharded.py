"""Position-sharded distributed prefix-doubling suffix sort.

The genuinely scaling engine (successor of dist_doubling.py's
replicated-rank design): every per-device array here is O(n/P) and every
per-round exchange moves O(n/P) bytes per device, so both memory and
traffic shrink with the mesh — the mesh-native answer to the reference's
`-parts`/`-memlimit` partitioner (ref: src/match/sfx-partssuf.c:172),
which bounds memory by processing code ranges sequentially; here the
"parts" run concurrently on the mesh instead.

Design:

  * the rank array lives position-sharded: device m owns ranks of
    positions [m*C, (m+1)*C), C = n/P;
  * `rank[i+h]` for a whole block is a *shifted block fetch* — two
    `ppermute`s to the neighbors h/C and h/C + 1 blocks away, no
    all_to_all;
  * the per-round (rank, rank[i+h], pos) tuple sort is a **block-bitonic
    distributed sort**: each device keeps a sorted C-block and the
    bitonic network on P blocks runs merge-split compare-exchanges
    (ppermute partner block, sort 2C, keep low/high half).  By the 0-1
    principle the block network sorts any input, so there is NO skew
    sensitivity and NO overflow path — every step moves exactly C
    items per device, log2(P)*(log2(P)+1)/2 steps;
  * dense re-ranking stitches group boundaries across devices with one
    left-neighbor ppermute + an all_gather of P scalars;
  * the new ranks ride back to their position owners as a second
    block-bitonic sort keyed on position (positions are a permutation,
    so the sorted blocks ARE the owner blocks);
  * the rounds are one lax.while_loop (one compiled round body, h
    carried as a traced (h // C, h % C) pair) that stops once the
    replicated distinct-count says every rank is unique.

Exactness: byte-identical suffix arrays vs the single-chip doubling
engine (tests/test_parallel.py), which itself is golden-verified against
the reference `gt suffixerator` output.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

_BOOT = 4  # bootstrap prefix width (matches index.suffix._BOOT semantics)


def _block_bitonic_sort(arrs, num_keys: int, nP: int, axis: str, C: int):
    """Distributed sort of nP C-blocks of int32 tuple arrays.

    Each device holds one block; returns the globally sorted sequence's
    m-th block on device m. Merge-split bitonic network over sorted
    blocks (0-1 principle => sorts all inputs)."""
    arrs = list(jax.lax.sort(tuple(arrs), num_keys=num_keys))
    logp = nP.bit_length() - 1
    my = jax.lax.axis_index(axis)
    for k in range(1, logp + 1):
        for j in range(k - 1, -1, -1):
            perm = [(i, i ^ (1 << j)) for i in range(nP)]
            recv = [jax.lax.ppermute(a, axis, perm) for a in arrs]
            partner = my ^ (1 << j)
            low_first = my < partner
            # canonical concat order (lower device id first): both
            # partners must sort the IDENTICAL tuple sequence, or tied
            # keys resolve differently on the two sides and the
            # low/high split duplicates one payload and drops another
            merged = jax.lax.sort(
                tuple(jnp.concatenate([jnp.where(low_first, a, r),
                                       jnp.where(low_first, r, a)])
                      for a, r in zip(arrs, recv)),
                num_keys=num_keys)
            dir_up = ((my >> k) & 1) == 0
            keep_low = dir_up == low_first
            arrs = [jnp.where(keep_low, a[:C], a[C:]) for a in merged]
    return arrs


def _shifted_fetch(blk, q, r, nP: int, axis: str, C: int, fill):
    """out[j] = global_array[m*C + j + h] for h = q*C + r, r in [0, C)
    (fill beyond the end).

    The two source blocks are the neighbors m+q, m+q+1: two ppermutes
    move exactly one block per device.  q and r may be traced
    (replicated) scalars, so one compiled round serves every shift: q
    then picks one of nP static ppermute pairs through lax.switch."""
    def fetch(qq: int):
        def branch(x):
            a = (jax.lax.ppermute(x, axis, [(i, i - qq)
                                            for i in range(qq, nP)])
                 if qq < nP else jnp.zeros_like(x))
            b = (jax.lax.ppermute(x, axis, [(i, i - qq - 1)
                                            for i in range(qq + 1, nP)])
                 if qq + 1 < nP else jnp.zeros_like(x))
            return jnp.concatenate([a, b])
        return branch

    if isinstance(q, int):
        ab = fetch(q)(blk)
    else:
        ab = jax.lax.switch(jnp.minimum(q, nP - 1),
                            [fetch(qq) for qq in range(nP)], blk)
    out = jax.lax.dynamic_slice(ab, (r,), (C,))
    # source device of out[j]: m+q while j + r < C, else m+q+1
    # (position arithmetic in block units, so no int overflow at n > 2^31)
    my = jax.lax.axis_index(axis)
    src = my + q + (jnp.arange(C, dtype=jnp.int32) >= C - r)
    return jnp.where(src < nP, out, fill)


def _double_shift(q, r, C: int):
    """(q, r) of h*2 given h = q*C + r, without forming h."""
    carry = r >= C - r
    return 2 * q + carry.astype(jnp.int32), jnp.where(carry, r - (C - r),
                                                        r + r)


def _doubling_rounds(round_body, carry, n1: int, nP: int, C: int):
    """Run round_body(h_q, h_r, carry) -> (carry, done) for h = _BOOT,
    2*_BOOT, ... while h < n1 and not done, as one lax.while_loop (one
    compiled round, however many rounds the input needs)."""
    q0, r0 = divmod(_BOOT, C)

    def cond(state):
        q, _, _, done = state
        return jnp.logical_not(done) & (q < nP)

    def body(state):
        q, r, c, _ = state
        c, done = round_body(q, r, c)
        q2, r2 = _double_shift(q, r, C)
        return q2, r2, c, done

    init = (jnp.int32(q0), jnp.int32(r0), carry, jnp.zeros((), jnp.bool_))
    return jax.lax.while_loop(cond, body, init)[2]


def _dense_rank_stitched(sorted_keys, nP: int, axis: str, C: int):
    """Dense 0-based ranks of globally sorted tuple blocks + the global
    distinct count (replicated). sorted_keys: list of int32[C]."""
    my = jax.lax.axis_index(axis)
    start = jnp.zeros(C, jnp.bool_)
    neq = jnp.zeros(C - 1, jnp.bool_)
    for s in sorted_keys:
        neq = neq | (s[1:] != s[:-1])
    start = start.at[1:].set(neq)
    # boundary: last tuple of the left neighbor
    perm = [(i, i + 1) for i in range(nP - 1)]
    prev = [jax.lax.ppermute(s[-1], axis, perm) for s in sorted_keys]
    first_differs = jnp.zeros((), jnp.bool_)
    for s, p in zip(sorted_keys, prev):
        first_differs = first_differs | (s[0] != p)
    start = start.at[0].set((my == 0) | first_differs)
    local_cum = jnp.cumsum(start.astype(jnp.int32))
    local_total = local_cum[-1]
    totals = jax.lax.all_gather(local_total, axis)
    offset = jnp.where(jnp.arange(nP) < my, totals, 0).sum()
    return offset + local_cum - 1, jax.lax.psum(local_total, axis)


@partial(jax.jit, static_argnames=("n1", "mesh"))
def sharded_build_sa(keys: jnp.ndarray, n1: int, mesh: Mesh):
    """Position-sharded prefix doubling. keys: int32[n1] (sharded or
    replicated on entry; consumed shard-wise), n1 a multiple of the mesh
    size (pad like index.suffix.build_suffix_array). Returns the suffix
    array sharded over mesh axis 'shard'."""
    nP = mesh.devices.size
    assert n1 % nP == 0 and nP & (nP - 1) == 0
    C = n1 // nP

    def stage(keys_blk):
        keys_blk = keys_blk.reshape(C)
        my = jax.lax.axis_index("shard")
        pos = (my * C + jnp.arange(C, dtype=jnp.int32)).astype(jnp.int32)

        # bootstrap: rank by the first _BOOT symbol keys
        kcols = [keys_blk]
        for j in range(1, _BOOT):
            kcols.append(_shifted_fetch(keys_blk, *divmod(j, C), nP,
                                        "shard", C, np.int32(-1)))
        srt = _block_bitonic_sort(kcols + [pos], _BOOT, nP, "shard", C)
        skeys, spos = srt[:_BOOT], srt[_BOOT]
        nr, _ = _dense_rank_stitched(skeys, nP, "shard", C)
        back = _block_bitonic_sort([spos, nr], 1, nP, "shard", C)
        rank_blk = back[1]

        def round_body(q, r, rank_blk):
            r2 = _shifted_fetch(rank_blk, q, r, nP, "shard", C,
                                np.int32(-1))
            s1, s2, sp = _block_bitonic_sort([rank_blk, r2, pos], 2, nP,
                                             "shard", C)
            nr, distinct = _dense_rank_stitched([s1, s2], nP, "shard", C)
            _, nrank = _block_bitonic_sort([sp, nr], 1, nP, "shard", C)
            return nrank, distinct == n1

        rank_blk = _doubling_rounds(round_body, rank_blk, n1, nP, C)

        # SA: sort (rank, pos) by rank; rank is a permutation when done
        _, sa_blk = _block_bitonic_sort([rank_blk, pos], 1, nP, "shard", C)
        return sa_blk

    return jax.shard_map(stage, mesh=mesh, in_specs=(P("shard"),),
                         out_specs=P("shard"), check_vma=False)(keys)



# ---------------------------------------------------------------------------
# sample-sort exchange (the round-3 default): splitter broadcast + two-hop
# balanced all_to_all of bucketed tuples, with an invertible return path
#
# The block-bitonic network above moves C items per device on EVERY
# merge-split step — log2(P)*(log2(P)+1)/2 steps per round, so per-device
# traffic GROWS with the mesh. Here each distributed sort becomes:
#
#   local sort -> P regular samples/device -> all_gather(P^2 samples) ->
#   P-1 splitters -> route rows to the splitter's bucket owner -> local
#   sort of the ~C received rows,
#
# i.e. the classic PSRS sample sort expressed as JAX collectives — the
# same role the reference's threaded radix parts + GtRadixreader merge
# play on one host (ref: src/core/radix_sort.c:463-530).
#
# Two design points beyond textbook PSRS:
#
#   * **Two-hop balanced routing.** XLA's tiled all_to_all needs a static
#     per-(src,dst) capacity, but a single hop cannot bound it below C:
#     already-sorted regions (e.g. the pad tail, or rank plateaus on
#     repetitive data) put a whole C-block into one splitter interval.
#     Routing each (src, final-dest) class round-robin over P
#     intermediates first caps BOTH hops at ceil(rows/P) + P rows per
#     pair BY CONSTRUCTION (hop 1: a source spreads every class evenly;
#     hop 2: an intermediate holds <= ceil(m_ik/P)+1 rows of any class),
#     so there is no data-dependent overflow for ANY input — the skew
#     immunity of the bitonic network at ~1/P of its traffic. An
#     overflow flag is still computed and checked (belt and braces).
#   * **Invertible return path.** Positions never travel: the two
#     forward all_to_alls define a slot-level permutation, and tiled
#     all_to_all over the (P, K) block layout is an involution, so the
#     receiver returns each row's new dense rank through the same
#     buffers (one int32 plane) and the source unscatters it straight
#     into its position block. Per-round traffic: forward (rank, r2)
#     planes + one return plane ~= 5C int32 per device, independent of P
#     (vs 5C * log^2(P)/2 for the bitonic engine).
# ---------------------------------------------------------------------------

_SENTINEL = np.int32(2 ** 31 - 1)


def _route(cols, dest, valid, K: int, nP: int, axis: str):
    """One-hop bucket route at per-(src,dst) capacity K.

    Returns (recv_cols [nP*K] each, recv_valid, overflow, ctx); ctx lets
    _route_back deliver one int32 plane from receivers back to this
    call's input rows."""
    S = dest.shape[0]
    d = jnp.where(valid, dest, np.int32(nP))
    order = jnp.argsort(d, stable=True)
    d_s = d[order]
    counts = jnp.zeros(nP + 1, jnp.int32).at[d_s].add(1)
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32),
                              jnp.cumsum(counts)[:-1]])
    within = jnp.arange(S, dtype=jnp.int32) - starts[d_s]
    overflow = jnp.any((d_s < nP) & (within >= K))
    row = jnp.where(within < K, d_s, np.int32(nP))   # ghost row drops
    col = jnp.minimum(within, K - 1)
    recv = []
    for c in list(cols) + [jnp.ones(S, jnp.int32)]:   # last: validity
        buf = jnp.full((nP + 1, K), _SENTINEL, jnp.int32)
        buf = buf.at[row, col].set(c[order])
        got = jax.lax.all_to_all(buf[:nP], axis, 0, 0, tiled=True)
        recv.append(got.reshape(-1))
    rvalid = recv[-1] == 1
    return recv[:-1], rvalid, overflow, (order, row, col, S)


def _route_back(vals, ctx, K: int, nP: int, axis: str):
    """Return one int32 plane from receiver slots to the matching
    _route call's input rows (undefined where that input was invalid)."""
    order, row, col, S = ctx
    ret = jax.lax.all_to_all(vals.reshape(nP, K), axis, 0, 0,
                             tiled=True).reshape(-1)
    idx = jnp.minimum(row, nP - 1) * K + col
    picked = jnp.where(row < nP, ret[idx], np.int32(0))
    return jnp.zeros(S, jnp.int32).at[order].set(picked)


def _cap(rows: int, nP: int) -> int:
    """Per-pair capacity covering the two-hop worst case with margin."""
    return -(-rows // nP) + 2 * nP


def _route2(cols, dest, valid, src_max: int, dst_max: int, nP: int,
            axis: str):
    """Two-hop balanced route (see module comment). Worst-case per-pair
    rows: hop1 <= src_max/P + P, hop2 <= dst_max/P + P + small — both
    inside _cap. Returns (recv_cols, recv_valid, overflow, ctx)."""
    S = dest.shape[0]
    d = jnp.where(valid, dest, np.int32(nP))
    order0 = jnp.argsort(d, stable=True)
    d0 = d[order0]
    counts0 = jnp.zeros(nP + 1, jnp.int32).at[d0].add(1)
    starts0 = jnp.concatenate([jnp.zeros(1, jnp.int32),
                               jnp.cumsum(counts0)[:-1]])
    within0 = jnp.arange(S, dtype=jnp.int32) - starts0[d0]
    inter = within0 % nP                   # round-robin per dest class
    cols0 = [c[order0] for c in cols] + [d0]
    valid0 = d0 < nP
    K1 = _cap(src_max, nP)
    recv1, v1, o1, ctx1 = _route(cols0, inter, valid0, K1, nP, axis)
    fdest = recv1[-1]
    K2 = _cap(dst_max, nP)
    recv2, v2, o2, ctx2 = _route(recv1[:-1], fdest, v1, K2, nP, axis)
    return recv2, v2, o1 | o2, (order0, ctx1, ctx2, K1, K2, S)


def _route2_back(vals, ctx, nP: int, axis: str):
    order0, ctx1, ctx2, K1, K2, S = ctx
    mid = _route_back(vals, ctx2, K2, nP, axis)      # at intermediates
    src = _route_back(mid, ctx1, K1, nP, axis)       # at sources (d-order)
    return jnp.zeros(S, jnp.int32).at[order0].set(src)


def _splitters(sorted_cols, nP: int, axis: str, C: int):
    """P-1 splitter tuples from P regular samples per device (classic
    PSRS regular sampling); sorted_cols are fully-valid sorted C-blocks
    whose trailing column makes rows globally distinct."""
    idxs = (jnp.arange(nP, dtype=jnp.int32) * C) // nP
    gath = [jax.lax.all_gather(s[idxs], axis).reshape(-1)
            for s in sorted_cols]
    ss = jax.lax.sort(tuple(gath), num_keys=len(gath))
    spl_idx = jnp.arange(1, nP, dtype=jnp.int32) * nP
    return [s[spl_idx] for s in ss]


def _dest_lex(cols, spl, nspl: int):
    """dest[i] = number of splitter tuples <=_lex row i (unrolled over
    the nP-1 splitters; elementwise, no gathers)."""
    S = cols[0].shape[0]
    dest = jnp.zeros(S, jnp.int32)
    for j in range(nspl):
        eq = jnp.ones(S, jnp.bool_)
        gt = jnp.zeros(S, jnp.bool_)
        for c, s in zip(cols, spl):
            sj = s[j]
            gt = gt | (eq & (c > sj))
            eq = eq & (c == sj)
        dest = dest + (gt | eq).astype(jnp.int32)
    return dest


def _dense_rank_ragged(skeys, svalid, nP: int, axis: str):
    """Dense 0-based global ranks over ragged sorted blocks (valid rows
    form a prefix; empty devices allowed). skeys: group-defining key
    columns. Returns (ranks_in_sorted_order, global distinct count)."""
    M = svalid.shape[0]
    my = jax.lax.axis_index(axis)
    neq = jnp.zeros(M, jnp.bool_)
    for s in skeys:
        neq = neq.at[1:].set(neq[1:] | (s[1:] != s[:-1]))
    R = svalid.sum().astype(jnp.int32)
    last = [jnp.where(R > 0, s[jnp.maximum(R - 1, 0)], np.int32(-1))
            for s in skeys]
    lasts = [jax.lax.all_gather(x, axis) for x in last]
    counts = jax.lax.all_gather(R, axis)
    idxs = jnp.arange(nP, dtype=jnp.int32)
    jl = jnp.max(jnp.where((idxs < my) & (counts > 0), idxs, -1))
    first_differs = jl < 0                 # no earlier non-empty device
    for s, l in zip(skeys, lasts):
        first_differs = first_differs | (s[0] != l[jnp.maximum(jl, 0)])
    starts = neq.at[0].set(first_differs) & svalid
    local_cum = jnp.cumsum(starts.astype(jnp.int32))
    totals = jax.lax.all_gather(local_cum[-1], axis)
    offset = jnp.where(idxs < my, totals, 0).sum()
    return offset + local_cum - 1, totals.sum()


def _exchange_rank_roundtrip(keycols, pos, nP: int, axis: str, C: int):
    """One distributed ranking step: sample-sort-route the key tuples,
    dense-rank them at the receivers, return each row's rank to its
    (stationary) position owner. Returns (rank_blk, distinct, ovf)."""
    nk = len(keycols)
    loc = jax.lax.sort(tuple(keycols) + (pos,), num_keys=nk + 1)
    spl = _splitters(list(loc), nP, axis, C)
    dest = _dest_lex(keycols + [pos], spl, nP - 1)
    recv, rvalid, ovf, ctx = _route2(
        keycols, dest, jnp.ones(C, jnp.bool_), C, 2 * C + 2 * nP, nP,
        axis)
    M = recv[0].shape[0]
    slot = jnp.arange(M, dtype=jnp.int32)
    srt = jax.lax.sort(
        (jnp.logical_not(rvalid).astype(jnp.int32),) + tuple(recv)
        + (slot,), num_keys=1 + nk)
    svalid = srt[0] == 0
    ranks_sorted, distinct = _dense_rank_ragged(
        list(srt[1:1 + nk]), svalid, nP, axis)
    vals = jnp.zeros(M, jnp.int32).at[srt[-1]].set(ranks_sorted)
    rank_blk = _route2_back(vals, ctx, nP, axis)
    return rank_blk, distinct, ovf


@partial(jax.jit, static_argnames=("n1", "mesh"))
def sharded_build_sa_sample(keys: jnp.ndarray, n1: int, mesh: Mesh):
    """Position-sharded prefix doubling with sample-sort exchanges.

    Same contract as sharded_build_sa, plus a replicated overflow flag
    (int32 0/1): nonzero would mean an exchange dropped rows — made
    impossible by the two-hop capacity bounds, but verified anyway; the
    host wrapper falls back to the bitonic engine if it ever fires."""
    nP = mesh.devices.size
    assert nP > 1 and n1 % nP == 0
    C = n1 // nP

    def stage(keys_blk):
        keys_blk = keys_blk.reshape(C)
        my = jax.lax.axis_index("shard")
        pos = (my * C + jnp.arange(C, dtype=jnp.int32)).astype(jnp.int32)

        # bootstrap: rank by the first _BOOT symbol keys
        kcols = [keys_blk]
        for j in range(1, _BOOT):
            kcols.append(_shifted_fetch(keys_blk, *divmod(j, C), nP,
                                        "shard", C, np.int32(-1)))
        rank_blk, _, ovf = _exchange_rank_roundtrip(kcols, pos, nP,
                                                    "shard", C)

        def round_body(q, r, carry):
            rank_blk, ovf = carry
            r2 = _shifted_fetch(rank_blk, q, r, nP, "shard", C,
                                np.int32(-1))
            nrank, distinct, o = _exchange_rank_roundtrip(
                [rank_blk, r2], pos, nP, "shard", C)
            return (nrank, ovf | o), distinct == n1

        rank_blk, ovf = _doubling_rounds(round_body, (rank_blk, ovf), n1,
                                         nP, C)

        # SA: rank is a permutation; deliver pos to the rank's owner slot
        dest = jnp.minimum(rank_blk // C, nP - 1)
        recv, rvalid, o3, _ = _route2(
            [rank_blk, pos], dest, jnp.ones(C, jnp.bool_), C,
            C + 2 * nP, nP, "shard")
        rrank, rpos = recv
        slot = jnp.where(rvalid, rrank - my * C, np.int32(C))
        sa_blk = jnp.zeros(C, jnp.int32).at[slot].set(rpos, mode="drop")
        ovf = ovf | o3
        return sa_blk, jax.lax.pmax(ovf.astype(jnp.int32), "shard")

    sa, ovf = jax.shard_map(stage, mesh=mesh, in_specs=(P("shard"),),
                            out_specs=(P("shard"), P()),
                            check_vma=False)(keys)
    return sa, ovf


# ---------------------------------------------------------------------------
# int32-pair lanes for >2^31 positions / key values
#
# jax_enable_x64 is off in this package (int32 lanes were chosen for the
# machine it first ran on, which had no native int64; not yet measured
# against int64 lanes on a GPU) — so the 64-bit path carries
# every wide value as TWO int32 planes (hi, lo) in base C (the block
# size): value = hi*C + lo, lo in [0, C).  Base C makes the routing
# arithmetic free: a rank's owner device IS its hi plane and its slot
# IS its lo plane, so `rank // C` and `rank - my*C` never materialize.
# Comparisons cost nothing extra either: the tuple-sort helpers already
# take column lists, so a wide key is simply two adjacent sort columns.
# Constraint: C < 2^29 per device (so carry sums stay inside int32) —
# far above any real per-device memory budget.
# (ref capability: the reference's GT_LONGLONG suftab mode,
# src/match/sfx-suffixer.c + sfx-partssuf.c int64 part planning.)
# ---------------------------------------------------------------------------


def _pair_carry(hi, lo, C: int):
    """Normalize (hi, lo) so lo lands in [0, C); lo may be up to a few
    multiples of C over/under."""
    return hi + lo // np.int32(C), lo % np.int32(C)


def _dense_rank_ragged_pair(skeys, svalid, nP: int, axis: str, C: int):
    """_dense_rank_ragged with pair-valued ranks: global dense rank of
    each valid sorted row as (hi, lo) base-C planes, plus a replicated
    all-distinct flag (the >2^31-safe replacement for comparing the
    distinct COUNT, which no longer fits int32)."""
    M = svalid.shape[0]
    my = jax.lax.axis_index(axis)
    neq = jnp.zeros(M, jnp.bool_)
    for s in skeys:
        neq = neq.at[1:].set(neq[1:] | (s[1:] != s[:-1]))
    R = svalid.sum().astype(jnp.int32)
    last = [jnp.where(R > 0, s[jnp.maximum(R - 1, 0)], np.int32(-1))
            for s in skeys]
    lasts = [jax.lax.all_gather(x, axis) for x in last]
    counts = jax.lax.all_gather(R, axis)
    idxs = jnp.arange(nP, dtype=jnp.int32)
    jl = jnp.max(jnp.where((idxs < my) & (counts > 0), idxs, -1))
    first_differs = jl < 0
    for s, l in zip(skeys, lasts):
        first_differs = first_differs | (s[0] != l[jnp.maximum(jl, 0)])
    starts = neq.at[0].set(first_differs) & svalid
    local_cum = jnp.cumsum(starts.astype(jnp.int32))
    totals = jax.lax.all_gather(local_cum[-1], axis)
    # base-C pair accumulation of the earlier devices' group counts
    # (unrolled over the static mesh size; each addend < 2^31, carries
    # bounded because C < 2^29)
    off_hi = jnp.zeros((), jnp.int32)
    off_lo = jnp.zeros((), jnp.int32)
    for i in range(nP):
        off_lo = off_lo + jnp.where(np.int32(i) < my, totals[i],
                                    np.int32(0))
        off_hi, off_lo = _pair_carry(off_hi, off_lo, C)
    r_lo = off_lo + local_cum - np.int32(1)
    r_hi, r_lo = _pair_carry(off_hi + jnp.zeros(M, jnp.int32), r_lo, C)
    # all ranks distinct <=> every valid row starts a group
    not_all = jnp.any(svalid & jnp.logical_not(starts))
    all_distinct = jax.lax.pmax(
        not_all.astype(jnp.int32), axis) == np.int32(0)
    return r_hi, r_lo, all_distinct


def _exchange_rank_roundtrip_pair(keycols, poscols, nP: int, axis: str,
                                  C: int):
    """_exchange_rank_roundtrip with pair keys/positions: keycols and
    poscols are int32 plane lists (wide values as adjacent hi,lo
    columns). Returns (rank_hi_blk, rank_lo_blk, all_distinct, ovf)."""
    nk = len(keycols)
    loc = jax.lax.sort(tuple(keycols) + tuple(poscols),
                       num_keys=nk + len(poscols))
    spl = _splitters(list(loc), nP, axis, C)
    dest = _dest_lex(keycols + poscols, spl, nP - 1)
    recv, rvalid, ovf, ctx = _route2(
        keycols, dest, jnp.ones(C, jnp.bool_), C, 2 * C + 2 * nP, nP,
        axis)
    M = recv[0].shape[0]
    slot = jnp.arange(M, dtype=jnp.int32)
    srt = jax.lax.sort(
        (jnp.logical_not(rvalid).astype(jnp.int32),) + tuple(recv)
        + (slot,), num_keys=1 + nk)
    svalid = srt[0] == 0
    r_hi_s, r_lo_s, all_distinct = _dense_rank_ragged_pair(
        list(srt[1:1 + nk]), svalid, nP, axis, C)
    vals_hi = jnp.zeros(M, jnp.int32).at[srt[-1]].set(r_hi_s)
    vals_lo = jnp.zeros(M, jnp.int32).at[srt[-1]].set(r_lo_s)
    rank_hi = _route2_back(vals_hi, ctx, nP, axis)
    rank_lo = _route2_back(vals_lo, ctx, nP, axis)
    return rank_hi, rank_lo, all_distinct, ovf


def _shifted_fetch_pair(hi, lo, q, r, nP: int, axis: str, C: int):
    """Pair-plane shifted fetch with sentinel (-1, 0) beyond the end —
    hi=-1 sorts before every real rank, matching the int32 engine's
    np.int32(-1) fill."""
    return (_shifted_fetch(hi, q, r, nP, axis, C, np.int32(-1)),
            _shifted_fetch(lo, q, r, nP, axis, C, np.int32(0)))


@partial(jax.jit, static_argnames=("n1", "mesh"))
def sharded_build_sa_sample_pair(keys_hi: jnp.ndarray,
                                 keys_lo: jnp.ndarray, n1: int,
                                 mesh: Mesh):
    """sharded_build_sa_sample for inputs whose positions or key values
    exceed int32: all wide values travel as base-C int32 pairs. Returns
    (sa_hi, sa_lo, ovf) sharded planes; sa = sa_hi*C + sa_lo."""
    nP = mesh.devices.size
    assert nP > 1 and n1 % nP == 0
    C = n1 // nP
    assert C < 2 ** 29, "per-device block must stay below 2^29"

    def stage(khi_blk, klo_blk):
        khi_blk = khi_blk.reshape(C)
        klo_blk = klo_blk.reshape(C)
        my = jax.lax.axis_index("shard")
        # global position my*C + j in base-C pair form: (my, j) — free
        pos_hi = jnp.broadcast_to(my, (C,))
        pos_lo = jnp.arange(C, dtype=jnp.int32)

        kcols = [khi_blk, klo_blk]
        for j in range(1, _BOOT):
            kcols.extend(_shifted_fetch_pair(khi_blk, klo_blk,
                                             *divmod(j, C), nP, "shard",
                                             C))
        rank_hi, rank_lo, _, ovf = _exchange_rank_roundtrip_pair(
            kcols, [pos_hi, pos_lo], nP, "shard", C)

        def round_body(q, r, carry):
            rank_hi, rank_lo, ovf = carry
            r2_hi, r2_lo = _shifted_fetch_pair(rank_hi, rank_lo, q, r, nP,
                                               "shard", C)
            nhi, nlo, all_distinct, o = _exchange_rank_roundtrip_pair(
                [rank_hi, rank_lo, r2_hi, r2_lo],
                [pos_hi, pos_lo], nP, "shard", C)
            return (nhi, nlo, ovf | o), all_distinct

        rank_hi, rank_lo, ovf = _doubling_rounds(
            round_body, (rank_hi, rank_lo, ovf), n1, nP, C)

        # SA delivery: owner device IS rank_hi, slot IS rank_lo
        recv, rvalid, o3, _ = _route2(
            [rank_lo, pos_hi, pos_lo], jnp.minimum(rank_hi, nP - 1),
            jnp.ones(C, jnp.bool_), C, C + 2 * nP, nP, "shard")
        rlo, rph, rpl = recv
        slot = jnp.where(rvalid, rlo, np.int32(C))
        sa_hi = jnp.zeros(C, jnp.int32).at[slot].set(rph, mode="drop")
        sa_lo = jnp.zeros(C, jnp.int32).at[slot].set(rpl, mode="drop")
        ovf = ovf | o3
        return sa_hi, sa_lo, jax.lax.pmax(ovf.astype(jnp.int32),
                                          "shard")

    sa_hi, sa_lo, ovf = jax.shard_map(
        stage, mesh=mesh, in_specs=(P("shard"), P("shard")),
        out_specs=(P("shard"), P("shard"), P()),
        check_vma=False)(keys_hi, keys_lo)
    return sa_hi, sa_lo, ovf


def sharded_suffix_array(keys, mesh: Mesh,
                         engine: str = "sample") -> np.ndarray:
    """Host wrapper: pad to a power of two (pad keys sort last, as in
    index.suffix.build_suffix_array), run the sharded engine, return the
    unpadded suffix array as numpy.

    engine="sample" (default) uses the two-hop sample-sort exchange
    (~1/P per-device traffic per round, skew-immune by construction);
    engine="bitonic" forces the block-bitonic path. Any overflow-flagged
    sample run (provably unreachable, checked anyway) falls back to the
    bitonic engine.

    Inputs whose positions or padded key values exceed int32 (and any
    input when GT_TPU_FORCE_PAIR=1) run on the int32-pair lanes — see
    sharded_build_sa_sample_pair."""
    import os
    keys = np.asarray(keys)
    n1 = keys.size
    nP = mesh.devices.size
    npad = max(nP, 1 << max(0, (n1 - 1).bit_length()))
    kmax = int(keys.max(initial=0))
    wide = (npad > 2 ** 30 or kmax + (npad - n1) >= 2 ** 31 - 1
            or os.environ.get("GT_TPU_FORCE_PAIR") == "1")
    if wide and nP > 1:
        keys = keys.astype(np.int64)
        C = npad // nP
        if npad > n1:
            pad = kmax + 1 + np.arange(npad - n1, dtype=np.int64)
            keys = np.concatenate([keys, pad])
        khi = (keys // C).astype(np.int32)
        klo = (keys % C).astype(np.int32)
        sa_hi, sa_lo, ovf = sharded_build_sa_sample_pair(
            jnp.asarray(khi), jnp.asarray(klo), npad, mesh)
        assert not int(np.asarray(ovf)), \
            "pair-lane exchange overflow (capacity bound violated)"
        sa = np.asarray(sa_hi).astype(np.int64) * C + np.asarray(sa_lo)
        return sa[:n1]
    keys = keys.astype(np.int32)
    if npad > n1:
        pad = kmax + 1 + np.arange(npad - n1, dtype=np.int32)
        keys = np.concatenate([keys, pad])
    if engine == "sample" and nP > 1:
        sa, ovf = sharded_build_sa_sample(jnp.asarray(keys), npad, mesh)
        if not int(np.asarray(ovf)):
            return np.asarray(sa)[:n1]
    sa = np.asarray(sharded_build_sa(jnp.asarray(keys), npad, mesh))
    return sa[:n1]
