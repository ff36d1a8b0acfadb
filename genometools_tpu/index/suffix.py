"""Device suffix array + LCP construction.

This replaces the reference's scalar bucket pipeline (Sfxiterator +
Bentley-Sedgewick multikey quicksort, ref: src/match/sfx-suffixer.c,
src/match/sfx-bentsedg.c) with a data-parallel **prefix-doubling** design:

* One `lax.sort` bootstraps dense ranks from the int32 suffix keys
  (see Encseq.suffix_keys for the key mapping that encodes the reference's
  special-character ordering exactly).
* Each doubling round sorts (rank[i], rank[i+h]) pairs with a two-key
  `lax.sort` (which sort XLA's GPU backend emits for several operands
  is not yet measured); there is no per-bucket recursion, no
  data-dependent control flow, and every round is a fixed-shape O(n)
  kernel. ceil(log2 n) rounds worst case, with early
  exit via `lax.while_loop` once ranks are dense.
* The per-round rank tables double as a longest-common-prefix oracle: LCP
  of adjacent suffixes is computed by descending the rank levels
  (standard doubling-LCP), fully vectorized over all n adjacent pairs.
  This replaces the sequential Kasai scan (ref: src/match/sfx-linlcp.c:31)
  on the hot path; Kasai is kept host-side as a cross-check.

Uniqueness guarantee: every special character and the sentinel map to a
unique key, so no two distinct suffixes ever share a full-prefix rank,
which (a) makes the final rank a permutation == inverse suffix array, and
(b) makes rank-table equality at level t equivalent to "first 2^t symbols
equal" with no end-of-string corner cases.
"""

from __future__ import annotations

import math
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _dense_rank_from_order(neq: jnp.ndarray, order: jnp.ndarray, n1: int):
    """Scatter dense ranks (cumsum of not-equal flags) back to positions."""
    r = jnp.cumsum(neq.astype(jnp.int32))
    return jnp.zeros(n1, jnp.int32).at[order].set(r)


# bootstrap width: the initial multi-key sort ranks prefixes of this many
# symbols, so doubling starts at h=BOOT instead of h=1 (saves log2(BOOT)
# sort rounds; exactness is preserved because every suffix contains the
# unique sentinel, so out-of-range pad keys can never decide an order)
_BOOT = 4


@partial(jax.jit, static_argnames=("n1", "with_rank_levels"))
def _build_sa_impl(keys: jnp.ndarray, n1: int, with_rank_levels: bool):
    levels = max(1, math.ceil(math.log2(max(n1 / _BOOT, 2)))) if n1 > 1 else 1
    idx = jnp.arange(n1, dtype=jnp.int32)

    # bootstrap: rank by the first _BOOT symbol keys in one multi-key sort
    ops = []
    for j in range(_BOOT):
        kj = jnp.where(idx + j < n1,
                       keys[jnp.minimum(idx + j, n1 - 1)], jnp.int32(-1))
        ops.append(kj)
    sorted_ops = jax.lax.sort(tuple(ops) + (idx,), num_keys=_BOOT)
    order = sorted_ops[-1]
    neq0 = jnp.zeros(n1, jnp.bool_)
    for j in range(_BOOT):
        sk = sorted_ops[j]
        neq0 = neq0.at[1:].set(neq0[1:] | (sk[1:] != sk[:-1]))
    rank = _dense_rank_from_order(neq0, order, n1)

    if with_rank_levels:
        ranks_all = jnp.zeros((levels + 1, n1), jnp.int32).at[0].set(rank)
    else:
        ranks_all = jnp.zeros((1, n1), jnp.int32)

    def cond(carry):
        t, rank, ranks_all, done = carry
        return jnp.logical_and(t < levels, jnp.logical_not(done))

    def body(carry):
        t, rank, ranks_all, _ = carry
        h = jnp.int32(_BOOT) << t
        nxt = jnp.minimum(idx + h, n1 - 1)
        rank2 = jnp.where(idx + h < n1, rank[nxt], jnp.int32(-1))
        srank, srank2, order = jax.lax.sort((rank, rank2, idx), num_keys=2)
        neq = jnp.concatenate(
            [jnp.zeros(1, jnp.bool_),
             (srank[1:] != srank[:-1]) | (srank2[1:] != srank2[:-1])])
        newrank = _dense_rank_from_order(neq, order, n1)
        if with_rank_levels:
            ranks_all = jax.lax.dynamic_update_slice(
                ranks_all, newrank[None, :], (t + 1, jnp.int32(0)))
        done = newrank[order[-1]] == n1 - 1  # max dense rank == n1-1
        return t + 1, newrank, ranks_all, done

    t_final, rank, ranks_all, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), rank, ranks_all, jnp.bool_(n1 <= 1)))

    sa = jnp.zeros(n1, jnp.int32).at[rank].set(idx)

    if with_rank_levels:
        # fill untouched levels with the final (permutation) rank so the LCP
        # descent can statically iterate over all rows
        lev = jnp.arange(levels + 1, dtype=jnp.int32)[:, None]
        ranks_all = jnp.where(lev > t_final, rank[None, :], ranks_all)
    return sa, rank, ranks_all


@partial(jax.jit, static_argnames=("n1",))
def _lcp_impl(keys: jnp.ndarray, sa: jnp.ndarray, ranks_all: jnp.ndarray,
              n1: int):
    levels = ranks_all.shape[0] - 1
    x = sa[:-1]
    y = sa[1:]
    l = jnp.zeros(n1 - 1, jnp.int32)
    # rank row t covers prefixes of length _BOOT * 2^t
    for t in range(levels, -1, -1):
        h = jnp.int32(_BOOT) << t
        rt = ranks_all[t]
        xs = jnp.minimum(x, n1 - 1)
        ys = jnp.minimum(y, n1 - 1)
        ok = (x < n1) & (y < n1) & (x != y) & (rt[xs] == rt[ys])
        step = jnp.where(ok, h, 0)
        l = l + step
        x = x + step
        y = y + step
    # residue below the bootstrap width: direct key comparisons
    alive = jnp.ones(n1 - 1, jnp.bool_)
    for _ in range(_BOOT - 1):
        xs = jnp.minimum(x, n1 - 1)
        ys = jnp.minimum(y, n1 - 1)
        alive = alive & (x < n1) & (y < n1) & (x != y) & \
            (keys[xs] == keys[ys])
        step = alive.astype(jnp.int32)
        l = l + step
        x = x + step
        y = y + step
    return jnp.concatenate([jnp.zeros(1, jnp.int32), l])


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


_PAD_QUANTUM = 1 << 20


def _pad_size(n1: int) -> int:
    """Pad target for the device pipeline: powers of two below 1M (small
    inputs reuse compilations aggressively), else the next 1M multiple —
    padding to the next power of two would sort up to 2x phantom keys at
    large n (33.5M would pad to 67M), and XLA's sort has no
    power-of-two preference."""
    if n1 <= _PAD_QUANTUM:
        return 1 << max(0, (n1 - 1).bit_length())
    return -(-n1 // _PAD_QUANTUM) * _PAD_QUANTUM


# ---------------------------------------------------------------------------
# packed-bootstrap engine (the round-3 fast path)
#
# Design (replaces the ab-initio doubling above on the product path):
#   * pack the first m symbols of every suffix into two int32 words
#     (b bits per slot: regular symbol -> code, first special -> sigma,
#     everything after the first special -> 0, so packed-key order is a
#     refinable coarsening of the reference suffix order contract),
#   * ONE multi-key `lax.sort` then ranks m symbols deep at once — for
#     DNA m = 20, so random-like data is fully resolved after a single
#     device sort instead of log2(n) doubling rounds,
#   * windows containing a special are finished inside the bootstrap by
#     a position tiebreak (specials compare by absolute position, see
#     Encseq.suffix_keys),
#   * surviving ties (true repeats >= m symbols) are refined by
#     prefix-doubling restricted to the tied subset only: each round
#     sorts just the unresolved elements (head-rank convention keeps
#     rank updates group-local), so refinement cost is proportional to
#     repeat mass, not to n,
#   * LCP: because every tie group shares identical packed words, the
#     bootstrap's SORTED packed arrays are valid in final suftab order,
#     so sub-m lcp residues are one elementwise XOR+clz pass with zero
#     gathers; only the (few) pairs with lcp >= m descend the per-round
#     full-rank snapshots, as a compacted subset.
# ---------------------------------------------------------------------------

_FSBITS = 5                                  # fs field: offsets 0..m <= 31


def _pack_plan(sigma: int):
    """(slot_bits, hi_slots, lo_slots, window_m) for alphabet size
    sigma. lo keeps its bottom _FSBITS bits for the first-special
    offset so (hi, lo) comparison already covers it."""
    b = max(2, int(sigma).bit_length())      # holds 0..sigma (sigma = special)
    per_hi = 30 // b                         # keep int32 sign bit clear
    per_lo = (30 - _FSBITS) // b
    return b, per_hi, per_lo, per_hi + per_lo


@partial(jax.jit, static_argnames=("b", "per_hi", "per_lo", "sigma"))
def _pack_windows(keysx: jnp.ndarray, b: int, per_hi: int, per_lo: int,
                  sigma: int):
    """Pack the m = per_hi+per_lo symbol window at every position into
    (hi, lo) int32 words: b-bit slots (regular -> code, first special ->
    sigma, after first special -> 0), with lo's low _FSBITS bits holding
    fs = offset of the first special (m if none). Lexicographic order of
    (hi, lo) == window order because fs is a function of the slots.
    keysx must carry m extra special-valued pad entries."""
    m = per_hi + per_lo
    n1p = keysx.shape[0] - m
    hi = jnp.zeros(n1p, jnp.int32)
    lo = jnp.zeros(n1p, jnp.int32)
    fs = jnp.full(n1p, m, jnp.int32)
    seen = jnp.zeros(n1p, jnp.bool_)
    for j in range(m):
        kj = jax.lax.dynamic_slice_in_dim(keysx, j, n1p)
        spec = kj >= sigma
        slot = jnp.where(seen, 0, jnp.where(spec, sigma, kj))
        fs = jnp.where(jnp.logical_and(spec, jnp.logical_not(seen)), j, fs)
        seen = jnp.logical_or(seen, spec)
        if j < per_hi:
            hi = (hi << b) | slot
        else:
            lo = (lo << b) | slot
    return hi, (lo << _FSBITS) | fs


@partial(jax.jit, static_argnames=("m",))
def _bootstrap_rank(hi, lo, m: int):
    """Sort by (hi, lo, position-if-special-window); return head ranks
    (rank = suftab slot of the first member of the tie group), the tied
    mask (packed to bits for a cheap host fetch), the tied count, and
    the sorted packed words (valid in FINAL suftab order: tie-group
    members share identical packed words)."""
    n1p = hi.shape[0]
    idx = jnp.arange(n1p, dtype=jnp.int32)
    fs = lo & ((1 << _FSBITS) - 1)
    tb = jnp.where(fs < m, idx, jnp.int32(n1p))
    shi, slo, stb, order = jax.lax.sort((hi, lo, tb, idx), num_keys=3)
    starts = jnp.concatenate([
        jnp.ones(1, jnp.bool_),
        (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1]) | (stb[1:] != stb[:-1])])
    head = jax.lax.cummax(jnp.where(starts, idx, 0))
    rank = jnp.zeros(n1p, jnp.int32).at[order].set(head)
    starts_next = jnp.concatenate([starts[1:], jnp.ones(1, jnp.bool_)])
    tied_sorted = jnp.logical_not(starts & starts_next)
    tied = jnp.zeros(n1p, jnp.bool_).at[order].set(tied_sorted)
    return rank, tied, tied_sorted.sum(), shi, slo


@jax.jit
def _refine_subset(rank, s, valid, h):
    """One doubling round on the tied subset only. rank uses the
    head-rank convention, so splitting a group assigns ranks that stay
    inside the group's suftab slot range — no global re-ranking."""
    n1p = rank.shape[0]
    kcap = s.shape[0]
    j = jnp.arange(kcap, dtype=jnp.int32)
    big = jnp.int32(2 ** 31 - 1)
    key1 = jnp.where(valid, rank[jnp.minimum(s, n1p - 1)], big)
    s2 = jnp.minimum(s + jnp.minimum(h, n1p), n1p - 1)
    key2 = jnp.where(valid, rank[s2], j)       # pads: distinct singletons
    k1, k2, ss, vs = jax.lax.sort(
        (key1, key2, s, valid.astype(jnp.int32)), num_keys=2)
    startg = jnp.concatenate([jnp.ones(1, jnp.bool_), k1[1:] != k1[:-1]])
    startp = jnp.concatenate([
        jnp.ones(1, jnp.bool_),
        (k1[1:] != k1[:-1]) | (k2[1:] != k2[:-1])])
    grp_start = jax.lax.cummax(jnp.where(startg, j, 0))
    pair_start = jax.lax.cummax(jnp.where(startp, j, 0))
    new_rank = k1 + (pair_start - grp_start)
    tgt = jnp.where(vs.astype(jnp.bool_), ss, jnp.int32(n1p))
    rank = rank.at[tgt].set(new_rank, mode="drop")
    startp_next = jnp.concatenate([startp[1:], jnp.ones(1, jnp.bool_)])
    still = jnp.logical_not(startp & startp_next) & vs.astype(jnp.bool_)
    return rank, ss, still


def _lead_slots(d1, d2s, b: int, per_hi: int, per_lo: int):
    """Leading equal slot count from XORed hi words and (fs-stripped)
    lo slot fields."""
    lead1 = jnp.where(d1 == 0, per_hi,
                      jax.lax.clz(d1 << (32 - b * per_hi)) // b)
    lead2 = jnp.where(d2s == 0, per_lo,
                      jax.lax.clz(d2s << (32 - b * per_lo)) // b)
    return jnp.where(d1 != 0, lead1, per_hi + lead2)


@partial(jax.jit, static_argnames=("b", "per_hi", "per_lo", "n1"))
def _lcp_base(shi, slo, b: int, per_hi: int, per_lo: int, n1: int):
    """lcp for every adjacent suftab pair with lcp < m, elementwise on
    the bootstrap-sorted packed words (NO gathers: tie groups share
    identical packed words, so the bootstrap sort order's word stream
    equals the final suftab order's). Pairs with lcp >= m ("deep") are
    flagged for the level descent; their lcp slot holds m meanwhile."""
    m = per_hi + per_lo
    fsmask = (1 << _FSBITS) - 1
    ax, ay = shi[:n1 - 1], shi[1:n1]
    bx, by = slo[:n1 - 1], slo[1:n1]
    d1 = ax ^ ay
    d2s = (bx ^ by) >> _FSBITS
    lead = _lead_slots(d1, d2s, b, per_hi, per_lo)
    fsx = bx & fsmask
    fsy = by & fsmask
    res = jnp.minimum(lead, jnp.minimum(fsx, fsy))
    deep = (d1 == 0) & (d2s == 0) & (fsx == m)
    lcp = jnp.concatenate([jnp.zeros(1, jnp.int32), res])
    deepmask = jnp.concatenate([jnp.zeros(1, jnp.bool_), deep])
    return lcp, deepmask, deep.sum()


@partial(jax.jit, static_argnames=("m", "b", "per_hi", "per_lo", "n1"))
def _lcp_deep(lcp, pidx, valid, sa, ranks_stack, hi, lo,
              m: int, b: int, per_hi: int, per_lo: int, n1: int):
    """Exact lcp for the deep pairs (lcp >= m): descend the refinement
    rank snapshots (advance m*2^t while level-t ranks agree), then one
    packed-word residue at the advanced positions. pidx are lcp-array
    indices (pair = suffixes sa[p-1], sa[p]); scatters results into
    lcp and returns it."""
    n1p = hi.shape[0]
    fsmask = (1 << _FSBITS) - 1
    levels = ranks_stack.shape[0] - 1
    ps = jnp.clip(pidx, 1, n1 - 1)
    x = sa[ps - 1]
    y = sa[ps]
    l = jnp.zeros(pidx.shape[0], jnp.int32)
    for t in range(levels, -1, -1):
        h = jnp.int32(m) << t
        rt = ranks_stack[t]
        xs = jnp.minimum(x, n1p - 1)
        ys = jnp.minimum(y, n1p - 1)
        ok = (x < n1) & (y < n1) & (rt[xs] == rt[ys])
        step = jnp.where(ok, h, 0)
        l = l + step
        x = x + step
        y = y + step
    xs = jnp.minimum(x, n1p - 1)
    ys = jnp.minimum(y, n1p - 1)
    d1 = hi[xs] ^ hi[ys]
    dlo = lo[xs] ^ lo[ys]
    lead = _lead_slots(d1, dlo >> _FSBITS, b, per_hi, per_lo)
    fsx = lo[xs] & fsmask
    fsy = lo[ys] & fsmask
    res = jnp.minimum(jnp.minimum(lead, m),
                      jnp.minimum(fsx, fsy))
    l = l + jnp.where((x < n1) & (y < n1), res, 0)
    tgt = jnp.where(valid, ps, jnp.int32(lcp.shape[0]))
    return lcp.at[tgt].set(l, mode="drop")


@partial(jax.jit, static_argnames=("k",))
def _compact_mask(mask, k: int):
    """Indices of the True entries (device compaction; fills = len)."""
    return jnp.nonzero(mask, size=k,
                       fill_value=mask.shape[0])[0].astype(jnp.int32)


def _sa_pipeline(keys_j: jnp.ndarray, n1: int, sigma: int,
                 with_lcp: bool):
    """Device pipeline on padded int32 keys (length npad, plus the
    caller guarantees keys[n1-1] is the unique sentinel). Returns
    (sa_full_device, lcp_device_or_None). Host-orchestrated: the
    bootstrap resolves everything except true >= m-symbol repeats;
    each refinement round re-sorts only the still-tied subset."""
    npad = int(keys_j.shape[0])
    b, per_hi, per_lo, m = _pack_plan(sigma)
    maxkey = sigma + npad                  # pack pad: strictly special
    keysx = jnp.concatenate([
        keys_j,
        maxkey + jnp.arange(m, dtype=jnp.int32)])
    hi, lo = _pack_windows(keysx, b, per_hi, per_lo, sigma)
    rank, tiedmask, tiedcount, shi, slo = _bootstrap_rank(hi, lo, m)
    levels = [rank]
    counts = []
    tc = int(tiedcount)           # one scalar round trip
    if tc > 0:
        # device-side compaction of the tied subset (one scalar fetch
        # for the count instead of an npad/8-byte bitmask transfer),
        # then every refinement round is dispatched asynchronously with
        # NO host round trip: the subset stays fixed (resolved members
        # keep their unique (key1,key2) and are no-op updates), rounds
        # run up to the worst-case count, and the per-round still-tied
        # counts are fetched once at the end to trim the LCP level
        # stack. This keeps host round trips off the critical path.
        kcap = _next_pow2(tc)
        s_j = _compact_mask(tiedmask, kcap)
        v_j = s_j < npad
        rmax = max(1, math.ceil(math.log2(max(n1 / m, 2))) + 1)
        h = m
        for _ in range(rmax):
            rank, _, still = _refine_subset(
                rank, s_j, v_j, jnp.int32(min(h, npad)))
            if with_lcp:
                levels.append(rank)
                counts.append(still.sum())
            h *= 2
        if with_lcp:
            counts_np = np.asarray(jnp.stack(counts))
            live = np.flatnonzero(counts_np == 0)
            if live.size == 0:
                raise AssertionError(
                    "suffix refinement failed to converge")
            rstar = int(live[0]) + 1      # rounds that did real work
            rank = levels[rstar]
            levels = levels[:rstar + 1]
    idx = jnp.arange(npad, dtype=jnp.int32)
    sa = jnp.zeros(npad, jnp.int32).at[rank].set(idx)
    if not with_lcp:
        return sa, None
    lcp, deepmask, deepcount = _lcp_base(shi, slo, b, per_hi, per_lo, n1)
    dc = int(deepcount)
    if dc > 0:
        kcap = _next_pow2(dc)
        p_j = _compact_mask(deepmask, kcap)
        lcp = _lcp_deep(lcp, jnp.minimum(p_j, n1 - 1),
                        p_j < deepmask.shape[0],
                        sa, jnp.stack(levels), hi, lo,
                        m, b, per_hi, per_lo, n1)
    return sa, lcp


def _build_suffix_array_wide(keys: np.ndarray, n1: int,
                             with_lcp: bool):
    """>2^30 (or forced) path: pair-lane sharded doubling over the
    available devices, Kasai host LCP."""
    import jax

    from ..parallel.dist_doubling_sharded import sharded_suffix_array
    from ..parallel.dist_esa import make_mesh

    try:
        ndev = len(jax.devices())
    except RuntimeError:
        ndev = 1
    mesh = make_mesh(ndev)
    sa = np.asarray(sharded_suffix_array(np.asarray(keys, np.int64),
                                         mesh))[:n1]
    lcp = None
    if with_lcp:
        from ..core.native import kasai_lcp_native
        lcp = kasai_lcp_native(np.asarray(keys, np.int32),
                               np.asarray(sa, np.int32))
        if lcp is None:
            lcp = kasai_lcp(np.asarray(keys, np.int64),
                            np.asarray(sa, np.int64))
        lcp = jnp.asarray(np.asarray(lcp, np.int32))
    return jnp.asarray(np.asarray(sa, np.int32)), lcp


def build_suffix_array(keys, with_lcp: bool = True):
    """Build (sa, lcp) from int32 suffix keys.

    ``keys`` has length totallength+1 (sentinel included), so ``sa`` is the
    full suftab with totallength+1 entries (ref: .suf layout,
    src/match/sfx-suffixgetset.c) and ``lcp[i] = lcp(sa[i-1], sa[i])``
    with lcp[0] = 0 (ref: .lcp layout, src/match/sfx-lcpvalues.c).

    Inputs are padded to the next power of two so XLA compilations are
    reused across lengths. Pad positions get strictly increasing keys
    larger than every real key, so they occupy exactly the last
    ``pad - n1`` suftab slots; slicing the first n1 entries recovers the
    exact unpadded result (pad boundary lcp is 0 by construction).
    """
    keys = np.asarray(keys, np.int32)
    n1 = int(keys.shape[0])
    if n1 == 0:
        z = jnp.zeros(0, jnp.int32)
        return (z, z) if with_lcp else (z, None)
    npad = _pad_size(n1)
    # int32 arithmetic bounds: pad keys are maxkey+1..maxkey+(npad-n1) and
    # the doubling rounds form idx + h with idx, h < npad — both must stay
    # below 2^31. encseq's own guard (n + num_chars < 2^31) admits sizes in
    # (2^30, 2^31) that would overflow silently here, so reject them too.
    if npad > 2 ** 30 or int(keys.max()) + (npad - n1) >= 2 ** 31 - 1 \
            or os.environ.get("GT_TPU_WIDE_FORCE"):
        # wide lanes: values past the int32 doubling budget go through
        # the position-sharded pair-lane engine (int32 (hi, lo) planes,
        # parallel/dist_doubling_sharded) — a 1-device mesh IS the
        # single-chip case, so >2^30 no longer raises here (ref scale
        # model: src/match/sfx-suffixgetset.c:33 ulong positions).
        return _build_suffix_array_wide(keys, n1, with_lcp)
    if npad > n1:
        maxkey = int(keys.max())
        pad = maxkey + 1 + np.arange(npad - n1, dtype=np.int32)
        keys_p = np.concatenate([keys, pad])
    else:
        keys_p = keys
    keys_j = jnp.asarray(keys_p)
    # Fast path eligibility: the packed-bootstrap engine assumes every
    # key >= sigma equals sigma + position (the canonical suffix_keys
    # contract, sentinel last). Then all such keys are distinct and
    # position order == numeric order, which is exactly what the
    # in-window position tiebreak exploits. Inputs carrying UNDEFCHAR
    # symbols (value 253, position-independent) or synthetic key arrays
    # fail the check and take the exact general-purpose doubling path.
    sigma = int(keys[-1]) - (n1 - 1)
    if 1 <= sigma < 2 ** 24:
        arange = np.arange(n1, dtype=np.int64)
        canonical = bool(np.all((keys < sigma) |
                                (keys == sigma + arange)))
    else:
        canonical = False
    if canonical:
        sa, lcp = _sa_pipeline(keys_j, n1, sigma, with_lcp)
        sa = sa[:n1]
        return (sa, lcp) if with_lcp else (sa, None)
    sa, rank, ranks_all = _build_sa_impl(keys_j, npad, with_lcp)
    sa = sa[:n1]
    if not with_lcp:
        return sa, None
    lcp = _lcp_impl(keys_j, sa, ranks_all, n1)
    return sa, lcp


# ---------------------------------------------------------------------------
# host-side reference implementations (cross-checks, mirror of the
# reference's internal verifiers sfx-lwcheck.c / sfx-suftaborder.c)
# ---------------------------------------------------------------------------

def suffix_array_bruteforce(keys: np.ndarray) -> np.ndarray:
    """O(n^2 log n) reference: sort suffixes of the key array directly."""
    keys = np.asarray(keys)
    n1 = keys.size
    idx = sorted(range(n1), key=lambda i: keys[i:].tolist())
    return np.asarray(idx, np.int32)


def lcp_bruteforce(keys: np.ndarray, sa: np.ndarray) -> np.ndarray:
    keys = np.asarray(keys)
    out = np.zeros(len(sa), np.int32)
    for i in range(1, len(sa)):
        a, b = sa[i - 1], sa[i]
        l = 0
        while a + l < keys.size and b + l < keys.size and keys[a + l] == keys[b + l]:
            l += 1
        out[i] = l
    return out


def kasai_lcp(keys: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Kasai 13n LCP (ref: gt_ENCSEQ_lcp13_kasai, src/match/sfx-linlcp.c:31).

    Host-side numpy/Python; used as a cross-check for the doubling LCP.
    """
    keys = np.asarray(keys)
    n1 = len(sa)
    rank = np.empty(n1, np.int64)
    rank[sa] = np.arange(n1)
    lcp = np.zeros(n1, np.int32)
    h = 0
    for i in range(n1):
        r = rank[i]
        if r > 0:
            j = sa[r - 1]
            while i + h < n1 and j + h < n1 and keys[i + h] == keys[j + h]:
                h += 1
            lcp[r] = h
            if h > 0:
                h -= 1
        else:
            h = 0
    return lcp


def check_suftab_order(keys: np.ndarray, sa: np.ndarray) -> bool:
    """Lightweight order check (ref: gt_suftab_lightweightcheck,
    src/match/sfx-lwcheck.c): verify adjacent suffixes strictly increase."""
    keys = np.asarray(keys)
    n1 = keys.size
    if sorted(sa.tolist()) != list(range(n1)):
        return False
    for i in range(1, n1):
        a, b = int(sa[i - 1]), int(sa[i])
        # compare suffixes
        la, lb = n1 - a, n1 - b
        m = min(la, lb)
        ka, kb = keys[a:a + m], keys[b:b + m]
        d = np.nonzero(ka != kb)[0]
        if d.size == 0:
            if la >= lb:
                return False
        else:
            j = d[0]
            if ka[j] > kb[j]:
                return False
    return True
