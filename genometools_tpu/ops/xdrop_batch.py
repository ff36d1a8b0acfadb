"""Batched xdrop extension on device (JAX/XLA).

The device counterpart of ops/xdrop.py: thousands of seed extensions run
as lanes of one fixed-shape front recurrence (semantics equivalent of
ref: src/match/xdrop.c:224, matching the scalar mirror bit for bit —
verified by tests against ops/xdrop.xdrop_extend).

Design per the survey's "batched extension with per-seed lanes" plan:
  * windows: U, V are uint8[N, W] (clipped extension windows, padded with
    255); per-seed true lengths ulen/vlen
  * match-run table: R[n, k, i] = length of the exact match run starting
    at u-position i on diagonal k (j = i - k), built with one reverse
    lax.scan — this replaces the sequential lcp() calls inside the front
    loop with a gather
  * the d-generation loop is a lax.fori_loop over fixed D_MAX
    generations; fronts are int32[N, K] with -inf for invalid diagonals,
    lbound/ubound tracked per lane, termination by masks
  * the X-drop prune tests EVAL against the best score dback generations
    back (big_t ring), exactly like the reference

Unit distances (scores mat=2 mis=-1 ins=-2 del=-2 => all distance 1,
gcd 3) — the combination every reference pipeline uses.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

NEGINF = jnp.int32(-(2 ** 30))


def _match_run_table(U, V, W: int, D: int):
    """R[n, k, i]: match-run length at (i, j=i-(k-D)) for diagonal index
    k in [0, 2D]; 0 where out of bounds or mismatch."""
    N = U.shape[0]
    K = 2 * D + 1
    i_idx = jnp.arange(W)[None, None, :]                 # (1,1,W)
    k_off = (jnp.arange(K) - D)[None, :, None]           # (1,K,1)
    j_idx = i_idx - k_off                                # (1,K,W)
    j_ok = (j_idx >= 0) & (j_idx < W)
    j_safe = jnp.clip(j_idx, 0, W - 1)
    u = U[:, None, :]                                    # (N,1,W)
    v = jnp.take_along_axis(
        jnp.broadcast_to(V[:, None, :], (N, K, W)),
        jnp.broadcast_to(j_safe, (N, K, W)), axis=2)
    m = (u == v) & (u < 4) & j_ok                        # (N,K,W) bool
    # reverse scan: run[i] = m[i] ? run[i+1]+1 : 0

    def step(carry, mcol):
        run = jnp.where(mcol, carry + 1, 0)
        return run, run

    m_t = jnp.moveaxis(m, 2, 0)                          # (W,N,K)
    _, runs = jax.lax.scan(step, jnp.zeros((N, K), jnp.int32), m_t[::-1])
    R = jnp.moveaxis(runs[::-1], 0, 2)                   # (N,K,W)
    return R


@partial(jax.jit, static_argnames=("W", "D"))
def xdrop_extend_batch_impl(U, V, ulen, vlen, belowscore, W: int, D: int):
    """Returns (ivalue, jvalue, score, unsafe) int32/bool[N] per pair.

    unsafe marks lanes whose result is NOT provably equal to the
    unbounded scalar engine: a front cell reached the u/v window end
    (meaningful when the caller clipped the window) or the front was
    still alive at generation D."""
    N = U.shape[0]
    K = 2 * D + 1
    karr = jnp.arange(K, dtype=jnp.int32) - D            # diagonal values
    R = _match_run_table(U, V, W, D)

    gcd = jnp.int32(3)
    dback = (belowscore + 1) // gcd + 1

    def EVAL(ij, d):
        return ij - 3 * d

    w_iota = jnp.arange(W, dtype=jnp.int32)[None, None, :]

    def lcp_at(row_i):
        """R[n, k, i] via a one-hot select + reduction over W (an
        elementwise form of the per-lane gather)."""
        onehot = (row_i[:, :, None] == w_iota)
        vals = jnp.sum(jnp.where(onehot, R, 0), axis=2)
        return jnp.where((row_i >= 0) & (row_i < W), vals, 0)

    # phase 0
    init_lcp = R[:, D, 0]
    row0 = jnp.full((N, K), NEGINF, jnp.int32).at[:, D].set(init_lcp)
    finished0 = (init_lcp >= ulen) | (init_lcp >= vlen)
    lb0 = jnp.where(finished0, jnp.int32(1), jnp.int32(0))
    ub0 = jnp.where(finished0, jnp.int32(-1), jnp.int32(0))
    best0 = jnp.stack([init_lcp, init_lcp, EVAL(2 * init_lcp, 0)], axis=1)
    bigt0 = jnp.full((N, D + 2), NEGINF, jnp.int32).at[:, 0].set(best0[:, 2])

    kk = karr[None, :]

    def gen(d, carry):
        row, lb, ub, best, bigt, touched, capped = carry
        active = lb <= ub
        dd = d - 1
        # candidate rows from previous front
        del_row = jnp.pad(row, ((0, 0), (1, 0)),
                          constant_values=int(NEGINF))[:, :K]   # from k-1
        ins_row = jnp.pad(row, ((0, 0), (0, 1)),
                          constant_values=int(NEGINF))[:, 1:]   # from k+1
        in_prev = (kk >= -dd) & (kk <= dd)
        in_prev_m1 = (kk - 1 >= -dd) & (kk - 1 <= dd)
        in_prev_p1 = (kk + 1 >= -dd) & (kk + 1 <= dd)

        cand_del = jnp.where((lb[:, None] < kk) & in_prev_m1,
                             del_row + 1, NEGINF)
        cand_mis = jnp.where((lb[:, None] <= kk) & (kk <= ub[:, None])
                             & in_prev, row + 1, NEGINF)
        cand_ins = jnp.where((kk < ub[:, None]) & in_prev_p1,
                             ins_row, NEGINF)
        # priority DEL, then MIS if strictly greater, then INS if strictly
        # greater (reference order: del, replacement, insertion)
        i_new = cand_del
        i_new = jnp.where(cand_mis > i_new, cand_mis, i_new)
        i_new = jnp.where(cand_ins > i_new, cand_ins, i_new)
        i_new = jnp.where((lb[:, None] - 1 <= kk)
                          & (kk <= ub[:, None] + 1), i_new, NEGINF)
        has = i_new >= 0

        j_new = i_new - kk
        # X-drop prune
        prevd = d - dback
        tref = jnp.sum(jnp.where(
            jnp.arange(D + 2)[None, :] == jnp.clip(prevd, 0, D + 1),
            bigt, 0), axis=1)
        pruned = (prevd > 0) & has & \
            (EVAL(i_new + j_new, d) < tref[:, None] - belowscore)
        i_new = jnp.where(pruned, NEGINF, i_new)
        has = i_new >= 0

        # update-condition: k outside previous window always updates;
        # else requires prevrow < i <= min(ulen, vlen+k)
        minuv = jnp.minimum(ulen[:, None], vlen[:, None] + kk)
        cond_edge = (kk <= -d) | (kk >= d)
        cond_mid = (row < i_new) & (i_new <= minuv)
        takes = has & (cond_edge | cond_mid)
        keeps = has & ~takes                      # keep previous row value

        # lcp extension for taken cells with room left
        j_tmp = i_new - kk
        can_ext = takes & (i_new < ulen[:, None]) & (j_tmp < vlen[:, None])
        ext = jnp.where(can_ext, lcp_at(i_new), 0)
        i_ext = i_new + ext

        new_row = jnp.where(takes, i_ext, jnp.where(keeps, row, NEGINF))
        new_row = jnp.where(active[:, None], new_row, row)

        # best update
        j_ext = i_ext - kk
        sc = EVAL(i_ext + j_ext, d)
        sc = jnp.where(takes & active[:, None], sc, NEGINF)
        kbest = jnp.argmax(sc, axis=1)
        scbest = jnp.take_along_axis(sc, kbest[:, None], axis=1)[:, 0]
        better = scbest > best[:, 2]
        ib = jnp.take_along_axis(i_ext, kbest[:, None], axis=1)[:, 0]
        jb = jnp.take_along_axis(j_ext, kbest[:, None], axis=1)[:, 0]
        best = jnp.where(better[:, None],
                         jnp.stack([ib, jb, scbest], axis=1), best)
        bigt = jnp.where(active[:, None],
                         jax.lax.dynamic_update_slice(
                             bigt, best[:, 2][:, None],
                             (0, jnp.clip(d, 0, D + 1))),
                         bigt)

        # termination: reached end diagonal with full row
        end_k = ulen - vlen
        end_idx = jnp.clip(end_k + D, 0, K - 1)
        row_at_end = jnp.take_along_axis(new_row, end_idx[:, None],
                                         axis=1)[:, 0]
        done_align = (jnp.abs(end_k) <= d) & (row_at_end == ulen)

        # bounds pruning
        has_row = new_row > NEGINF
        first_k = jnp.argmax(has_row, axis=1)
        last_k = K - 1 - jnp.argmax(has_row[:, ::-1], axis=1)
        any_row = has_row.any(axis=1)
        new_lb = jnp.where(any_row, first_k - D, jnp.int32(1))
        new_ub = jnp.where(any_row, last_k - D, jnp.int32(-1))
        # boundary handling: largest k<=0 with row == vlen+k -> lbound
        hit_v = has_row & (new_row == vlen[:, None] + kk) & (kk <= 0) & \
            (kk >= new_lb[:, None])
        anyv = hit_v.any(axis=1)
        kv = K - 1 - jnp.argmax(hit_v[:, ::-1], axis=1) - D
        new_lb = jnp.where(anyv, jnp.maximum(new_lb, kv), new_lb)
        # smallest k>=0 with row == ulen -> ubound
        hit_u = has_row & (new_row == ulen[:, None]) & (kk >= 0) & \
            (kk <= new_ub[:, None])
        anyu = hit_u.any(axis=1)
        ku = jnp.argmax(hit_u, axis=1) - D
        new_ub = jnp.where(anyu, jnp.minimum(new_ub, ku), new_ub)

        stop = done_align | ~any_row | (d >= D)
        new_lb = jnp.where(active & ~stop, new_lb, jnp.int32(1))
        new_ub = jnp.where(active & ~stop, new_ub, jnp.int32(-1))
        new_lb = jnp.where(active, new_lb, lb)
        new_ub = jnp.where(active, new_ub, ub)
        # window-edge contact: any taken cell reaching i == ulen or
        # j == vlen (only meaningful for clipped lanes; the caller
        # combines this with its clip mask)
        edge = takes & ((i_ext >= ulen[:, None]) |
                        (j_ext >= vlen[:, None]))
        touched = touched | (active & edge.any(axis=1))
        # still alive at the generation cap: result unverified
        capped = capped | ((d >= D) & active & ~done_align & any_row)
        return new_row, new_lb, new_ub, best, bigt, touched, capped

    row, lb, ub, best, bigt, touched, capped = jax.lax.fori_loop(
        1, D + 1, gen, (row0, lb0, ub0, best0, bigt0,
                        jnp.zeros(N, jnp.bool_), jnp.zeros(N, jnp.bool_)))
    # phase-0 full-window hits count as edge contact too
    touched = touched | (init_lcp >= ulen) | (init_lcp >= vlen)
    return best[:, 0], best[:, 1], best[:, 2], touched, capped


def xdrop_extend_batch(us, vs, belowscore: int, W: int = 128, D: int = 48):
    """Host-friendly wrapper: list of uint8 arrays -> (i, j, score) arrays.

    Windows are clipped to W; D bounds the explored distance (front
    generations). With the default X-drop thresholds (<= 7) the front
    dies long before 48 generations, so results equal the unbounded
    scalar engine whenever ulen, vlen <= W.
    """
    i, j, s, _ = _run_device(us, vs, belowscore, W, D)
    return i, j, s


def _run_device(us, vs, belowscore: int, W: int, D: int):
    N = len(us)
    U = np.full((N, W), 255, np.uint8)
    V = np.full((N, W), 255, np.uint8)
    ulen = np.zeros(N, np.int32)
    vlen = np.zeros(N, np.int32)
    clipped = np.zeros(N, bool)
    for i, (u, v) in enumerate(zip(us, vs)):
        lu = min(len(u), W)
        lv = min(len(v), W)
        U[i, :lu] = u[:lu]
        V[i, :lv] = v[:lv]
        ulen[i] = lu
        vlen[i] = lv
        clipped[i] = len(u) > W or len(v) > W
    i, j, s, touched, capped = xdrop_extend_batch_impl(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(ulen),
        jnp.asarray(vlen), jnp.int32(belowscore), W, D)
    unsafe = (np.asarray(touched) & clipped) | np.asarray(capped)
    return np.asarray(i), np.asarray(j), np.asarray(s), unsafe


def xdrop_extend_batch_exact(us, vs, belowscore: int, max_w: int = 512,
                             D: int = 64):
    """Product-path batch, bit-equal to running the scalar engine
    (ref: src/match/xdrop.c:224) on every pair: the C++ batch engine
    when the native library is built, else the lax device batch with
    the scalar mirror re-running every lane the device cannot verify
    (window clipped AND a front cell reached the clip edge, or the
    front outlived the generation cap).

    Returns (ivalue, jvalue, score) int arrays of length len(us)."""
    N = len(us)
    if N == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    from ..core.native import xdrop_batch_native
    res = xdrop_batch_native(us, vs, belowscore)
    if res is not None:
        return (res[:, 0].astype(np.int64), res[:, 1].astype(np.int64),
                res[:, 2].astype(np.int64))
    maxlen = max(max(len(u), len(v)) for u, v in zip(us, vs))
    W = 64
    while W < maxlen and W < max_w:
        W *= 2
    iv, jv, sv, unsafe = _run_device(us, vs, belowscore, W, D)
    iv = iv.astype(np.int64)
    jv = jv.astype(np.int64)
    sv = sv.astype(np.int64)
    from .xdrop import xdrop_extend
    for b in np.flatnonzero(unsafe):
        best = xdrop_extend(us[b], vs[b], belowscore)
        iv[b], jv[b], sv[b] = best.ivalue, best.jvalue, best.score
    return iv, jv, sv
