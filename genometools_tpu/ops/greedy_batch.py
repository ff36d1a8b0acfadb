"""Batched greedy (front-prune) extension on device (JAX/XLA).

The device counterpart of ops/greedy.py: thousands of seed extensions run
as lanes of one fixed-shape front recurrence — the semantics equivalent
of the reference front-prune engine (ref: src/match/ft-front-prune.c:633
front_prune_edist_inplace + ft-polish.c), matching the scalar mirror
`ops.greedy.greedy_extend` bit for bit (lockstep-verified by
tests/test_greedy_batch.py).

Architecture (SURVEY §7 "batched extension with per-seed lanes"):

  * lanes: each seed extension is one lane; per-lane front state is a
    row of fixed-shape (N, K) arrays — rows, 64-bit match history as a
    pair of uint32 words, history size, max-mismatch counters
  * diagonal slots: slot s holds diagonal k = s - D + kbase(lane); the
    front window is recentred between chunks so K = 2D+1 slots always
    cover the live (trimmed) window plus one chunk of drift
  * match bitmasks instead of a run table: M[n, s, w] packs 32 match
    bits (U[i]==V[i+k], specials never match) per uint32 word, built
    once per chunk in O(N*K*W) bool ops.  The greedy run extension
    fetches 32 bits at the current row and counts trailing matches with
    popcount — O(N*K) per step, no O(W) one-hot per generation
  * chunked continuation: windows of W symbols slide along u and v.  A
    generation whose front touches the window edge (or the diagonal
    slot edge) is rolled back and the lane pauses; the host advances
    the window origins (du, dv), rebases rows/diagonals, and resumes
    the lane in the next chunk — so arbitrarily long extensions stay on
    device and remain bit-exact
  * polishing: the reference's 2x15-bit history test is evaluated by
    the same MSB-first score walk that fills its table
    (ref: ft-polish.c fill_polishing_info), unrolled as elementwise ops

Absolute vs relative bookkeeping: rows are relative to du, diagonals to
kbase; alignedlen = 2*row_rel + k_rel + albase with albase = 2*du+kbase,
so trims compare correctly in relative terms and the best polished point
is stored absolutely.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

NEGINF = jnp.int32(-(2 ** 30))
_U32 = jnp.uint32


# ---------------------------------------------------------------------------
# 64-bit history as a pair of uint32 words
# ---------------------------------------------------------------------------

def _shl64(hlo, hhi, c):
    """(hhi:hlo) << c with c int32 in [0, inf); bits beyond 64 drop."""
    c = jnp.clip(c, 0, 64)
    a = jnp.clip(c, 0, 31).astype(_U32)            # for the c<32 case
    ra = jnp.clip(32 - c, 1, 31).astype(_U32)      # 32-c, valid c in [1,31]
    b = jnp.clip(c - 32, 0, 31).astype(_U32)       # for the c>=32 case
    lo_lt = hlo << a
    carry = jnp.where(c > 0, hlo >> ra, _U32(0))
    hi_lt = (hhi << a) | carry
    hi_ge = hlo << b
    ge32 = c >= 32
    lo = jnp.where(c >= 64, _U32(0), jnp.where(ge32, _U32(0), lo_lt))
    hi = jnp.where(c >= 64, _U32(0), jnp.where(ge32, hi_ge, hi_lt))
    return lo, hi


def _ones64(c):
    """Low-c ones as a uint32 pair; c int32 >= 0, saturates at 64."""
    c = jnp.clip(c, 0, 64)
    a = jnp.clip(c, 0, 31).astype(_U32)
    b = jnp.clip(c - 32, 0, 31).astype(_U32)
    lo = jnp.where(c >= 32, _U32(0xFFFFFFFF), (_U32(1) << a) - _U32(1))
    hi = jnp.where(c >= 64, _U32(0xFFFFFFFF),
                   jnp.where(c >= 32, (_U32(1) << b) - _U32(1), _U32(0)))
    return lo, hi


def _popcount64(hlo, hhi):
    return (jax.lax.population_count(hlo).astype(jnp.int32)
            + jax.lax.population_count(hhi).astype(jnp.int32))


def _ctz32(x):
    """Trailing zeros of uint32; 32 for x == 0."""
    iso = x & (~x + _U32(1))
    return jax.lax.population_count(iso - _U32(1)).astype(jnp.int32)


# ---------------------------------------------------------------------------
# polishing (ref: ft-polish.c) — score walk instead of a 32k-entry table
# ---------------------------------------------------------------------------

def _polish_walk(prefix15, match_score, difference_score, cut_depth: int):
    """diff_from_max and score_sum of a cut_depth-bit prefix, walked
    MSB-first exactly like the reference's fill_polishing_info."""
    score = jnp.zeros_like(prefix15)
    maxscore = jnp.zeros_like(prefix15)
    for b in range(cut_depth - 1, -1, -1):
        maxscore = jnp.maximum(maxscore, score)
        bit = (prefix15 >> b) & 1
        score = score + jnp.where(bit == 1, match_score, -difference_score)
    return score - maxscore, score


# ---------------------------------------------------------------------------
# per-chunk device kernel
# ---------------------------------------------------------------------------

def _base_bitmasks(X, W: int):
    """(N, 4, W32) uint32: bit i of word w of plane b is X[32w+i] == b.
    Special codes (>= 4) set no bit in any plane."""
    N = X.shape[0]
    W32 = W // 32
    weights = (_U32(1) << jnp.arange(32, dtype=_U32))[None, None, None, :]
    planes = (X[:, None, :] ==
              jnp.arange(4, dtype=X.dtype)[None, :, None])   # (N, 4, W)
    return jnp.sum(planes.reshape(N, 4, W32, 32).astype(_U32) * weights,
                   axis=3, dtype=_U32)                        # (N, 4, W32)


def _match_bitmask(U, V, W: int, D: int):
    """M[n, s, w]: uint32 words of match bits; bit b of word w is
    (U[i] == V[i+k]) & (U[i] < 4) at i = 32*w + b, diag k = s - D."""
    return _match_from_planes(_base_bitmasks(U, W), _base_bitmasks(V, W),
                              W, D)


def _match_from_planes(Ub, Vb, W: int, D: int):
    """Bit-parallel match bitmask from per-base one-hot bitplanes:
    each diagonal's match word is OR_b(Ub & funnel_shift(Vb, k))
    — ~10 word ops per (k, w) instead of 32 symbol compares, with the
    K shifts vectorized in groups of equal word offset k>>5."""
    W32 = W // 32
    K = 2 * D + 1
    Ub = Ub[:, :, None, :]                                    # (N,4,1,W32)
    pad = D // 32 + 1
    Vbp = jnp.pad(Vb, ((0, 0), (0, 0), (pad, pad + 1)))
    ks = np.arange(K) - D
    qs = ks >> 5                                              # word offset
    rs = (ks - (qs << 5)).astype(np.uint32)                   # bit offset
    out = []
    for q in np.unique(qs):
        sel = qs == q
        r_g = jnp.asarray(rs[sel], _U32)[None, None, :, None]
        V0 = Vbp[:, :, None, pad + int(q):pad + int(q) + W32]
        V1 = Vbp[:, :, None, pad + int(q) + 1:pad + int(q) + 1 + W32]
        hi_sh = jnp.clip(_U32(32) - r_g, 1, 31)
        hi = jnp.where(r_g > 0, V1 << hi_sh, _U32(0))
        Vsh = (V0 >> r_g) | hi                                # (N,4,Kg,W32)
        m = Ub & Vsh
        out.append(m[:, 0] | m[:, 1] | m[:, 2] | m[:, 3])     # (N,Kg,W32)
    return jnp.concatenate(out, axis=1)                       # (N,K,W32)


@partial(jax.jit, static_argnames=("W", "D", "GENS", "cut_depth"))
def greedy_chunk_xla(U, V, row, hlo, hhi, hsize, mm, valid,
                     d_lane, done, died, best,
                     urem, vrem, kbase, rowbase,
                     minmatchpercentage128, maxalignedlendifference,
                     match_score, difference_score, hist_cap,
                     W: int, D: int, GENS: int, cut_depth: int = 15):
    """Run up to GENS generations of the greedy front recurrence.

    State is post-generation-d_lane (raw gen-0 state from the host is
    fine: the input state is trim/polish/completion-scored first, which
    is idempotent on already-scored states).  Returns the updated state
    plus a `paused` flag for lanes that hit a window or slot edge and
    rolled back their last generation.
    """
    N, K = row.shape
    W32 = W // 32
    pol_size = 2 * cut_depth
    karr = (jnp.arange(K, dtype=jnp.int32) - D)[None, :]
    sidx = jnp.arange(K, dtype=jnp.int32)[None, :]
    M = _match_bitmask(U, V, W, D)
    w_iota = jnp.arange(W32, dtype=jnp.int32)[None, None, :]

    hmask_lo, hmask_hi = _ones64(hist_cap)
    ulen_c = jnp.minimum(urem, W)
    vlen_c = jnp.minimum(vrem, W)
    u_more = urem > W
    v_more = vrem > W
    ul = ulen_c[:, None]
    vl = vlen_c[:, None]
    albase = (2 * rowbase + kbase)[:, None]

    def fetch_word(w):
        """M[n, s, w[n, s]] with clamp+mask; one-hot over W32 words."""
        onehot = w[:, :, None] == w_iota
        vals = jnp.sum(jnp.where(onehot, M, _U32(0)), axis=2)
        return jnp.where((w >= 0) & (w < W32), vals, _U32(0))

    def add_matches(row, hlo, hhi, hsize, valid):
        """Greedy run extension: 32 match bits per step via popcount."""
        def cond(st):
            return st[0].any()

        def body(st):
            cont, row, hlo, hhi, hsize = st
            wi = row >> 5
            off = (row & 31).astype(_U32)
            w0 = fetch_word(wi)
            w1 = fetch_word(wi + 1)
            hi_sh = jnp.clip(32 - off.astype(jnp.int32), 1, 31).astype(_U32)
            bits = (w0 >> off) | jnp.where(off > 0, w1 << hi_sh, _U32(0))
            c = jnp.where(cont, _ctz32(~bits), 0)
            olo, ohi = _ones64(c)
            slo, shi = _shl64(hlo, hhi, c)
            hlo = jnp.where(cont, slo | olo, hlo)
            hhi = jnp.where(cont, shi | ohi, hhi)
            hsize = jnp.where(cont, jnp.minimum(hsize + c, hist_cap), hsize)
            row = row + c
            return cont & (c == 32), row, hlo, hhi, hsize

        cont0 = valid & (row >= 0) & (row < W)
        _, row, hlo, hhi, hsize = jax.lax.while_loop(
            cond, body, (cont0, row, hlo, hhi, hsize))
        return row, hlo, hhi, hsize

    def trim_and_score(row, hlo, hhi, hsize, mm, valid, d, best, done):
        """Flank trimming, polished-point update, completion test.
        Idempotent — safe to re-apply to an already-scored state."""
        rsafe = jnp.maximum(row, 0)
        # absolute alignedlen: the reference clamps minlen at 0 on the
        # absolute scale, so relative lengths would mis-trim once the
        # window has advanced (albase = 2*du + kbase)
        alignedlen = jnp.where(valid, 2 * rsafe + karr + albase, NEGINF)
        maxal = jnp.max(alignedlen, axis=1)
        minlen = jnp.maximum(maxal - maxalignedlendifference, 0)
        need = (hsize * minmatchpercentage128) >> 7
        keep = valid & (row <= ul) & (row + karr <= vl) & \
            (alignedlen >= minlen[:, None]) & \
            (_popcount64(hlo & hmask_lo, hhi & hmask_hi) >= need)
        anyk = keep.any(axis=1)
        first = jnp.argmax(keep, axis=1)
        last = K - 1 - jnp.argmax(keep[:, ::-1], axis=1)
        inwin = (sidx >= first[:, None]) & (sidx <= last[:, None])
        valid = valid & inwin & anyk[:, None]
        died_now = ~anyk & ~done

        # polished-point update (ref: ft_update_trace_and_polished)
        fill = jnp.maximum(pol_size - hsize, 0)
        flo, fhi = _ones64(fill)
        slo, _ = _shl64(flo, fhi, jnp.minimum(hsize, 64))
        filled_lo = hlo | slo                     # pol_size <= 30 bits
        p_lo = (filled_lo & _U32(0x7FFF)).astype(jnp.int32)
        p_hi = ((filled_lo >> _U32(cut_depth)) & _U32(0x7FFF)) \
            .astype(jnp.int32)
        dfm_lo, ss_lo = _polish_walk(p_lo, match_score, difference_score,
                                     cut_depth)
        dfm_hi, _ = _polish_walk(p_hi, match_score, difference_score,
                                 cut_depth)
        polished = (dfm_lo >= 0) & (ss_lo + dfm_hi >= 0)
        cand = jnp.where(valid & polished & ~done[:, None],
                         alignedlen, NEGINF)
        cbest = jnp.max(cand, axis=1)
        kpick = jnp.argmax(cand == cbest[:, None], axis=1)
        better = cbest > best[:, 0]
        pick = lambda a: jnp.take_along_axis(a, kpick[:, None], axis=1)[:, 0]
        newbest = jnp.stack(
            [cbest, pick(rsafe) + rowbase, d, pick(mm)], axis=1)
        best = jnp.where(better[:, None], newbest, best)

        # completion: front[end_k].row == ulen (all in relative terms;
        # end_k_rel = vrem - urem, |end_k_abs| <= d)
        e_rel = vrem - urem
        eidx = jnp.clip(e_rel + D, 0, K - 1)
        take1 = lambda a: jnp.take_along_axis(a, eidx[:, None], axis=1)[:, 0]
        ok_k = (jnp.abs(e_rel + kbase) <= d) & (jnp.abs(e_rel) <= D) & \
            take1(valid) & (take1(row) == urem)
        complete_now = ok_k & ~done
        return valid, best, died_now, complete_now

    # ---- score the input state (gen-0 raw state, or idempotent) -----
    valid, best, died_now, complete_now = trim_and_score(
        row, hlo, hhi, hsize, mm, valid, d_lane, best, done)
    died = died | died_now
    done = done | died_now | complete_now
    paused = jnp.zeros(N, jnp.bool_)

    def gen(_, carry):
        (row, hlo, hhi, hsize, mm, valid, best, done, died, paused,
         d_lane) = carry
        act = ~done & ~paused

        def sh(a, fillval, off):
            if off == 1:   # from slot s-1 (diag k-1)
                return jnp.pad(a, ((0, 0), (1, 0)),
                               constant_values=fillval)[:, :K]
            return jnp.pad(a, ((0, 0), (0, 1)),
                           constant_values=fillval)[:, 1:]

        # candidates: INS from k-1 (row same), MIS from k (row+1),
        # DEL from k+1 (row+1) — first of that order wins row ties
        v_ins = sh(valid, False, 1)
        v_del = sh(valid, False, -1)
        r_ins = jnp.where(v_ins, sh(row, 0, 1), NEGINF)
        r_mis = jnp.where(valid, row + 1, NEGINF)
        r_del = jnp.where(v_del, sh(row, 0, -1) + 1, NEGINF)
        r_new = jnp.maximum(jnp.maximum(r_ins, r_mis), r_del)
        anyc = r_new > NEGINF
        use_ins = v_ins & (r_ins == r_new)
        use_mis = valid & (r_mis == r_new) & ~use_ins
        use_del = v_del & (r_del == r_new) & ~use_ins & ~use_mis

        def pick3(a_ins, a_mis, a_del, zero):
            return jnp.where(use_ins, a_ins,
                             jnp.where(use_mis, a_mis,
                                       jnp.where(use_del, a_del, zero)))

        hlo_n = pick3(sh(hlo, _U32(0), 1), hlo, sh(hlo, _U32(0), -1),
                      _U32(0))
        hhi_n = pick3(sh(hhi, _U32(0), 1), hhi, sh(hhi, _U32(0), -1),
                      _U32(0))
        hs_n = pick3(sh(hsize, 0, 1), hsize, sh(hsize, 0, -1), 0)
        # mismatches: max over tied ins/mis; a deletion contributes its
        # mm only when it wins outright (ref ft-front-prune.c:395-407:
        # the deletion-tie branch has no max_mismatches update)
        mm_ins = jnp.where(v_ins & (r_ins == r_new), sh(mm, 0, 1), NEGINF)
        mm_mis = jnp.where(valid & (r_mis == r_new), mm + 1, NEGINF)
        mm_del = jnp.where(v_del & (r_del == r_new), sh(mm, 0, -1), NEGINF)
        mm_im = jnp.maximum(mm_ins, mm_mis)
        mm_n = jnp.where(mm_im > NEGINF, mm_im, mm_del)

        hs_n = jnp.minimum(hs_n + 1, hist_cap)      # shift a difference in
        hlo_n, hhi_n = _shl64(hlo_n, hhi_n, jnp.ones((), jnp.int32))
        row_n = jnp.where(anyc, r_new, NEGINF)
        row_n, hlo_n, hhi_n, hs_n = add_matches(
            row_n, hlo_n, hhi_n, hs_n, anyc)

        # window/slot edge contact => roll this generation back, pause
        contact = (anyc & (
            (u_more[:, None] & (row_n >= W))
            | (v_more[:, None] & (row_n + karr >= W))
            | (sidx <= 0) | (sidx >= K - 1))).any(axis=1)
        pause_now = act & contact
        commit = act & ~contact

        d_next = jnp.where(commit, d_lane + 1, d_lane)
        valid_n, best_n, died_now, complete_now = trim_and_score(
            row_n, hlo_n, hhi_n, hs_n, mm_n, anyc, d_next, best,
            done | pause_now | ~act)

        cm = commit[:, None]
        row = jnp.where(cm, row_n, row)
        hlo = jnp.where(cm, hlo_n, hlo)
        hhi = jnp.where(cm, hhi_n, hhi)
        hsize = jnp.where(cm, hs_n, hsize)
        mm = jnp.where(cm, mm_n, mm)
        valid = jnp.where(cm, valid_n, valid)
        best = jnp.where(commit[:, None], best_n, best)
        died = died | (commit & died_now)
        done = done | (commit & (died_now | complete_now))
        paused = paused | pause_now
        return (row, hlo, hhi, hsize, mm, valid, best, done, died,
                paused, d_next)

    carry = (row, hlo, hhi, hsize, mm, valid, best, done, died, paused,
             d_lane)
    carry = jax.lax.fori_loop(0, GENS, gen, carry)
    (row, hlo, hhi, hsize, mm, valid, best, done, died, paused,
     d_lane) = carry
    return (row, hlo, hhi, hsize, mm, valid, best, done, died, paused,
            d_lane)


# ---------------------------------------------------------------------------
# host driver: windowing, rebasing, chunk loop
# ---------------------------------------------------------------------------

def _host_lcp(u, v):
    """Initial match run (wildcards never match) — one np pass."""
    m = min(len(u), len(v))
    if m == 0:
        return 0
    eq = (u[:m] == v[:m]) & (u[:m] < 4)
    bad = np.flatnonzero(~eq)
    return int(bad[0]) if bad.size else m


class _GreedyBatchConfig:
    # window tiers: a lane that cannot make progress at one tier (its
    # current match run crosses the whole window, so the generation can
    # never commit) escalates to the next, 4x larger window; only
    # exhausting the largest tier falls back to the host engine
    W_TIERS = (384, 1536, 6144, 24576)
    # diagonal-slot tiers: most fronts stay narrow (trimming holds the
    # live window near maxalignedlendifference diagonals), so lanes run
    # in a cheap K=2*16+1-slot wave and only escalate when a rebase
    # finds their live spread no longer fits
    D_TIERS = (16, 64)
    GENS = 48          # generations per chunk call (fori_loop runs all)
    MAX_CHUNKS = 512
    MAX_WAVE = 131072  # per-device-call lane cap (bounds M + state HBM)

    # kept for tests that pin a single diagonal window
    @property
    def D(self):
        return self.D_TIERS[-1]

    @D.setter
    def D(self, value):
        self.D_TIERS = (value,)

    # kept for tests that pin a single window size
    @property
    def W(self):
        return self.W_TIERS[0]

    @W.setter
    def W(self, value):
        self.W_TIERS = (value,)


def greedy_extend_batch(us, vs, *, seedlengths, perc_mat_history: int,
                        maxalignedlendifference: int,
                        errorpercentage: float = 0.0,
                        history: int = 64, matchscore_bias: float = 1.0,
                        pol_info=None,
                        cfg: _GreedyBatchConfig | None = None):
    """Batched greedy extension of prefixes of us[i] vs vs[i].

    Returns a dict of int32 arrays (alignedlen, row, distance,
    mismatches) for the best polished point per lane, `died` flags, and
    `fallback` — lanes the device could not finish (slot-window
    overflow or chunk budget); callers must recompute those with the
    host engine.  All non-fallback lanes are bit-exact vs
    ops.greedy.greedy_extend.
    """
    if not 30 <= history <= 64:
        # cut_depth shrinks below 15 for history < 30; not mirrored here
        raise NotImplementedError("device greedy batch requires a match "
                                  "history size in [30, 64]")
    cfg = cfg or _GreedyBatchConfig()
    tiers, dtiers = cfg.W_TIERS, cfg.D_TIERS
    GENS = cfg.GENS
    D = dtiers[-1]                    # host state is kept at max width
    K = 2 * D + 1
    N = len(us)
    sl = np.asarray(seedlengths, np.int64)
    if sl.ndim == 0:
        sl = np.full(N, int(sl), np.int64)

    if pol_info is not None:      # exact scores from an existing
        match_score = pol_info.match_score        # PolishingInfo object
        difference_score = pol_info.difference_score
    else:
        match_score = int(20.0 * errorpercentage * matchscore_bias)
        difference_score = 1000 - match_score
    mmp128 = (perc_mat_history * 128) // 100 + \
        (0 if (perc_mat_history * 128) % 100 == 0 else 1)

    ulens = np.asarray([len(u) for u in us], np.int64)
    vlens = np.asarray([len(v) for v in vs], np.int64)
    died = np.zeros(N, bool)
    results = {k: np.zeros(N, np.int32) for k in
               ("alignedlen", "row", "distance", "mismatches")}

    # ---- host generation 0: initial run from the seed ---------------
    du = np.zeros(N, np.int64)        # window origin in u == min live row
    dv = np.zeros(N, np.int64)
    row = np.full((N, K), -(2 ** 30), np.int32)
    hlo = np.zeros((N, K), np.uint32)
    hhi = np.zeros((N, K), np.uint32)
    hsize = np.zeros((N, K), np.int32)
    mm = np.zeros((N, K), np.int32)
    valid = np.zeros((N, K), bool)
    d_lane = np.zeros(N, np.int32)
    done = np.zeros(N, bool)
    best = np.zeros((N, 4), np.int32)
    fallback = np.zeros(N, bool)

    for i in range(N):
        c0 = _host_lcp(us[i], vs[i])
        seed = int(sl[i])
        h = ((1 << 64) - 1) if seed >= 64 else ((1 << seed) - 1)
        c_eff = min(c0, 64)
        h = ((h << c_eff) | ((1 << c_eff) - 1)) & ((1 << 64) - 1) \
            if c0 < 64 else (1 << 64) - 1
        hs = min(seed + c0, history)
        # window starts at the run end; rows/cols relative to (du, dv)
        du[i] = c0
        dv[i] = c0
        row[i, D] = 0
        hlo[i, D] = h & 0xFFFFFFFF
        hhi[i, D] = (h >> 32) & 0xFFFFFFFF
        hsize[i, D] = hs
        valid[i, D] = True

    pending = np.arange(N, dtype=np.int64)
    tier = np.zeros(N, np.int32)      # index into W tiers, per lane
    dtier = np.zeros(N, np.int32)     # index into D tiers, per lane

    for _chunk in range(cfg.MAX_CHUNKS):
        if pending.size == 0:
            break
        # one device call per (window, diag) tier pair among pending
        # lanes; lanes sorted by remaining work, so a tier larger than
        # MAX_WAVE sends the lanes nearest completion first
        key = tier[pending] * len(dtiers) + dtier[pending]
        P = pending[key == key.min()]
        remaining = (ulens[P] - du[P]) + (vlens[P] - dv[P])
        P = P[np.argsort(remaining, kind="stable")][:cfg.MAX_WAVE]
        W = tiers[int(tier[P[0]])]
        Dw = dtiers[int(dtier[P[0]])]
        csl = slice(D - Dw, D + Dw + 1)   # wave's slot columns
        NP_ = P.size
        U = np.full((NP_, W), 254, np.uint8)
        V = np.full((NP_, W), 255, np.uint8)
        urem = np.zeros(NP_, np.int64)
        vrem = np.zeros(NP_, np.int64)
        for t, i in enumerate(P):
            u, v = us[i], vs[i]
            urem[t] = len(u) - du[i]
            vrem[t] = len(v) - dv[i]
            uw = u[du[i]:du[i] + W]
            vw = v[dv[i]:dv[i] + W]
            U[t, :len(uw)] = uw
            V[t, :len(vw)] = vw
        kbase = (dv[P] - du[P]).astype(np.int32)
        d_before = d_lane[P].copy()

        # pad the lane count to a power of two so jit compiles are
        # reused across batch sizes; pad lanes start done=True
        NP2 = max(16, 1 << (NP_ - 1).bit_length())

        def padded(a, fill=0):
            if NP_ == NP2:
                return jnp.asarray(a)
            pad = np.full((NP2 - NP_,) + a.shape[1:], fill, a.dtype)
            return jnp.asarray(np.concatenate([a, pad]))

        out = greedy_chunk_xla(
            padded(U, 254), padded(V, 255),
            padded(row[P][:, csl]), padded(hlo[P][:, csl]),
            padded(hhi[P][:, csl]), padded(hsize[P][:, csl]),
            padded(mm[P][:, csl]),
            padded(valid[P][:, csl]), padded(d_lane[P]),
            padded(done[P], True), padded(died[P]),
            padded(best[P]),
            padded(np.minimum(urem, 2 ** 30).astype(np.int32)),
            padded(np.minimum(vrem, 2 ** 30).astype(np.int32)),
            padded(kbase),
            padded(np.minimum(du[P], 2 ** 30).astype(np.int32)),
            jnp.int32(mmp128), jnp.int32(maxalignedlendifference),
            jnp.int32(match_score), jnp.int32(difference_score),
            jnp.int32(history), W, Dw, GENS)
        (row_o, hlo_o, hhi_o, hsize_o, mm_o, valid_o, best_o, done_o,
         died_o, paused_o, d_o) = (np.asarray(a)[:NP_] for a in out)

        best[P] = best_o
        done[P] = done_o
        died[P] = died_o
        d_lane[P] = d_o

        # finished lanes -> results
        fin = P[done_o]
        results["alignedlen"][fin] = best[fin, 0]
        results["row"][fin] = best[fin, 1]
        results["distance"][fin] = best[fin, 2]
        results["mismatches"][fin] = best[fin, 3]

        # continuing lanes: rebase window around the live front
        cont = P[~done_o]
        nxt = list(pending[~np.isin(pending, P)])
        for t, i in zip(np.flatnonzero(~done_o), cont):
            vs_mask = valid_o[t]
            rows = row_o[t][vs_mask].astype(np.int64)
            ks_rel = np.flatnonzero(vs_mask).astype(np.int64) - Dw
            ks = ks_rel + int(kbase[t])     # absolute diagonals
            cols = rows + ks_rel            # columns relative to dv
            rmin = int(rows.min())
            cmin = int(cols.min())
            du_n = du[i] + rmin
            dv_n = dv[i] + cmin
            # ks are absolute diagonals (relative to the extension
            # origin); the new kbase is dv_n - du_n.  Pick the smallest
            # diagonal tier whose recentred slot window holds the live
            # spread (tiers both escalate and relax here).
            off = ks - (dv_n - du_n)
            amax = int(np.abs(off).max())
            ndt = next((j for j, Dt in enumerate(dtiers)
                        if amax <= Dt - 1), None)
            if ndt is None:
                fallback[i] = True
                continue
            slots_new = off + D
            # no progress: the current match run crosses the whole
            # window (or the front spread fills it) so no generation
            # can commit — widen the slot window if the spread is the
            # limiter, else escalate to the next, larger window tier
            no_prog = (d_o[t] == d_before[t] and du_n == du[i]
                       and dv_n == dv[i])
            if no_prog and ndt < len(dtiers) - 1 and amax >= Dw - 2:
                ndt += 1
            elif no_prog or rows.max() - rmin >= W - 64:
                if tier[i] + 1 < len(tiers):
                    tier[i] += 1
                else:
                    fallback[i] = True
                    continue
            elif tier[i] > 0:
                # progress made: drop back toward the cheap tier (the
                # long run that forced the escalation has been crossed)
                tier[i] -= 1
            dtier[i] = ndt
            nrow = np.full(K, -(2 ** 30), np.int32)
            nhlo = np.zeros(K, np.uint32)
            nhhi = np.zeros(K, np.uint32)
            nhs = np.zeros(K, np.int32)
            nmm = np.zeros(K, np.int32)
            nval = np.zeros(K, bool)
            src = np.flatnonzero(vs_mask)
            nrow[slots_new] = (rows - rmin).astype(np.int32)
            nhlo[slots_new] = hlo_o[t][src]
            nhhi[slots_new] = hhi_o[t][src]
            nhs[slots_new] = hsize_o[t][src]
            nmm[slots_new] = mm_o[t][src]
            nval[slots_new] = True
            row[i], hlo[i], hhi[i] = nrow, nhlo, nhhi
            hsize[i], mm[i], valid[i] = nhs, nmm, nval
            du[i], dv[i] = du_n, dv_n
            nxt.append(i)
        pending = np.asarray(nxt, dtype=np.int64)
    else:
        fallback[pending] = True
        pending = np.zeros(0, np.int64)

    if pending.size:
        fallback[pending] = True

    return {
        "alignedlen": results["alignedlen"],
        "row": results["row"],
        "distance": results["distance"],
        "mismatches": results["mismatches"],
        "died": died & ~fallback,
        "fallback": fallback,
    }
