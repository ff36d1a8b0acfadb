"""FM-index: BWT-based compressed full-text index.

Capability equivalent of the reference packedindex / BWTSeq stack
(ref: src/match/eis-bwtseq.c, eis-blockcomp.c, eis-bwtseq-construct.c,
`gt packedindex mkindex` and the legacy fmindex src/match/fmi-*).

Redesign: instead of block-composition encoding, the occ function is a
sampled checkpoint matrix plus a vectorized partial count — the natural
array layout for numpy/accelerators (rank = checkpoint[c, pos/k] +
count(bwt[k*(pos/k):pos] == c)), and locate uses a sampled suffix array
with LF-walks. Functionally covers: exact backward search (count),
locate, and sequence context regeneration (extract).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..core.encseq import FWD, Encseq
from .esa import EnhancedSuffixArray, build_esa


@dataclass
class FMIndex:
    bwt: np.ndarray            # uint8[n+1], 255 = sentinel/special
    counts_less: np.ndarray    # int64[sigma+2]: C array over code order
    occ_checkpoints: np.ndarray  # int64[sigma, nblocks]
    sa_samples: np.ndarray     # int64[ceil((n+1)/s)] suffix positions
    sample_rate: int
    block_size: int
    sigma: int = 4

    # -- construction ------------------------------------------------------
    @classmethod
    def from_esa(cls, esa: EnhancedSuffixArray, block_size: int = 128,
                 sample_rate: int = 32) -> "FMIndex":
        bwt = esa.bwt()
        n1 = bwt.size
        sigma = esa.encseq.alphabet.num_chars
        # treat every special/sentinel BWT byte as one class 'sigma'
        sym = np.where(bwt >= 250, sigma, bwt).astype(np.int64)
        counts = np.bincount(sym, minlength=sigma + 1)
        counts_less = np.zeros(sigma + 2, np.int64)
        np.cumsum(counts, out=counts_less[1:])
        nblocks = (n1 + block_size - 1) // block_size
        occ = np.zeros((sigma, nblocks + 1), np.int64)
        for c in range(sigma):
            hits = (sym == c).astype(np.int64)
            block_sums = np.add.reduceat(
                hits, np.arange(0, n1, block_size))
            occ[c, 1:] = np.cumsum(block_sums)
        sa = esa.suftab.astype(np.int64)
        samples = sa[::sample_rate].copy()
        return cls(bwt, counts_less, occ[:, :-1], samples, sample_rate,
                   block_size, sigma)

    # -- rank --------------------------------------------------------------
    def occ(self, c: int, pos: int) -> int:
        """# occurrences of regular code c in bwt[0:pos]."""
        b = pos // self.block_size
        base = int(self.occ_checkpoints[c, b])
        lo = b * self.block_size
        return base + int(np.count_nonzero(self.bwt[lo:pos] == c))

    # -- backward search ---------------------------------------------------
    def backward_search(self, pattern: np.ndarray) -> tuple[int, int]:
        """suftab interval [lo, hi) of `pattern` (ref: gt_packedindexmstatsforward
        / BWT backward search)."""
        lo, hi = 0, self.bwt.size
        for sym in pattern[::-1]:
            c = int(sym)
            if c >= self.sigma:
                return 0, 0
            lo = int(self.counts_less[c]) + self.occ(c, lo)
            hi = int(self.counts_less[c]) + self.occ(c, hi)
            if lo >= hi:
                return lo, lo
        return lo, hi

    def count(self, pattern: np.ndarray) -> int:
        lo, hi = self.backward_search(pattern)
        return hi - lo

    # -- locate ------------------------------------------------------------
    def _lf(self, rank: int) -> int:
        c = int(self.bwt[rank])
        if c >= 250:
            # specials/sentinel: not tracked; fall back below
            return -1
        return int(self.counts_less[c]) + self.occ(c, rank)

    def locate(self, pattern: np.ndarray, esa_sa: np.ndarray | None = None
               ) -> np.ndarray:
        """Positions of all occurrences. Walks LF to the nearest sampled
        rank; ranks whose walk hits an untracked special fall back to the
        provided plain suftab if given."""
        lo, hi = self.backward_search(pattern)
        out = []
        for rank in range(lo, hi):
            r = rank
            steps = 0
            while r % self.sample_rate != 0:
                nxt = self._lf(r)
                if nxt < 0:
                    break
                r = nxt
                steps += 1
            if r % self.sample_rate == 0:
                out.append(int(self.sa_samples[r // self.sample_rate]) + steps)
            elif esa_sa is not None:
                out.append(int(esa_sa[rank]))
        return np.sort(np.asarray(out, np.int64))

    # -- persistence -------------------------------------------------------
    def save(self, indexname: str) -> None:
        np.savez_compressed(indexname + ".fmi",
                            bwt=self.bwt, counts_less=self.counts_less,
                            occ=self.occ_checkpoints,
                            sa_samples=self.sa_samples)
        Path(indexname + ".fmi.json").write_text(json.dumps({
            "sample_rate": self.sample_rate, "block_size": self.block_size,
            "sigma": self.sigma}))

    @classmethod
    def load(cls, indexname: str) -> "FMIndex":
        d = np.load(indexname + ".fmi.npz")
        meta = json.loads(Path(indexname + ".fmi.json").read_text())
        return cls(d["bwt"], d["counts_less"], d["occ"], d["sa_samples"],
                   meta["sample_rate"], meta["block_size"], meta["sigma"])


def build_fmindex(encseq: Encseq, **kw) -> FMIndex:
    """`gt packedindex mkindex` equivalent."""
    esa = build_esa(encseq, FWD, with_lcp=False)
    return FMIndex.from_esa(esa, **kw)


# ---------------------------------------------------------------------------
# construction straight from codes (SA-IS; no doubling engine needed) and
# device-batched rank/search — the packedindex depth layer
# (ref: src/match/eis-blockcomp.c block-encoded rank, eis-bwtseq.c)
# ---------------------------------------------------------------------------

def fmindex_from_codes(codes: np.ndarray, sigma: int = 4,
                       block_size: int = 128,
                       sample_rate: int = 32) -> FMIndex:
    """Build an FMIndex over raw uint8 codes via the linear-time SA-IS
    constructor (native), including the sentinel suffix — so intervals
    match the ESA searcher exactly.  Keeps `codes` on the index for
    special-context walks (tagerator) and extraction."""
    from ..core.chardef import is_special
    from ..core.native import sais_native
    n = codes.size
    keys = np.where(is_special(codes),
                    sigma + np.arange(n, dtype=np.int64),
                    codes.astype(np.int64))
    keys = np.concatenate([keys, [sigma + n]])
    if keys[-1] < 2 ** 31 - 1:
        sa = sais_native(keys.astype(np.int32))
        if sa is None:
            import jax
            from .suffix import build_suffix_array
            sa, _ = build_suffix_array(keys.astype(np.int32),
                                       with_lcp=False)
            sa = np.asarray(sa)
        sa = sa.astype(np.int64)
    else:
        raise NotImplementedError("fmindex >2^31: use index.parts")
    n1 = sa.size
    prev = sa - 1
    bwt = np.where(prev >= 0, codes[np.maximum(prev, 0)],
                   np.uint8(255)).astype(np.uint8)
    sym = np.where(bwt >= 250, sigma, bwt).astype(np.int64)
    # specials in the BWT are one class for occ, but locate needs their
    # LF — handled by the sampled-SA fallback walk
    counts = np.bincount(sym, minlength=sigma + 1)
    counts_less = np.zeros(sigma + 2, np.int64)
    np.cumsum(counts, out=counts_less[1:])
    nblocks = (n1 + block_size - 1) // block_size
    occ = np.zeros((sigma, nblocks + 1), np.int64)
    for c in range(sigma):
        hits = (sym == c).astype(np.int64)
        block_sums = np.add.reduceat(hits, np.arange(0, n1, block_size))
        occ[c, 1:] = np.cumsum(block_sums)
    samples = sa[::sample_rate].copy()
    fm = FMIndex(bwt, counts_less, occ[:, :-1], samples, sample_rate,
                 block_size, sigma)
    fm.codes = codes
    fm.sa_full = sa          # retained for locate fallback/verification
    return fm


class FMDeviceRank:
    """Device-resident batched rank/backward-search over an FMIndex:
    the BWT travels as one-hot bitplanes (uint32 words) plus the
    checkpoint matrix; occ(c, pos) for a whole batch of (c, pos) lanes
    is a gather of checkpoints + a masked popcount over one block —
    vectorized across lanes (the device analog of the reference's
    block-compressed rank, eis-blockcomp.c)."""

    def __init__(self, fm: FMIndex):
        import jax.numpy as jnp
        self.fm = fm
        n1 = fm.bwt.size
        self.n1 = n1
        bs = fm.block_size
        assert bs % 32 == 0
        self.wpb = bs // 32                      # words per block
        nblocks = (n1 + bs - 1) // bs
        npad = nblocks * bs
        sym = np.where(fm.bwt >= 250, fm.sigma, fm.bwt).astype(np.uint8)
        sympad = np.full(npad, fm.sigma, np.uint8)
        sympad[:n1] = sym
        planes = []
        for c in range(fm.sigma):
            bits = (sympad == c)
            planes.append(np.packbits(
                bits, bitorder="little").view(np.uint32))
        self.planes = jnp.asarray(np.stack(planes))      # (sigma, words)
        self.ckpt = jnp.asarray(fm.occ_checkpoints.astype(np.int32))
        self.counts_less = jnp.asarray(fm.counts_less.astype(np.int32))

    def occ_batch(self, c, pos):
        """int32[len] occurrences of code c[i] in bwt[0:pos[i]]."""
        import jax.numpy as jnp
        bs = self.fm.block_size
        b = pos // bs
        base = self.ckpt[c, b]
        w0 = b * self.wpb
        r = pos - b * bs
        words = jnp.arange(self.wpb, dtype=jnp.int32)
        w = self.planes[c[:, None], w0[:, None] + words[None, :]]
        nbits = jnp.clip(r[:, None] - words[None, :] * 32, 0, 32)
        mask = jnp.where(nbits >= 32, jnp.uint32(0xFFFFFFFF),
                         (jnp.uint32(1) << nbits.astype(jnp.uint32)) - 1)
        pc = jax.lax.population_count(w & mask).astype(jnp.int32)
        return base + pc.sum(axis=1)

    def backward_search_batch(self, patterns: np.ndarray):
        """suftab intervals of a (B, m) uint8 pattern batch (255-padded
        on the LEFT for shorter patterns): one lax.scan over symbols,
        every step a batched occ — count for thousands of tags per
        dispatch."""
        import jax
        import jax.numpy as jnp
        pats = jnp.asarray(patterns.astype(np.int32))
        B = pats.shape[0]
        lo0 = jnp.zeros(B, jnp.int32)
        hi0 = jnp.full(B, self.n1, jnp.int32)

        def step(carry, syms):
            lo, hi = carry
            valid = (syms >= 0) & (syms < self.fm.sigma) & (lo < hi)
            c = jnp.maximum(syms, 0)
            nlo = self.counts_less[c] + self.occ_batch(c, lo)
            nhi = self.counts_less[c] + self.occ_batch(c, hi)
            lo = jnp.where(valid, nlo, jnp.where(syms >= 0, hi, lo))
            hi = jnp.where(valid, nhi, hi)
            return (lo, hi), None

        import functools
        scan = jax.jit(lambda l, h, p: jax.lax.scan(
            step, (l, h), p.T[::-1])[0])
        lo, hi = scan(lo0, hi0, jnp.where(pats == 255, -1, pats))
        return np.asarray(lo), np.asarray(hi)


import jax  # noqa: E402  (deferred: fmindex stays importable w/o device)


def pck_tagerator_search(fm_rev: FMIndex, tag: np.ndarray, max_edits: int,
                         totallength: int, nowildcards: bool = True):
    """tagerator DFS over the packed index: the index is built over the
    REVERSED codes (like `gt packedindex mkindex -dir rev`), so
    extending the tag path on the right is one backward-search step
    (ref: pck_splitandprocess, idx-limdfs.c); a reported occurrence at
    reverse-position q with depth d maps to forward start
    totallength - (q + d) (ref: gen_pck_overinterval, idx-limdfs.c:440).
    Special-context continuation walks locate the (few) suffixes whose
    next char is special and continue on the raw codes.
    Returns (dbpos, dblen, dist) rows; the match set equals
    querysearch.tagerator_search over the forward ESA."""
    m = len(tag)
    out = []
    if m == 0:
        return out
    e = int(max_edits)
    maxdepth = m + e
    init = np.arange(m + 1, dtype=np.int64)
    rcodes = fm_rev.codes
    n = rcodes.size

    def step_row(row, sym_matches):
        new = np.empty(m + 1, np.int64)
        new[0] = row[0] + 1
        cost = 1 - sym_matches.astype(np.int64)
        cand = np.minimum(row[:-1] + cost, row[1:] + 1)
        prev = new[0]
        for j in range(1, m + 1):
            prev = min(int(cand[j - 1]), prev + 1)
            new[j] = prev
        return new

    def locate_all(lo, hi):
        return [int(fm_rev.sa_full[r]) for r in range(lo, hi)]

    def context_walk(q, depth, row):
        d, r = depth, row
        while d <= maxdepth:
            if r[m] <= e:
                out.append((totallength - (q + d), d, int(r[m])))
                return
            if r.min() > e or q + d >= n:
                return
            cc = int(rcodes[q + d])
            if cc == 255:
                return
            r = step_row(r, tag == cc)
            d += 1

    def dfs(lo, hi, depth, row):
        if lo >= hi or depth > maxdepth:
            return
        if row[m] <= e:
            dist = int(row[m])
            for q in locate_all(lo, hi):
                out.append((totallength - (q + depth), depth, dist))
            return
        if row.min() > e:
            return
        covered_hi = lo
        for sym in range(fm_rev.sigma):
            l2 = int(fm_rev.counts_less[sym]) + fm_rev.occ(sym, lo)
            h2 = int(fm_rev.counts_less[sym]) + fm_rev.occ(sym, hi)
            if l2 < h2:
                dfs(l2, h2, depth + 1, step_row(row, tag == sym))
                covered_hi += h2 - l2
        # suffixes whose next char is special (or end): locate + walk
        # (only with -withwildcards; the reference's default nowildcards
        # excludes specials from matches, gt_tagerator.c:170-196)
        nregular = covered_hi - lo
        if nowildcards:
            return
        if nregular < hi - lo:
            for q in locate_all(lo, hi):
                if q + depth >= n:
                    continue
                cc = int(rcodes[q + depth])
                if cc < 4:
                    continue
                context_walk(q, depth + 1, step_row(row, tag == cc))

    dfs(0, fm_rev.bwt.size, 0, init)
    return out
