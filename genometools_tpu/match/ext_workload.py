"""Extension-workload extraction for benchmarking.

Reproduces the seed → diagband-filter → candidate pipeline of
`seed_extend` (ref: src/match/diagbandseed.c gt_diagbandseed_algorithm)
but stops right before the sequential accept loop and instead returns
every flank-extension task the greedy engine would see if no seed were
skipped.  This is the honest per-engine workload for an alignments/s
benchmark: each task is one (u, v, seedlength) greedy front extension,
identical in shape to what the device batch sees during a real run.

Two forms:
  * collect_extension_tasks — materialized (u, v) code arrays;
  * collect_extension_pool — one concatenated sequence pool plus
    int descriptors (u_off, u_len, v_off, v_len, rev), a compact form
    to cache on disk, where rev marks left flanks (both sides read
    reversed).
"""

from __future__ import annotations

import numpy as np

from ..core.encseq import Encseq
from .seed_extend import (SeedExtendParams, _seq_codes, build_seed_pairs,
                          default_seedlength, enumerate_kmers)


def _candidate_refs(aenc: Encseq, params: SeedExtendParams | None,
                    max_tasks: int | None):
    """Yields per-flank references (ukey, ulo, uhi, vkey, vlo, vhi, rev)
    into the per-sequence cache, plus the cache and seedlength."""
    params = params or SeedExtendParams()
    k = params.seedlength or default_seedlength(aenc, aenc)
    mincov = params.mincoverage if params.mincoverage is not None \
        else int(2.5 * k)
    alist = enumerate_kmers(aenc, k, revcomp=False)
    amaxlen = aenc.max_seq_length()
    logw = params.logdiagbandwidth

    refs: list[tuple] = []
    seq_cache: dict = {}
    for direction in ("F", "P"):
        blist = enumerate_kmers(aenc, k, revcomp=(direction == "P"))
        pa_seq, pb_seq, pb_pos, pa_pos = build_seed_pairs(
            alist, blist, True, params.maxfreq, inseqseeds=True,
            mindist=k if direction == "F" else 0)
        n = pa_seq.size
        if n == 0:
            continue
        seg_break = np.zeros(n, bool)
        seg_break[0] = True
        seg_break[1:] = (pa_seq[1:] != pa_seq[:-1]) | \
            (pb_seq[1:] != pb_seq[:-1])
        seg_starts = np.flatnonzero(seg_break)
        seg_ends = np.append(seg_starts[1:], n)
        for s0, s1 in zip(seg_starts, seg_ends):
            aseq, bseq = int(pa_seq[s0]), int(pb_seq[s0])
            apos = pa_pos[s0:s1].astype(np.int64)
            bpos = pb_pos[s0:s1].astype(np.int64)
            band = (amaxlen + bpos - apos) >> logw
            nb = int(band.max()) + 2
            score = np.zeros(nb + 2, np.int64)
            lastpos = np.zeros(nb + 2, np.int64)
            for i in range(apos.size):
                d = int(band[i]) + 1
                key = int(bpos[i])
                if lastpos[d] == 0 or lastpos[d] + k <= key:
                    lastpos[d] = key
                    score[d] += k
                elif lastpos[d] < key:
                    score[d] += key - lastpos[d]
                    lastpos[d] = key
            coverage = score[band + 1] + np.maximum(score[band],
                                                    score[band + 2])
            sel = coverage >= mincov
            if not sel.any():
                continue
            ukey = ("a", aseq)
            if ukey not in seq_cache:
                seq_cache[ukey] = _seq_codes(aenc, aseq, False)
            vkey = ("b", bseq, direction)
            if vkey not in seq_cache:
                seq_cache[vkey] = _seq_codes(aenc, bseq,
                                             direction == "P")
            useq = seq_cache[ukey]
            vseq = seq_cache[vkey]
            same_seq = aseq == bseq
            for i in np.nonzero(sel)[0]:
                bp, ap = int(bpos[i]), int(apos[i])
                db, qs = ap + 1 - k, bp + 1 - k
                if same_seq and db + k - 1 >= qs:
                    continue
                if db > 0 and qs > 0:
                    voff = db + k if same_seq else 0
                    if qs - voff > 0:
                        refs.append((ukey, 0, db, vkey, voff, qs, True))
                urb = min(len(useq), qs) if same_seq else len(useq)
                if db + k < urb and qs + k < len(vseq):
                    refs.append((ukey, db + k, urb, vkey, qs + k,
                                 len(vseq), False))
                if max_tasks is not None and len(refs) >= max_tasks:
                    return refs, seq_cache, k
    return refs, seq_cache, k


def collect_extension_tasks(aenc: Encseq,
                            params: SeedExtendParams | None = None,
                            max_tasks: int | None = None):
    """Return (tasks, k): tasks is a list of (u, v) uint8 code arrays —
    one per flank extension (left flanks reversed, right flanks as-is),
    k is the seedlength.  Self-comparison, both strands, diagband
    filter applied, skip logic NOT applied."""
    refs, cache, k = _candidate_refs(aenc, params, max_tasks)
    tasks = []
    for ukey, ulo, uhi, vkey, vlo, vhi, rev in refs:
        u = cache[ukey][ulo:uhi]
        v = cache[vkey][vlo:vhi]
        if rev:
            u = u[::-1]
            v = v[::-1]
        tasks.append((u, v))
    return tasks, k


def collect_extension_pool(aenc: Encseq,
                           params: SeedExtendParams | None = None,
                           max_tasks: int | None = None):
    """Return (pool, u_off, u_len, v_off, v_len, rev, k): pool is the
    concatenation of every sequence variant the tasks reference; rev
    lanes read both flanks reversed (left flanks)."""
    refs, cache, k = _candidate_refs(aenc, params, max_tasks)
    bases = {}
    parts = []
    pos = 0
    for key, seq in cache.items():
        bases[key] = pos
        parts.append(np.asarray(seq, np.uint8))
        pos += len(seq)
    pool = np.concatenate(parts) if parts else np.zeros(1, np.uint8)
    n = len(refs)
    u_off = np.zeros(n, np.int64)
    u_len = np.zeros(n, np.int64)
    v_off = np.zeros(n, np.int64)
    v_len = np.zeros(n, np.int64)
    rev = np.zeros(n, bool)
    for t, (ukey, ulo, uhi, vkey, vlo, vhi, rv) in enumerate(refs):
        u_off[t] = bases[ukey] + ulo
        u_len[t] = uhi - ulo
        v_off[t] = bases[vkey] + vlo
        v_len[t] = vhi - vlo
        rev[t] = rv
    return pool, u_off, u_len, v_off, v_len, rev, k
