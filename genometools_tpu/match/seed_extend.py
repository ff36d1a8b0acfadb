"""seed_extend: k-mer seeding + diagonal-band filtering + xdrop extension.

Capability equivalent of `gt seed_extend` / gt_diagbandseed_run
(ref: src/match/diagbandseed.c:5734) with the xdrop extension path
(ref: src/match/seed-extend.c:994 gt_extend_sesp).

Pipeline (semantics mirrored from the reference; see the per-function
references):
  1. k-mer lists (code, seqnum, endpos) per sequence set, both strands
     (ref: gt_diagbandseed_get_kmers, diagbandseed.c:1189)
  2. merge equal codes into seed pairs (aseq, bseq, bpos, apos), with
     per-code frequency cap maxfreq = MAX(alen, blen) and self-comparison
     rules aseq < bseq or (aseq == bseq and bpos >= apos+1)
     (ref: gt_diagbandseed_merge, diagbandseed.c:2654)
  3. sort seed pairs by (aseq, bseq, bpos, apos)
  4. per (aseq, bseq) segment: update diagonal-band coverage for every
     seed (band = (amaxlen + bpos - apos) >> logdiagbandwidth, score =
     non-overlapping covered B positions), then walk seeds in order and
     extend those whose coverage = score[band] + max(score[band±1]) >=
     mincoverage (ref: diagband-struct.c, segment2matches
     diagbandseed.c:4136)
  5. per surviving seed: skip if bpos <= previous match's b_end
     (use_apos=0 rule, ref: possibly_extend diagbandseed.c:3540), else
     xdrop-extend both directions and combine
     (ref: gt_extend_sesp + gt_combine_extensions, seed-extend.c)

The numbers-equal target is testdata/seedextend{1,3}.out.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..core.chardef import is_special
from ..core.encseq import Encseq
from ..ops.kmer import kmer_codes_np
from ..ops.greedy import PolishingInfo, greedy_extend, greedy_params_table
from ..ops.xdrop import XdropBest, XdropScores, optimal_xdrop_belowscore, \
    xdrop_extend


@dataclass
class SeedExtendParams:
    seedlength: int | None = None
    minidentity: int = 80
    sensitivity: int = 97
    parts: int = 1                     # part x part grid (-parts)
    pick: tuple[int, int] | None = None  # run one grid cell (-pick a,b)
    userdefinedleastlength: int = 20   # -l
    logdiagbandwidth: int = 6
    mincoverage: int | None = None     # default 2.5 * seedlength
    maxfreq: int | None = None
    use_apos: int = 0
    forward: bool = True
    reverse: bool = True               # P strand
    no_diagband_filter: bool = False
    scores: XdropScores = field(default_factory=XdropScores)
    extension: str = "xdrop"           # "xdrop" | "greedy"
    max_combine_mode: int = 2          # BOTH / ONLY_LEFT / ONLY_RIGHT
    history: int = 64
    perc_mat_history: int | None = None
    maxalignedlendifference: int | None = None
    spacedseedweight: int | None = None   # -spacedseed (span = seedlength)

    def spaced_mask(self, k: int) -> int | None:
        """The tuned per-(span, weight) mask (ref:
        src/match/dbs_spaced_seeds.c gt_spaced_seed_spec_tab) or None
        for contiguous seeds."""
        if self.spacedseedweight is None:
            return None
        from ..ops.spaced_seeds_tab import seed_for, weight_range
        w = self.spacedseedweight
        lo, hi = weight_range(k)
        if w == 0:                      # reference: weight = default
            w = max(lo, min(hi, k * 3 // 4))
        return seed_for(w, k)

    @property
    def errorpercentage(self) -> int:
        return 100 - self.minidentity

    def belowscore(self) -> int:
        return optimal_xdrop_belowscore(self.errorpercentage,
                                        self.sensitivity)

    def greedy_params(self):
        """(perc_mat_history, maxalignedlendifference) with table defaults
        (ref: gt_optimal_maxalilendiff_perc_mat_history,
        seed-extend.c:405)."""
        pmh, mad = greedy_params_table(self.sensitivity,
                                       self.errorpercentage)
        if self.maxalignedlendifference is not None:
            mad = self.maxalignedlendifference
        if self.perc_mat_history is not None:
            pmh = self.perc_mat_history
        return pmh, mad


def default_seedlength(aenc: Encseq, benc: Encseq, nchars: int = 4) -> int:
    """ref: gt_seed_extend.c:1032-1049."""
    import math
    avg = 0.5 * (aenc.total_length + benc.total_length)
    log_avg = int(round(math.log(max(avg, 2)) / math.log(nchars)))
    maxseqlength = max(aenc.max_seq_length(), benc.max_seq_length())
    return max(min(log_avg, maxseqlength, 32), 2)


def enumerate_kmers(encseq: Encseq, k: int, revcomp: bool = False,
                    spaced_mask: int | None = None):
    """(codes int64, seqnum int64, endpos int64) of all valid k-windows,
    endpos relative to its sequence start, in the strand's reading order.
    For revcomp=True each sequence is read reverse-complemented and endpos
    is in revcomp coordinates (ref: kmer iteration under
    GT_READMODE_REVCOMPL). spaced_mask selects a spaced seed over the
    span-k window (ref: diagbandseed spaced-seed k-mer extraction,
    src/match/dbs_spaced_seeds.c)."""
    from ..ops.kmer import spaced_kmer_codes_np
    if spaced_mask is None and k <= 31 and \
            encseq.alphabet.num_chars == 4:
        # native single-pass enumerator over the flat code array (the
        # P strand enumerates the cached per-sequence revcomp plane);
        # DNA 2-bit codes only — other alphabets take the numpy path
        from ..core.native import kmer_list_native
        n = encseq.num_sequences
        flat = _revcomp_codes(encseq) if revcomp else encseq.codes
        starts = np.asarray([encseq.seq_startpos(s) for s in range(n)],
                            np.int64)
        lens = np.asarray(encseq.seq_length(np.arange(n)), np.int64) \
            if n else np.zeros(0, np.int64)
        res = kmer_list_native(flat, starts, lens, k)
        if res is not None:
            return res
    codes_all, seqs_all, end_all = [], [], []
    comp = encseq.alphabet.complement_table()
    for s in range(encseq.num_sequences):
        lo = int(encseq.seq_startpos(s))
        hi = int(encseq.seq_endpos(s))
        seq = encseq.codes[lo:hi + 1]
        if revcomp:
            seq = np.where(is_special(seq[::-1]), seq[::-1], comp[seq[::-1]])
        if seq.size < k:
            continue
        if spaced_mask is not None:
            code, valid = spaced_kmer_codes_np(seq, spaced_mask)
        else:
            code, valid = kmer_codes_np(seq, k)
        pos = np.nonzero(valid)[0]
        codes_all.append(code[pos])
        seqs_all.append(np.full(pos.size, s, np.int64))
        end_all.append(pos + k - 1)
    if not codes_all:
        z = np.zeros(0, np.int64)
        return z, z, z
    return (np.concatenate(codes_all), np.concatenate(seqs_all),
            np.concatenate(end_all))


def build_seed_pairs(alist, blist, selfcomp: bool, maxfreq: int | None,
                     inseqseeds: bool = True, mindist: int = 1,
                     maxdist: int | None = None):
    """Vectorized merge-join on sorted codes; returns (aseq, bseq, bpos,
    apos) arrays sorted by (aseq, bseq, bpos, apos).

    mindist/maxdist: same-sequence pairs require
    apos + mindist <= bpos <= apos + maxdist (ref: seedpairdistance;
    default start is seedlength unless -overlapping-seeds,
    ref: gt_seed_extend.c:1199-1204)."""
    # threaded C++ radix join (native/gtnative.cpp gt_seed_pair_join):
    # identical output order, no comparison sorts / boolean temp planes
    from ..core.native import seed_pair_join_native
    native = seed_pair_join_native(alist, blist, selfcomp, maxfreq,
                                   inseqseeds, mindist, maxdist)
    if native is not None:
        return native
    acode, aseq, apos = alist
    bcode, bseq, bpos = blist
    same = blist is alist or (acode is bcode)
    sortkey = acode if acode.itemsize <= 4 else (
        acode.astype(np.int32) if int(acode.max(initial=0)) < 2 ** 31
        else acode)
    ao = np.argsort(sortkey, kind="stable")
    acode_s = acode[ao]
    if same:
        bo, bcode_s = ao, acode_s
    else:
        bkey = bcode if bcode.itemsize <= 4 else (
            bcode.astype(np.int32) if int(bcode.max(initial=0)) < 2 ** 31
            else bcode)
        bo = np.argsort(bkey, kind="stable")
        bcode_s = bcode[bo]

    # group boundaries per code (arrays are sorted — no np.unique resort)
    astart = np.flatnonzero(
        np.concatenate([[True], acode_s[1:] != acode_s[:-1]])) \
        if acode_s.size else np.zeros(0, np.int64)
    ua = acode_s[astart]
    acount = np.diff(np.append(astart, acode_s.size))
    if same:
        bstart, ub, bcount = astart, ua, acount
    else:
        bstart = np.flatnonzero(
            np.concatenate([[True], bcode_s[1:] != bcode_s[:-1]])) \
            if bcode_s.size else np.zeros(0, np.int64)
        ub = bcode_s[bstart]
        bcount = np.diff(np.append(bstart, bcode_s.size))
    # intersect the two sorted unique lists with one searchsorted
    if same:
        ia = ib = np.arange(ua.size)
    else:
        ii = np.searchsorted(ua, ub)
        iic = np.minimum(ii, max(ua.size - 1, 0))
        m = (ii < ua.size) & (ua[iic] == ub) if ua.size else \
            np.zeros(ub.size, bool)
        ia, ib = iic[m], np.flatnonzero(m)
    an, bn = acount[ia], bcount[ib]
    if maxfreq is not None:
        keep = np.maximum(an, bn) <= maxfreq
        ia, ib, an, bn = ia[keep], ib[keep], an[keep], bn[keep]
    if selfcomp and same:
        # a singleton code group only yields its identity pair, which
        # the strand/distance rule always drops — skip them up front
        # (the bulk of the groups on low-repetition inputs)
        g = an > 1
        ia, ib, an, bn = ia[g], ib[g], an[g], bn[g]
    # cartesian products per common code
    reps = an * bn
    total = int(reps.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    grp = np.repeat(np.arange(reps.size), reps)
    within = np.arange(total) - np.repeat(np.cumsum(reps) - reps, reps)
    ai = ao[astart[ia][grp] + within // bn[grp]]
    bi = bo[bstart[ib][grp] + within % bn[grp]]
    pa_seq, pa_pos = aseq[ai], apos[ai]
    pb_seq, pb_pos = bseq[bi], bpos[bi]
    if selfcomp:
        keep = (pa_seq < pb_seq)
        if inseqseeds:
            inrange = (pa_seq == pb_seq) & (pa_pos + mindist <= pb_pos)
            if maxdist is not None:
                inrange &= pb_pos <= pa_pos + maxdist
            keep |= inrange
        pa_seq, pa_pos = pa_seq[keep], pa_pos[keep]
        pb_seq, pb_pos = pb_seq[keep], pb_pos[keep]
    order = np.lexsort((pa_pos, pb_pos, pb_seq, pa_seq))
    return pa_seq[order], pb_seq[order], pb_pos[order], pa_pos[order]


@dataclass
class SeedExtendMatch:
    dblen: int
    dbseqnum: int
    dbstart: int
    direction: str
    querylen: int
    queryseqnum: int
    querystart: int
    score: int
    distance: int
    identity: float
    db_seedpos: int = 0
    query_seedpos: int = 0
    seedlen: int = 0
    mismatches: int = 0
    querystart_rc: int = 0  # on the P strand: start in revcomp coords

    def line(self) -> str:
        return (f"{self.dblen} {self.dbseqnum} {self.dbstart} "
                f"{self.direction} {self.querylen} {self.queryseqnum} "
                f"{self.querystart} {self.score} {self.distance} "
                f"{self.identity:.2f}")


def _score2distance(score: int, alignedlen: int) -> int:
    # ref: seed-extend.c:26 gt_querymatch_score2distance
    if score >= 0:
        return (alignedlen - score) // 3
    return -((alignedlen + score) // 3)


def _extend_one_seed(useq: np.ndarray, vseq: np.ndarray, same_seq: bool,
                     dbstart_rel: int, querystart_rel: int, seedlength: int,
                     belowscore: int, scores: XdropScores,
                     greedy_ctx: tuple | None = None):
    """gt_extend_sesp for one seed; useq/vseq are the full (transformed)
    sequences of the pair. Returns (u_left, v_left, left_score_or_dist,
    u_right, v_right, right_score_or_dist, mismatches) or None if the
    seed instances overlap. With greedy_ctx set, the per-side values are
    (ext_u, ext_v, distance) from the polished points instead of xdrop
    scores."""
    ulen_total, vlen_total = len(useq), len(vseq)
    if same_seq and dbstart_rel + seedlength - 1 >= querystart_rel:
        return None

    from ..core.native import greedy_batch_native, xdrop_batch_native

    def extend(u, v):
        if greedy_ctx is None:
            if scores == XdropScores():
                res = xdrop_batch_native([u], [v], belowscore)
                if res is not None:
                    return int(res[0, 0]), int(res[0, 1]), int(res[0, 2]), 0
            best = xdrop_extend(u, v, belowscore, scores)
            return best.ivalue, best.jvalue, best.score, 0
        pol_info, pmh, mad, history = greedy_ctx
        res = greedy_batch_native(
            [u], [v], max_history=history, perc_mat_history=pmh,
            maxalignedlendifference=mad, seedlengths=[seedlength],
            pol=pol_info)
        if res is not None:
            al, row, dist, mm, died, _t = res[0].tolist()
            return int(row), int(al - row), int(dist), int(mm)
        _, best = greedy_extend(
            u, v, max_history=history, perc_mat_history=pmh,
            maxalignedlendifference=mad, seedlength=seedlength,
            pol_info=pol_info)
        return (best.row, best.alignedlen - best.row, best.distance,
                best.max_mismatches)

    u_left = v_left = left_sd = left_mm = 0
    if dbstart_rel > 0 and querystart_rel > 0:
        r_voffset = dbstart_rel + seedlength if same_seq else 0
        ulen = dbstart_rel
        vlen = querystart_rel - r_voffset
        if ulen > 0 and vlen > 0:
            u = useq[0:dbstart_rel][::-1]
            v = vseq[r_voffset:querystart_rel][::-1]
            u_left, v_left, left_sd, left_mm = extend(u, v)
    r_urightbound = min(ulen_total, querystart_rel - v_left) if same_seq \
        else ulen_total
    u_right = v_right = right_sd = right_mm = 0
    if dbstart_rel + seedlength < r_urightbound and \
            querystart_rel + seedlength < vlen_total:
        u = useq[dbstart_rel + seedlength:r_urightbound]
        v = vseq[querystart_rel + seedlength:]
        u_right, v_right, right_sd, right_mm = extend(u, v)
    return (u_left, v_left, left_sd, u_right, v_right, right_sd,
            left_mm, right_mm)


def seed_extend(aenc: Encseq, benc: Encseq | None = None,
                params: SeedExtendParams | None = None,
                events: list | None = None,
                raw_sink: list | None = None) -> list[SeedExtendMatch]:
    """events, when a list is passed, receives ('match', m) and
    ('failed', seedlen, aseq, apos, dir, bseq, bpos) records in seed
    processing order (for -outfmt failed_seed).

    raw_sink, when a list is passed, receives the per-strand output
    blocks in emission order — ('recs', direction, k, int64[n,12]) from
    the fused native engine or ('objs', [SeedExtendMatch...]) — and the
    fused blocks are then NOT also returned as objects (bulk emitters
    write them without materialization)."""
    params = params or SeedExtendParams()
    selfcomp = benc is None
    benc = benc or aenc
    k = params.seedlength or default_seedlength(aenc, benc)
    mincov = params.mincoverage if params.mincoverage is not None \
        else int(2.5 * k)
    if not params.userdefinedleastlength:
        # default -l is the mincoverage (ref: gt_seed_extend.c:1139)
        params.userdefinedleastlength = mincov
    belowscore = params.belowscore()
    matches: list[SeedExtendMatch] = []

    smask = params.spaced_mask(k)
    alist = enumerate_kmers(aenc, k, revcomp=False, spaced_mask=smask)
    comp = benc.alphabet.complement_table()
    amaxlen = aenc.max_seq_length()
    bmaxlen = benc.max_seq_length()

    strands = []
    if params.forward:
        strands.append("F")
    if params.reverse:
        strands.append("P")
    if params.parts > 1 or params.pick:
        return _seed_extend_grid(aenc, benc, params, events, k, mincov,
                                 belowscore, selfcomp, strands, amaxlen,
                                 raw_sink)
    for direction in strands:
        # selfcomp forward strand: the b-list IS the a-list
        blist = alist if (selfcomp and direction == "F") else \
            enumerate_kmers(benc, k, revcomp=(direction == "P"),
                            spaced_mask=smask)
        # same-sequence distance rule: bpos >= apos + seedlength on the
        # forward strand, bpos >= apos on the reverse strand (counts
        # validated against the reference's at1MB -v logs: 305756 F /
        # 235705 P seeds at maxfreq 5)
        pa_seq, pb_seq, pb_pos, pa_pos = build_seed_pairs(
            alist, blist, selfcomp, params.maxfreq,
            inseqseeds=True, mindist=k if direction == "F" else 0)
        m = _process_seed_pairs(
            aenc, benc, direction, pa_seq, pb_seq, pb_pos, pa_pos, k,
            mincov, belowscore, params, selfcomp, amaxlen, events,
            raw_sink)
        if raw_sink is not None and m:
            raw_sink.append(("objs", m))
        matches.extend(m)
    return matches


def sequence_ranges(enc: Encseq, parts: int) -> list[tuple[int, int]]:
    """Split sequence numbers into <= parts contiguous ranges balanced
    by total length (ref: gt_sequence_parts_info_new,
    src/tools/gt_seed_extend.c:1251-1276). Returns [start, end]
    inclusive pairs."""
    n = enc.num_sequences
    parts = max(1, min(parts, n))
    lens = np.asarray(enc.seq_length(np.arange(n)), np.int64)
    cum = np.cumsum(lens)
    total = int(cum[-1])
    cuts = [0]
    for i in range(1, parts):
        b = int(np.searchsorted(cum, total * i / parts))
        if b >= n:
            b = n - 1
        if b + 1 > cuts[-1]:
            cuts.append(b + 1)
    cuts.append(n)
    return [(cuts[i], cuts[i + 1] - 1) for i in range(len(cuts) - 1)
            if cuts[i] < cuts[i + 1]]


def _filter_list(lst, lo: int, hi: int):
    code, seq, pos = lst
    m = (seq >= lo) & (seq <= hi)
    return code[m], seq[m], pos[m]


def _seed_extend_grid(aenc, benc, params, events, k, mincov, belowscore,
                      selfcomp, strands, amaxlen, raw_sink=None):
    """Part x part grid scheduling (ref: gt_seed_extend.c:1251,
    diagbandseed.c:6044-6050 loop): A-ranges x B-ranges, B starting at
    the A range for self-comparison; per cell the full two-strand
    pipeline runs on the range-restricted k-mer lists.  Band geometry
    stays part-invariant because the diagonal-band division uses the
    GLOBAL maximum sequence length (ref comment diagbandseed.c:4594-97),
    so the match set is independent of the part count (the reference's
    own invariance bar, sorted-output equality)."""
    aranges = sequence_ranges(aenc, params.parts)
    branges = aranges if selfcomp else sequence_ranges(benc, params.parts)
    if params.pick is not None:
        pa, pb = params.pick
        if not (1 <= pa <= len(aranges) and 1 <= pb <= len(branges)):
            raise ValueError(
                f"option -pick must not exceed {len(aranges)} "
                f"(number of parts)")
    matches: list[SeedExtendMatch] = []
    alist_full = enumerate_kmers(aenc, k, revcomp=False)
    blists = {d: enumerate_kmers(benc, k, revcomp=(d == "P"))
              for d in strands}
    for ai, (alo, ahi) in enumerate(aranges):
        bstart = ai if selfcomp else 0
        for bi in range(bstart, len(branges)):
            if params.pick is not None and \
                    (ai + 1, bi + 1) != tuple(params.pick):
                continue
            matches.extend(grid_cell_matches(
                aenc, benc, params, k, mincov, belowscore, selfcomp,
                strands, amaxlen, alist_full, blists, aranges[ai],
                branges[bi], ai == bi, events, raw_sink))
    return matches


def grid_cell_matches(aenc, benc, params, k, mincov, belowscore,
                      selfcomp, strands, amaxlen, alist_full, blists,
                      arange, brange, diagonal, events=None,
                      raw_sink=None):
    """One part x part grid cell's full two-strand pipeline
    (seed pairing -> diagband filter -> extension -> match records).
    Cells are mutually independent — the property the reference's
    thread fan-out exploits (ref: src/match/diagbandseed.c:5982) and
    the distributed dispatcher (parallel/dist_seed_grid.
    distributed_seed_extend) shards over the device mesh."""
    alo, ahi = arange
    blo, bhi = brange
    alist = _filter_list(alist_full, alo, ahi)
    diag_cell = selfcomp and diagonal
    out: list[SeedExtendMatch] = []
    for direction in strands:
        blist = _filter_list(blists[direction], blo, bhi)
        pa_seq, pb_seq, pb_pos, pa_pos = build_seed_pairs(
            alist, blist, diag_cell or (selfcomp and not diagonal),
            params.maxfreq, inseqseeds=diag_cell,
            mindist=k if direction == "F" else 0)
        m = _process_seed_pairs(
            aenc, benc, direction, pa_seq, pb_seq, pb_pos,
            pa_pos, k, mincov, belowscore, params,
            diag_cell, amaxlen, events, raw_sink)
        if raw_sink is not None and m:
            raw_sink.append(("objs", m))
        out.extend(m)
    return out


def _seq_codes(enc: Encseq, s: int, revcomp: bool) -> np.ndarray:
    lo = int(enc.seq_startpos(s))
    hi = int(enc.seq_endpos(s))
    seq = enc.codes[lo:hi + 1]
    if revcomp:
        comp = enc.alphabet.complement_table()
        seq = np.where(is_special(seq[::-1]), seq[::-1], comp[seq[::-1]])
    return seq


def _batch_greedy_extensions(cands, k, greedy_ctx, belowscore=None):
    """Speculative device-batched extension of every candidate seed
    (the reference extends seeds one by one and skips seeds inside
    previous match rectangles; the skip decision never needs the
    skipped seed's extension output, so extending all candidates in
    two device batches — left flanks, then right flanks bounded by the
    left results — preserves the exact sequential semantics).

    cands: list of (useq, vseq, same_seq, dbstart_rel, querystart_rel).
    greedy_ctx set -> greedy engine; greedy_ctx None -> xdrop with the
    given belowscore (unit scores), via ops.xdrop_batch's exact batch.
    Returns one entry per candidate: the `_extend_one_seed` tuple, or
    None for overlapping same-sequence seed instances.

    Flanks are materialized CLIPPED to a window (whole-chromosome
    sequences would otherwise copy megabases per task): a lane whose
    front provably never reached the clip edge is exact; the rest
    retry with an 8x window until unclipped (geometric, so total work
    stays O(final extension length)).  Edge contact comes from the C++
    engine's `touched` flag on the host, and from the alignedlen bound
    2*cap - mad - slack on the device (live fronts stay within
    maxalignedlendifference of the best, so a shorter best implies no
    cell reached the edge)."""
    from ..ops.greedy_batch import greedy_extend_batch
    from ..ops.xdrop_batch import xdrop_extend_batch_exact

    out = [None] * len(cands)
    if greedy_ctx is not None:
        pol, pmh, mad, history = greedy_ctx
    CAP0 = 2048

    def run_side(specs):
        """specs: (cand_idx, slicer, maxflank);
        slicer(cap) -> (u, v) clipped windows (cap=None -> full).
        Fills (u_ext, v_ext, score_or_dist, mm) per entry."""
        if not specs:
            return {}
        if greedy_ctx is None:
            built = [sp[1](None) for sp in specs]
            iv, jv, sv = xdrop_extend_batch_exact(
                [b[0] for b in built], [b[1] for b in built], belowscore)
            return {sp[0]: (int(iv[t]), int(jv[t]), int(sv[t]), 0)
                    for t, sp in enumerate(specs)}
        # the C++ batch is the engine unless the device engine is asked
        # for (or the native library is missing: greedy_batch_native
        # then returns None and the XLA batch runs)
        use_cpp = not os.environ.get("GT_TPU_DEVICE_EXTEND")
        side = {}
        pending = list(specs)
        cap = CAP0
        while pending:
            built = [sp[1](cap) for sp in pending]
            us = [b[0] for b in built]
            vs = [b[1] for b in built]
            resn = None
            if use_cpp:
                from ..core.native import greedy_batch_native
                resn = greedy_batch_native(
                    us, vs, max_history=history, perc_mat_history=pmh,
                    maxalignedlendifference=mad,
                    seedlengths=[k] * len(us), pol=pol)
            retry = []
            if resn is not None:
                for sp, r in zip(pending, resn):
                    ci, _, mx = sp[0], sp[1], sp[2]
                    if mx > cap and r[5]:
                        retry.append(sp)
                    else:
                        side[ci] = (int(r[1]), int(r[0] - r[1]),
                                    int(r[2]), int(r[3]))
            else:
                res = greedy_extend_batch(
                    us, vs, seedlengths=k, perc_mat_history=pmh,
                    maxalignedlendifference=mad, pol_info=pol,
                    history=history)
                # lanes the device hands back (slot overflow or chunk
                # budget) go to the C++ batch in one call
                fb = np.flatnonzero(res["fallback"])
                fbres = None
                if fb.size:
                    from ..core.native import greedy_batch_native
                    fbu = [us[int(t)] for t in fb]
                    fbv = [vs[int(t)] for t in fb]
                    fbres = greedy_batch_native(
                        fbu, fbv,
                        max_history=history, perc_mat_history=pmh,
                        maxalignedlendifference=mad,
                        seedlengths=[k] * fb.size, pol=pol)
                fbmap = {int(t): r for t, r in
                         zip(fb, fbres)} if fbres is not None else {}
                slack = mad + history + k
                for t, sp in enumerate(pending):
                    ci, mx = sp[0], sp[2]
                    if t in fbmap:
                        r = fbmap[t]
                        al = int(r[0])
                        if mx > cap and (al >= 2 * cap - slack
                                         or r[5]):
                            retry.append(sp)
                            continue
                        side[ci] = (int(r[1]), al - int(r[1]),
                                    int(r[2]), int(r[3]))
                        continue
                    al = int(res["alignedlen"][t])
                    if mx > cap and al >= 2 * cap - slack:
                        retry.append(sp)
                        continue
                    if res["fallback"][t]:
                        _, best = greedy_extend(
                            us[t], vs[t], max_history=history,
                            perc_mat_history=pmh,
                            maxalignedlendifference=mad, seedlength=k,
                            pol_info=pol)
                        side[ci] = (best.row,
                                    best.alignedlen - best.row,
                                    best.distance, best.max_mismatches)
                    else:
                        row = int(res["row"][t])
                        side[ci] = (row, al - row,
                                    int(res["distance"][t]),
                                    int(res["mismatches"][t]))
            pending = retry
            cap *= 8
        return side

    def left_slicer(useq, vseq, db, voff, qs):
        def make(cap):
            ulo = 0 if cap is None else max(0, db - cap)
            vlo = voff if cap is None else max(voff, qs - cap)
            return useq[ulo:db][::-1], vseq[vlo:qs][::-1]
        return make

    def right_slicer(useq, vseq, dbk, urb, qsk):
        def make(cap):
            uhi = urb if cap is None else min(urb, dbk + cap)
            vhi = len(vseq) if cap is None else min(len(vseq),
                                                    qsk + cap)
            return useq[dbk:uhi], vseq[qsk:vhi]
        return make

    left_tasks = []
    for ci, (useq, vseq, same_seq, db, qs) in enumerate(cands):
        if same_seq and db + k - 1 >= qs:
            continue                      # overlapping instances: None
        out[ci] = [0, 0, 0, 0, 0, 0, 0, 0]
        if db > 0 and qs > 0:
            voff = db + k if same_seq else 0
            if qs - voff > 0:
                left_tasks.append((ci, left_slicer(useq, vseq, db,
                                                   voff, qs),
                                   max(db, qs - voff)))
    for ci, (row, vext, dist, mmv) in run_side(left_tasks).items():
        out[ci][0], out[ci][1], out[ci][2], out[ci][6] = \
            row, vext, dist, mmv

    right_tasks = []
    for ci, (useq, vseq, same_seq, db, qs) in enumerate(cands):
        if out[ci] is None:
            continue
        v_left = out[ci][1]
        urb = min(len(useq), qs - v_left) if same_seq else len(useq)
        if db + k < urb and qs + k < len(vseq):
            right_tasks.append((ci, right_slicer(useq, vseq, db + k,
                                                 urb, qs + k),
                                max(urb - db - k,
                                    len(vseq) - qs - k)))
    for ci, (row, vext, dist, mmv) in run_side(right_tasks).items():
        out[ci][3], out[ci][4], out[ci][5], out[ci][7] = \
            row, vext, dist, mmv
    return [tuple(o) if o is not None else None for o in out]


def _device_extend_enabled() -> bool:
    """Whether the wave provider extends seeds in batches (wave-batched
    calls beat per-seed dispatch).  It does on an accelerator backend,
    and on the CPU backend when the C++ batch engine is built.  The
    batch engine is the C++ one unless GT_TPU_DEVICE_EXTEND=1 asks for
    the device batches (XLA greedy chunk recurrence).
    GT_TPU_DEVICE_EXTEND=1 forces on, GT_TPU_NO_DEVICE_EXTEND=1 off."""
    if os.environ.get("GT_TPU_NO_DEVICE_EXTEND"):
        return False
    if os.environ.get("GT_TPU_DEVICE_EXTEND"):
        return True
    import jax
    try:
        if jax.default_backend() not in ("cpu",):
            return True
        from ..core.native import get_lib
        return get_lib() is not None
    except Exception:
        return False


def _wave_size() -> int:
    """Tasks per extension wave: each wave is one batched extension
    call, and a larger wave extends more seeds that the sequential
    accept then skips.  GT_TPU_WAVE overrides."""
    env = os.environ.get("GT_TPU_WAVE")
    if env:
        return max(1, int(env))
    try:
        import jax
        return 32768 if jax.default_backend() != "cpu" else 512
    except Exception:
        return 512


class _WaveProvider:
    """Lazily extends candidate seeds in bounded device-batched waves.

    Waves are built in processing order starting at the first seed the
    accept loop actually needs.  Seeds predicted to be skipped by the
    live per-segment state (prev_b_end / rectangles) are left out of
    the wave; since prev_b_end can shrink, a prediction can be wrong —
    such a seed is simply requested later and starts a new wave, so the
    result stream is byte-identical to sequential extension."""

    def __init__(self, segments, order, states, k, greedy_ctx, use_apos,
                 belowscore=None):
        self.WAVE = _wave_size()
        self.segments = segments
        self.order = order
        self.states = states
        self.k = k
        self.ctx = greedy_ctx
        self.use_apos = use_apos
        self.belowscore = belowscore
        self.cache: dict = {}
        self.pos_of = {key: idx for idx, key in enumerate(order)}
        self.cursor = 0     # furthest scanned order position (requests
        #                     arrive monotonically; never rescan a run
        #                     of predicted skips — a mispredicted seed
        #                     simply heads its own wave)

    def get(self, si, i):
        key = (si, i)
        if key not in self.cache:
            self._build_wave(self.pos_of[key])
        return self.cache[key]

    def _build_wave(self, start):
        k = self.k
        wave_keys = []
        cands = []
        idx = start
        first = True
        while idx < len(self.order) and len(cands) < self.WAVE:
            key = self.order[idx]
            if first:
                idx = max(idx, self.cursor)   # resume, don't rescan
            idx += 1
            if key in self.cache:
                first = False
                continue
            si, i = key
            _, _, useq, vseq, same_seq, apos, bpos, _ = self.segments[si]
            bp, ap = int(bpos[i]), int(apos[i])
            db, qs = ap + 1 - k, bp + 1 - k
            if same_seq and db + k - 1 >= qs:
                self.cache[key] = None        # overlapping instances
                first = False
                continue
            if not first:
                st = self.states[si]
                if self.use_apos == 0 and st[0] and st[1] >= bp:
                    continue                  # predicted skip
                if self.use_apos > 0 and _seed_in_rectangles(
                        st[2], ap, bp, k):
                    continue                  # rectangles only grow
            first = False
            wave_keys.append(key)
            cands.append((useq, vseq, same_seq, db, qs))
        self.cursor = max(self.cursor, idx)
        if cands:
            exts = _batch_greedy_extensions(cands, k, self.ctx,
                                            self.belowscore)
            for key, ext in zip(wave_keys, exts):
                self.cache[key] = ext


def _revcomp_codes(enc: Encseq) -> np.ndarray:
    """Whole-encseq code array with every sequence span reverse-
    complemented in place (separator gaps untouched — flank windows clip
    at sequence bounds so they are never read).  Cached per encseq."""
    cached = enc.__dict__.get("_rc_codes")
    if cached is not None:
        return cached
    comp = enc.alphabet.complement_table()
    out = np.array(enc.codes, copy=True)
    for s in range(enc.num_sequences):
        lo = int(enc.seq_startpos(s))
        hi = int(enc.seq_endpos(s))
        seg = out[lo:hi + 1][::-1]
        out[lo:hi + 1] = np.where(is_special(seg), seg, comp[seg])
    enc.__dict__["_rc_codes"] = out
    return out


def _native_segment_recs(aenc, benc, direction, pa_seq, pb_seq, pb_pos,
                         pa_pos, k, mincov, params, selfcomp, amaxlen):
    """Fused native engine for the product greedy path: the whole
    diagband-filter + sequential skip/extend/accept walk in one native
    call over the flat code arrays (no per-seed marshalling).  Returns
    the raw int64[n, 12] record array, or None when the engine does not
    apply (the wave / per-seed paths take over)."""
    if params.use_apos != 0:
        return None
    engine = 0
    if params.extension == "xdrop":
        if params.scores != XdropScores():
            return None                 # general scores: host engine
        engine = 1
    elif params.extension != "greedy":
        return None
    if os.environ.get("GT_TPU_DEVICE_EXTEND"):
        return None                     # explicit device-path request
    from ..core.native import seedext_greedy_run_native
    pmh, mad = params.greedy_params()
    pol = PolishingInfo.new(float(params.errorpercentage), params.history)
    na, nb = aenc.num_sequences, benc.num_sequences
    a_start = np.asarray([aenc.seq_startpos(s) for s in range(na)],
                         np.int64)
    a_len = np.asarray(aenc.seq_length(np.arange(na)), np.int64)
    b_start = np.asarray([benc.seq_startpos(s) for s in range(nb)],
                         np.int64)
    b_len = np.asarray(benc.seq_length(np.arange(nb)), np.int64)
    bflat = benc.codes if direction == "F" else _revcomp_codes(benc)
    recs = seedext_greedy_run_native(
        aenc.codes, bflat, a_start, a_len, b_start, b_len,
        pa_seq, pb_seq, pb_pos, pa_pos, k=k, amaxlen=amaxlen,
        logw=params.logdiagbandwidth, mincov=mincov,
        use_filter=0 if params.no_diagband_filter else 1,
        selfcomp=selfcomp, is_p=direction == "P",
        max_combine=params.max_combine_mode, history=params.history,
        pmh=pmh, mad=mad, pol=pol, errperc=params.errorpercentage,
        leastlen2=2 * params.userdefinedleastlength, engine=engine,
        belowscore=params.belowscore())
    return recs


def _recs_to_matches(recs, direction, k):
    """Materialize SeedExtendMatch objects from fused-engine records."""
    matches = []
    for (dblen, aseq, astart, querylen, bseq, bsf, score, dist,
         db, qs, mm, braw) in recs.tolist():
        alignedlen = dblen + querylen
        err = 200.0 * dist / alignedlen
        matches.append(SeedExtendMatch(
            dblen, aseq, astart, direction, querylen, bseq, bsf,
            score, dist, 100.0 - err, db, qs, k, mm, braw))
    return matches


def _process_seed_pairs(aenc, benc, direction, pa_seq, pb_seq, pb_pos,
                        pa_pos, k, mincov, belowscore, params, selfcomp,
                        amaxlen, events=None, raw_sink=None):
    matches = []
    n = pa_seq.size
    if n == 0:
        return matches
    if events is None:
        recs = _native_segment_recs(aenc, benc, direction, pa_seq,
                                    pb_seq, pb_pos, pa_pos, k, mincov,
                                    params, selfcomp, amaxlen)
        if recs is not None:
            if raw_sink is not None:
                # bulk consumers (CLI line emission) take the raw
                # records; object materialization is skipped entirely
                raw_sink.append(("recs", direction, k, recs))
                return []
            return _recs_to_matches(recs, direction, k)
    # segment boundaries: contiguous (aseq,bseq) runs
    seg_break = np.zeros(n, bool)
    seg_break[0] = True
    seg_break[1:] = (pa_seq[1:] != pa_seq[:-1]) | (pb_seq[1:] != pb_seq[:-1])
    seg_starts = np.flatnonzero(seg_break)
    seg_ends = np.append(seg_starts[1:], n)

    logw = params.logdiagbandwidth
    greedy_ctx_global = None
    if params.extension == "greedy":
        pmh, mad = params.greedy_params()
        pol = PolishingInfo.new(float(params.errorpercentage),
                                params.history)
        greedy_ctx_global = (pol, pmh, mad, params.history)
    # ---- pass 1: diagband coverage filter, per segment ---------------
    segments = []
    seq_cache: dict = {}
    for s0, s1 in zip(seg_starts, seg_ends):
        aseq, bseq = int(pa_seq[s0]), int(pb_seq[s0])
        apos = pa_pos[s0:s1].astype(np.int64)
        bpos = pb_pos[s0:s1].astype(np.int64)
        if not params.no_diagband_filter:
            band = (amaxlen + bpos - apos) >> logw
            nb = int(band.max()) + 2
            # per-band non-overlapping coverage (ref: diagband-struct.c
            # gt_diagband_struct_single_update): walking seeds in bpos
            # order per band, each adds min(k, bpos - prev_bpos) new
            # covered B positions (k for the first; 0 for equal bpos).
            # Seeds arrive bpos-sorted, so a stable sort by band makes
            # each band a contiguous ascending-bpos run — the whole
            # update collapses to one vectorized segmented scan.
            bo = np.argsort(band, kind="stable")
            bs, bb = bpos[bo], band[bo]
            first = np.empty(bs.size, bool)
            first[0] = True
            first[1:] = bb[1:] != bb[:-1]
            contrib = np.empty(bs.size, np.int64)
            contrib[first] = k
            nf = ~first
            if nf.any():
                delta = np.empty(bs.size, np.int64)
                delta[1:] = bs[1:] - bs[:-1]
                contrib[nf] = np.minimum(k, delta[nf])
            score = np.zeros(nb + 4, np.int64)
            acc = np.bincount(bb + 1, weights=contrib)
            score[:acc.size] = acc.astype(np.int64)
            coverage = score[band + 1] + np.maximum(score[band],
                                                    score[band + 2])
            sel = coverage >= mincov
        else:
            sel = np.ones(apos.size, bool)
        ukey = ("a", aseq)
        if ukey not in seq_cache:
            seq_cache[ukey] = _seq_codes(aenc, aseq, False)
        vkey = ("b", bseq, direction)
        if vkey not in seq_cache:
            seq_cache[vkey] = _seq_codes(benc, bseq, direction == "P")
        segments.append((aseq, bseq, seq_cache[ukey], seq_cache[vkey],
                         selfcomp and aseq == bseq, apos, bpos, sel))

    # ---- pass 2: device wave provider (greedy extensions) ------------
    # The reference extends seeds strictly sequentially because the
    # skip tests (prev_b_end / match rectangles) depend on previous
    # extensions.  We batch bounded waves instead: predict the skips
    # with the live state, extend <= WAVE candidates in one device
    # batch, then run the exact sequential accept; a seed whose skip
    # was mispredicted simply starts the next wave, so outputs stay
    # byte-identical to the sequential engine.
    order = []
    for si, seg in enumerate(segments):
        for i in np.nonzero(seg[7])[0]:
            order.append((si, int(i)))
    states = {si: [False, -1, []] for si in range(len(segments))}
    provider = None
    if len(order) >= 8 and _device_extend_enabled():
        if greedy_ctx_global is not None and 30 <= params.history <= 64:
            provider = _WaveProvider(segments, order, states, k,
                                     greedy_ctx_global, params.use_apos)
        elif params.extension == "xdrop" and \
                params.scores == XdropScores():
            # xdrop with unit scores: device batch via the same wave
            # machinery (exact; unverifiable lanes fall back per lane
            # inside ops.xdrop_batch.xdrop_extend_batch_exact)
            provider = _WaveProvider(segments, order, states, k,
                                     None, params.use_apos,
                                     belowscore=belowscore)

    # ---- pass 3: sequential skip/accept (reference order) ------------
    for si, (aseq, bseq, useq, vseq, same_seq, apos, bpos, sel) \
            in enumerate(segments):
        greedy_ctx = greedy_ctx_global
        st = states[si]
        rectangles = st[2]            # (a_start, a_end, b_start, b_end)
        for i in np.nonzero(sel)[0]:
            haspreviousmatch, prev_b_end = st[0], st[1]
            bp, ap = int(bpos[i]), int(apos[i])
            if haspreviousmatch and params.use_apos == 0 and \
                    prev_b_end >= bp:
                continue
            if params.use_apos > 0 and _seed_in_rectangles(
                    rectangles, ap, bp, k):
                continue
            dbstart_rel = ap + 1 - k
            querystart_rel = bp + 1 - k
            if provider is not None:
                ext = provider.get(si, int(i))
            else:
                ext = _extend_one_seed(useq, vseq, same_seq, dbstart_rel,
                                       querystart_rel, k, belowscore,
                                       params.scores, greedy_ctx)
            if ext is None:
                if events is not None:
                    events.append(("failed", k, aseq, dbstart_rel,
                                   direction, bseq, querystart_rel))
                continue
            u_l, v_l, sd_l, u_r, v_r, sd_r, mm_l, mm_r = ext
            st[0] = True                  # haspreviousmatch
            accepted = None
            # combine modes BOTH / ONLY_LEFT / ONLY_RIGHT tried in order
            # (ref: gt_extend_sesp mode loop, max_combine_mode default 2)
            for mode in range(params.max_combine_mode + 1):
                ul, vl, sl, ml = (u_l, v_l, sd_l, mm_l) if mode != 2 \
                    else (0, 0, 0, 0)
                ur, vr, sr, mr = (u_r, v_r, sd_r, mm_r) if mode != 1 \
                    else (0, 0, 0, 0)
                dblen = k + ul + ur
                querylen = k + vl + vr
                alignedlen = dblen + querylen
                if params.extension == "greedy":
                    dist = sl + sr
                    total_score = alignedlen - 3 * dist
                else:
                    total_score = k * params.scores.mat + sl + sr
                    dist = _score2distance(total_score, alignedlen)
                a_start = dbstart_rel - ul
                b_start = querystart_rel - vl
                if mode == 0:
                    st[1] = b_start + querylen - 1   # prev_b_end
                    rect = (a_start, a_start + dblen - 1,
                            b_start, b_start + querylen - 1)
                # filters (ref: querymatch.c:722 check_final_generic)
                err = 200.0 * dist / alignedlen
                if err > params.errorpercentage:
                    continue
                if alignedlen < 2 * params.userdefinedleastlength:
                    continue
                # q. start is reported on the forward strand
                # (ref: querymatch.c:561 querystart_fwdstrand)
                b_start_fwd = b_start if direction == "F" \
                    else len(vseq) - b_start - querylen
                accepted = SeedExtendMatch(
                    dblen, aseq, a_start, direction, querylen, bseq,
                    b_start_fwd, total_score, dist, 100.0 - err,
                    dbstart_rel, querystart_rel, k, ml + mr, b_start)
                break
            if params.use_apos == 2 or \
                    (params.use_apos == 1 and accepted is not None):
                rectangles.append(rect)
            # selfmatch display order rule (ref: querymatch.c:357
            # gt_querymatch_ordered): a same-sequence match is shown
            # only in its canonical orientation — dbstart <=
            # querystart_fwdstrand on P, dbstart < querystart on F
            # (the mirror match is found separately); internal state
            # (prev_b_end, rectangles) still advances as above
            suppressed = False
            if accepted is not None and selfcomp and aseq == bseq:
                if direction == "P":
                    if not accepted.dbstart < accepted.querystart + 1:
                        accepted, suppressed = None, True
                elif not accepted.dbstart < accepted.querystart:
                    accepted, suppressed = None, True
            if accepted is not None:
                matches.append(accepted)
                if events is not None:
                    events.append(("match", accepted))
            elif events is not None and not suppressed:
                # seed extended but no accepted match
                # (ref: querymatch.c:696 gt_querymatch_show_failed_seed)
                events.append(("failed", k, aseq, dbstart_rel,
                               direction, bseq, querystart_rel))
    return matches


def _seed_in_rectangles(rectangles, apos, bpos, seedlen) -> bool:
    """Does the seed rectangle overlap any previous match rectangle?
    (ref: gt_diagbandseed_has_overlap_with_previous_match)"""
    sa0, sa1 = apos + 1 - seedlen, apos
    sb0, sb1 = bpos + 1 - seedlen, bpos
    for (a0, a1, b0, b1) in rectangles:
        if sa0 <= a1 and a0 <= sa1 and sb0 <= b1 and b0 <= sb1:
            return True
    return False


def maximal_exact_matches(aenc: Encseq, benc: Encseq | None,
                          seedlength: int, minlength: int,
                          forward: bool = True, reverse: bool = True):
    """-maxmat mode: merge colinear seeds on one diagonal into maximal
    exact matches >= minlength (ref: gt_diagbandseed_segment2maxmatches,
    diagbandseed.c:3953). Returns SeedExtendMatch records with
    distance 0 / identity 100."""
    selfcomp = benc is None
    benc = benc or aenc
    alist = enumerate_kmers(aenc, seedlength, revcomp=False)
    out = []
    strands = (["F"] if forward else []) + (["P"] if reverse else [])
    for direction in strands:
        blist = enumerate_kmers(benc, seedlength, revcomp=(direction == "P"))
        pa_seq, pb_seq, pb_pos, pa_pos = build_seed_pairs(
            alist, blist, selfcomp, None, inseqseeds=True,
            mindist=seedlength)
        # group by (aseq, bseq, diagonal); seeds on one diagonal with
        # contiguous endpos runs merge into one exact match
        # the reference enumerates diagonals as bpos - apos ascending
        # (ref: diagbandseed.c segment2maxmatches order)
        diag = pa_pos - pb_pos
        order = np.lexsort((pa_pos, -diag, pb_seq, pa_seq))
        pa_seq, pb_seq = pa_seq[order], pb_seq[order]
        pa_pos, pb_pos, diag = pa_pos[order], pb_pos[order], diag[order]
        n = pa_seq.size
        i = 0
        while i < n:
            j = i
            while j + 1 < n and pa_seq[j + 1] == pa_seq[i] and \
                    pb_seq[j + 1] == pb_seq[i] and \
                    diag[j + 1] == diag[i] and \
                    pa_pos[j + 1] <= pa_pos[j] + seedlength:
                j += 1
            length = int(pa_pos[j] - pa_pos[i]) + seedlength
            if length >= minlength:
                a_start = int(pa_pos[i]) + 1 - seedlength
                b_start = int(pb_pos[i]) + 1 - seedlength
                # verify + maximal-extend exact run boundaries
                useq = _seq_codes(aenc, int(pa_seq[i]), False)
                vseq = _seq_codes(benc, int(pb_seq[i]),
                                  direction == "P")
                while a_start > 0 and b_start > 0 and \
                        useq[a_start - 1] == vseq[b_start - 1] and \
                        useq[a_start - 1] < 4:
                    a_start -= 1
                    b_start -= 1
                    length += 1
                while a_start + length < len(useq) and \
                        b_start + length < len(vseq) and \
                        useq[a_start + length] == vseq[b_start + length] \
                        and useq[a_start + length] < 4:
                    length += 1
                out.append(SeedExtendMatch(
                    length, int(pa_seq[i]), a_start, direction, length,
                    int(pb_seq[i]), b_start, 2 * length, 0, 100.0))
            i = j + 1
    # dedup (several seed runs can extend to one MEM)
    seen = set()
    uniq = []
    for m in out:
        key = (m.dbseqnum, m.dbstart, m.queryseqnum, m.querystart,
               m.dblen, m.direction)
        if key not in seen:
            seen.add(key)
            uniq.append(m)
    return uniq
