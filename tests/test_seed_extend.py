"""seed_extend + xdrop tests vs reference goldens and brute force."""

import gzip

import numpy as np
import pytest

from genometools_tpu.core.encseq import Encseq
from genometools_tpu.match.seed_extend import (SeedExtendParams,
                                               build_seed_pairs,
                                               default_seedlength,
                                               enumerate_kmers, seed_extend)
from genometools_tpu.ops.xdrop import (XdropScores, optimal_xdrop_belowscore,
                                       xdrop_extend, xdrop_extend_bruteforce)


class TestXdrop:
    def test_perfect_match(self):
        u = np.array([0, 1, 2, 3] * 5, np.uint8)
        best = xdrop_extend(u, u.copy(), 6)
        assert best.ivalue == 20 and best.jvalue == 20
        assert best.score == 40  # EVAL(i+j, 0) = 40

    def test_mismatch_stops(self):
        u = np.array([0, 0, 0, 0], np.uint8)
        v = np.array([0, 0, 3, 3], np.uint8)
        best = xdrop_extend(u, v, 3)
        assert best.ivalue == 2 and best.jvalue == 2
        assert best.score == 4

    def test_single_indel(self):
        # u = aaaa c gggg ; v = aaaa gggg -> expect full alignment w/ 1 del
        u = np.array([0] * 4 + [1] + [2] * 6, np.uint8)
        v = np.array([0] * 4 + [2] * 6, np.uint8)
        best = xdrop_extend(u, v, 6)
        assert best.ivalue == 11 and best.jvalue == 10
        # EVAL = (11+10) - 3*1 = 18
        assert best.score == 18

    def test_specials_never_match(self):
        u = np.array([0, 254, 0], np.uint8)
        v = np.array([0, 254, 0], np.uint8)
        best = xdrop_extend(u, v, 10)
        # wildcard never matches wildcard
        assert best.ivalue <= 3 and best.score <= 4

    @pytest.mark.parametrize("seed", range(10))
    def test_score_bounded_by_unpruned_dp(self, seed):
        rng = np.random.default_rng(seed)
        u = rng.integers(0, 4, 18).astype(np.uint8)
        v = rng.integers(0, 4, 18).astype(np.uint8)
        got = xdrop_extend(u, v, 30)
        ref = xdrop_extend_bruteforce(u, v, 30)
        # with a huge X-drop bound, no pruning: scores must agree
        assert got.score == ref

    def test_belowscore_table(self):
        assert optimal_xdrop_belowscore(20, 97) == 6
        assert optimal_xdrop_belowscore(1, 90) == 3


class TestSeedlist:
    def test_kmer_list_matches_golden(self, testdata):
        e = Encseq.from_files([str(testdata / "small_poly.fas")])
        al = enumerate_kmers(e, 10, revcomp=False)
        bl = enumerate_kmers(e, 10, revcomp=True)
        got = [f"# Kmer ({c:X},{p},{s})"
               for lst in (al, bl) for c, s, p in zip(*lst)]
        want = [l.strip() for l in gzip.open(
            str(testdata / "seedextend1.out.gz"), "rt") if "Kmer" in l]
        assert set(got) == set(want)

    def test_seedpair_list_matches_golden(self, testdata):
        e = Encseq.from_files([str(testdata / "small_poly.fas")])
        al = enumerate_kmers(e, 10, revcomp=False)
        want = [l.strip() for l in gzip.open(
            str(testdata / "seedextend1.out.gz"), "rt") if "SeedPair" in l]
        got = []
        for rc in (False, True):
            bl = enumerate_kmers(e, 10, revcomp=rc)
            aseq, bseq, bpos, apos = build_seed_pairs(
                al, bl, True, None, inseqseeds=True, mindist=10)
            got += [f"# SeedPair ({a},{b},{ap},{bp})"
                    for a, b, bp, ap in zip(aseq, bseq, bpos, apos)]
        assert got == want  # exact order: sorted by (aseq,bseq,bpos,apos)


class TestSeedExtendGolden:
    def test_small_poly_xdrop(self, testdata):
        """gt seed_extend -extendxdrop 97 -l 10 -ii small_poly golden."""
        e = Encseq.from_files([str(testdata / "small_poly.fas")])
        p = SeedExtendParams(sensitivity=97, minidentity=80,
                             userdefinedleastlength=10)
        got = [m.line() for m in seed_extend(e, None, p)]
        want = [l.strip() for l in
                open(str(testdata / "seedextend3.out")) if l.strip()]
        assert got == want

    def test_default_seedlength(self, testdata):
        e = Encseq.from_files([str(testdata / "small_poly.fas")])
        assert default_seedlength(e, e) == 3

    def test_duplicate_selfmatch(self, testdata):
        """Duplicate.fna: the two 840bp copies must align end to end."""
        e = Encseq.from_files([str(testdata / "Duplicate.fna")])
        p = SeedExtendParams(seedlength=14, userdefinedleastlength=100)
        ms = seed_extend(e, None, p)
        big = [m for m in ms if m.direction == "F" and m.dblen >= 800]
        assert len(big) >= 1
        m = big[0]
        assert m.dbseqnum == 0 and m.queryseqnum == 1
        assert m.identity > 99.0


class TestGreedy:
    def test_exact_edit_distance_without_trim(self):
        """With trimming disabled, greedy fronts compute plain edit
        distance when the alignment reaches the sequence ends."""
        from genometools_tpu.ops.greedy import (edit_distance_oracle,
                                                greedy_extend)
        rng = np.random.default_rng(1)
        for _ in range(10):
            u = rng.integers(0, 4, 20).astype(np.uint8)
            v = u.copy()
            # a few edits
            for _ in range(3):
                i = rng.integers(0, len(v))
                v[i] = rng.integers(0, 4)
            d, best = greedy_extend(u, v, trim=False,
                                    perc_mat_history=0,
                                    maxalignedlendifference=10**9)
            assert d == edit_distance_oracle(u, v)

    def test_seedextend3_greedy_golden(self, testdata):
        e = Encseq.from_files([str(testdata / "small_poly.fas")])
        p = SeedExtendParams(sensitivity=97, minidentity=80,
                             userdefinedleastlength=10, extension="greedy")
        got = [m.line() for m in seed_extend(e, None, p)]
        want = [l.strip() for l in
                open(str(testdata / "seedextend3.out")) if l.strip()]
        assert got == want

    def test_repfind_greedy_golden(self, testdata):
        from genometools_tpu.match.repfind import repfind_extend
        e = Encseq.from_files([str(testdata / "Duplicate.fna")])
        ms = repfind_extend(e, 8, "greedy", 90, 30, 55)
        got = sorted(m.line() for m in ms)
        want = sorted(
            l.strip() for l in open(str(
                testdata / "repfind-result" /
                "Duplicate.fna-greedy-8-8-90-30-55"))
            if l.strip() and not l.startswith("#"))
        assert got == want

    def test_polishing_table(self):
        from genometools_tpu.ops.greedy import PolishingInfo
        pol = PolishingInfo.new(20.0, 64)
        assert pol.cut_depth == 15
        assert pol.match_score == 400
        assert pol.difference_score == 600
        # all-match history is polished; all-mismatch is not
        assert pol.history_is_polished((1 << 30) - 1)
        assert not pol.history_is_polished(0)


class TestXdropBatch:
    @pytest.mark.parametrize("seed", range(4))
    def test_matches_scalar(self, seed):
        from genometools_tpu.ops.xdrop_batch import xdrop_extend_batch
        rng = np.random.default_rng(seed)
        us, vs, wants = [], [], []
        for _ in range(60):
            lu = int(rng.integers(1, 90))
            lv = int(rng.integers(1, 90))
            u = rng.integers(0, 5, lu).astype(np.uint8)
            u[u == 4] = 254  # sprinkle wildcards
            if rng.random() < 0.7 and lv <= lu:
                v = u[:lv].copy()
                idx = rng.random(lv) < 0.1
                v[idx] = rng.integers(0, 4, idx.sum())
            else:
                v = rng.integers(0, 4, lv).astype(np.uint8)
            us.append(u)
            vs.append(v)
            b = xdrop_extend(u, v, 6)
            wants.append((b.ivalue, b.jvalue, b.score))
        i, j, s = xdrop_extend_batch(us, vs, 6)
        got = list(zip(i.tolist(), j.tolist(), s.tolist()))
        assert got == wants

    def test_identical_and_disjoint(self):
        from genometools_tpu.ops.xdrop_batch import xdrop_extend_batch
        u = np.tile(np.array([0, 1, 2, 3], np.uint8), 20)
        w = np.full(80, 3, np.uint8)
        i, j, s = xdrop_extend_batch([u, u], [u.copy(), w], 6)
        assert (i[0], j[0]) == (80, 80)
        assert s[1] <= 4

    @pytest.mark.parametrize("seed", range(3))
    def test_exact_batch_with_long_windows(self, seed):
        """xdrop_extend_batch_exact must equal the scalar engine even
        when windows exceed the device clip (unsafe lanes fall back)."""
        from genometools_tpu.ops.xdrop_batch import \
            xdrop_extend_batch_exact
        rng = np.random.default_rng(100 + seed)
        us, vs, wants = [], [], []
        for t in range(24):
            # every third pair is a long near-identical window that
            # must extend far beyond the device clip
            if t % 3 == 0:
                lu = int(rng.integers(900, 1400))
                u = rng.integers(0, 4, lu).astype(np.uint8)
                v = u.copy()
                idx = rng.random(lu) < 0.02
                v[idx] = (v[idx] + 1 + rng.integers(0, 3, idx.sum())) % 4
            else:
                lu = int(rng.integers(1, 120))
                lv = int(rng.integers(1, 120))
                u = rng.integers(0, 4, lu).astype(np.uint8)
                if rng.random() < 0.6 and lv <= lu:
                    v = u[:lv].copy()
                    idx = rng.random(lv) < 0.1
                    v[idx] = rng.integers(0, 4, idx.sum())
                else:
                    v = rng.integers(0, 4, lv).astype(np.uint8)
            us.append(u)
            vs.append(v)
            b = xdrop_extend(u, v, 6)
            wants.append((b.ivalue, b.jvalue, b.score))
        i, j, s = xdrop_extend_batch_exact(us, vs, 6, max_w=256, D=48)
        got = list(zip(i.tolist(), j.tolist(), s.tolist()))
        assert got == wants


class TestAt1MBScale:
    def test_seedpair_list_matches_golden(self, testdata):
        """gt seed_extend -verify -debug-seedpair -memlimit 10MB -ii at1MB
        -only-seeds -no-reverse -seedlength 14 => maxfreq 3, 50496 seeds
        (testsuite gt_seed_extend_include.rb at1MB memlimit test)."""
        e = Encseq.from_files([str(testdata / "at1MB")])
        al = enumerate_kmers(e, 14, revcomp=False)
        aseq, bseq, bpos, apos = build_seed_pairs(
            al, al, True, 3, inseqseeds=True, mindist=14)
        got = [f"# SeedPair ({a},{b},{ap},{bp})"
               for a, b, bp, ap in zip(aseq, bseq, bpos, apos)]
        want = [l.strip() for l in gzip.open(
            str(testdata / "seedextend2.out.gz"), "rt")]
        assert got == want  # 50496 pairs, exact order

    def test_kmer_and_seed_counts(self, testdata):
        """-v log counts from the reference testsuite: 622939 10-mers;
        maxfreq 5 => 305756 forward-strand seeds."""
        e = Encseq.from_files([str(testdata / "at1MB")])
        al = enumerate_kmers(e, 10, revcomp=False)
        assert al[0].size == 622939
        aseq, bseq, bpos, apos = build_seed_pairs(
            al, al, True, 5, inseqseeds=True, mindist=10)
        assert aseq.size == 305756
        bl = enumerate_kmers(e, 10, revcomp=True)
        # reverse strand uses seedpairdistance.start = 0
        aseq2, *_ = build_seed_pairs(al, bl, True, 5, inseqseeds=True,
                                     mindist=0)
        assert aseq2.size == 235705


class TestAlignmentDisplay:
    """-outfmt alignment golden: BLAST-style blocks with seed marking
    (ref: testsuite/gt_seed_extend_include.rb:170,
    see-ext-at1MB-500-alignment-seed_in_algn.matches)."""

    def test_at1mb_alignment_golden(self, testdata):
        from genometools_tpu.match.seed_extend import _seq_codes
        from genometools_tpu.match.seedext_display import (
            format_alignment, seeded_alignment)
        from genometools_tpu.ops.greedy import PolishingInfo
        e = Encseq.from_files([str(testdata / "at1MB")])
        p = SeedExtendParams(sensitivity=97, minidentity=80,
                             userdefinedleastlength=700,
                             extension="greedy", history=60)
        ms = seed_extend(e, None, p)
        pol = PolishingInfo.new(float(p.errorpercentage), p.history)
        pmh, mad = p.greedy_params()
        out = []
        for m in ms:
            out.append(m.line())
            useq = _seq_codes(e, m.dbseqnum, False)
            vseq = _seq_codes(e, m.queryseqnum, False)
            ops, uo, ul, vo, vl, useedoff = seeded_alignment(
                useq, vseq, m.dbstart, m.dblen, m.querystart, m.querylen,
                m.db_seedpos, m.query_seedpos, m.seedlen, pol, pmh, mad)
            out.append(format_alignment(
                ops, useq[uo:uo + ul], vseq[vo:vo + vl], uo, vo,
                width=60, useedoffset=useedoff, seedlen=m.seedlen,
                seed_in_algn=True).rstrip("\n") + "\n")
        got = ("\n".join(out) + "\n").splitlines()
        want = [l for l in
                (testdata /
                 "see-ext-at1MB-500-alignment-seed_in_algn.matches"
                 ).read_text().splitlines() if not l.startswith("#")]
        assert got == want


class TestOutfmtColumns:
    """-outfmt cigar/cigarX/evalue/bitscore/seqlen/ids goldens at
    -l 400 (ref: see-ext-at1MB-400-*.matches)."""

    @pytest.fixture(scope="class")
    def at1mb_400(self, testdata):
        e = Encseq.from_files([str(testdata / "at1MB")])
        p = SeedExtendParams(sensitivity=97, minidentity=80,
                             userdefinedleastlength=400,
                             extension="greedy", history=60)
        return e, p, seed_extend(e, None, p)

    def _want(self, testdata, name):
        return [l for l in (testdata / name).read_text().splitlines()
                if not l.startswith("#")]

    def test_evalue_bitscore_seqlen(self, testdata, at1mb_400):
        from genometools_tpu.match.karlin_altschul import \
            KarlinAltschulStat
        from genometools_tpu.match.seedext_display import \
            match_extra_columns
        e, p, ms = at1mb_400
        ka = KarlinAltschulStat.new_gapped(e.total_length,
                                           e.num_sequences)
        got_ev = [m.line() + " " + " ".join(match_extra_columns(
            m, e, e, p, ["evalue", "bitscore"], ka)) for m in ms]
        assert got_ev == self._want(
            testdata, "see-ext-at1MB-400-evalue-bitscore.matches")
        got_sl = [m.line() + " " + " ".join(match_extra_columns(
            m, e, e, p, ["s.seqlen", "q.seqlen"])) for m in ms]
        assert got_sl == self._want(
            testdata, "see-ext-at1MB-400-seqlength.matches")
        got_id = []
        for m in ms:
            parts = m.line().split()
            sid, qid = match_extra_columns(m, e, e, p,
                                           ["subjectid", "queryid"])
            parts[1] = sid
            parts[5] = qid
            got_id.append(" ".join(parts))
        assert got_id == self._want(
            testdata, "see-ext-at1MB-400-seqdesc.matches")

    def test_cigar_prefix(self, testdata, at1mb_400):
        from genometools_tpu.match.seedext_display import \
            match_extra_columns
        e, p, ms = at1mb_400
        want = self._want(testdata, "see-ext-at1MB-400-cigar.matches")
        wantX = self._want(testdata, "see-ext-at1MB-400-cigarX.matches")
        for i, m in enumerate(ms[:40]):
            got = m.line() + " " + " ".join(
                match_extra_columns(m, e, e, p, ["cigar"]))
            assert got == want[i], i
            gotX = m.line() + " " + " ".join(
                match_extra_columns(m, e, e, p, ["cigarX"]))
            assert gotX == wantX[i], i


class TestFailedSeed:
    """-outfmt seed failed_seed goldens (ref: gt_seed_extend_include.rb
    lines 180-183)."""

    def _golden(self, testdata, name):
        return [l for l in (testdata / name).read_text().splitlines()
                if not l.startswith("#") or l.startswith("# failed_seed:")]

    def test_self_failed_seed(self, testdata):
        e = Encseq.from_files([str(testdata / "at1MB")])
        p = SeedExtendParams(sensitivity=97, minidentity=80,
                             userdefinedleastlength=600, seedlength=20,
                             extension="greedy", history=60)
        events = []
        seed_extend(e, None, p, events=events)
        got = []
        for ev in events:
            if ev[0] == "failed":
                _, k, aseq, apos, d, bseq, bpos = ev
                got.append(f"# failed_seed: {k} {aseq} {apos} {d} "
                           f"{bseq} {bpos}")
            else:
                m = ev[1]
                got.append(m.line() + f" {m.seedlen} {m.db_seedpos} "
                           f"{m.query_seedpos}")
        assert got == self._golden(
            testdata, "see-ext-at1MB-500-failed_seed.matches")

    def test_query_failed_seed_evalue(self, testdata):
        from genometools_tpu.match.karlin_altschul import \
            KarlinAltschulStat
        from genometools_tpu.match.seedext_display import \
            match_extra_columns
        at = Encseq.from_files([str(testdata / "at1MB")])
        u8 = Encseq.from_files([str(testdata / "U89959_genomic.fas")])
        p = SeedExtendParams(sensitivity=97, minidentity=80,
                             userdefinedleastlength=100, seedlength=20,
                             extension="greedy", history=60)
        events = []
        seed_extend(at, u8, p, events=events)
        ka = KarlinAltschulStat.new_gapped(at.total_length,
                                           at.num_sequences)
        got = []
        for ev in events:
            if ev[0] == "failed":
                _, k, aseq, apos, d, bseq, bpos = ev
                got.append(f"# failed_seed: {k} {aseq} {apos} {d} "
                           f"{bseq} {bpos}")
            else:
                m = ev[1]
                evalue = match_extra_columns(m, at, u8, p, ["evalue"],
                                             ka)[0]
                got.append(m.line() + f" {m.seedlen} {m.db_seedpos} "
                           f"{m.query_seedpos} {evalue}")
        assert got == self._golden(
            testdata, "see-ext-at1MB-u8-failed_seed-evalue.matches")


class TestCrossIndexContent:
    """at1MB vs U89959 cross-index: 1713 matches content-exact
    (see-ext-at1MB-u8.matches was generated with an unreferenced
    configuration whose output order differs; content compared as
    multisets)."""

    def test_u8_match_set(self, testdata):
        at = Encseq.from_files([str(testdata / "at1MB")])
        u8 = Encseq.from_files([str(testdata / "U89959_genomic.fas")])
        p = SeedExtendParams(sensitivity=97, minidentity=80,
                             userdefinedleastlength=22,
                             extension="greedy", history=60)
        got = sorted(m.line() for m in seed_extend(at, u8, p))
        want = sorted(
            l for l in (testdata /
                        "see-ext-at1MB-u8.matches").read_text().splitlines()
            if not l.startswith("#"))
        assert got == want


class TestMaxmatGoldens:
    """-maxmat fixed-width output (ref: see-ext-at1MB-maxmat250 and
    at1MB-u8-maxmat30 goldens; 1-based starts, diag-descending order
    within segments)."""

    def _render(self, mems):
        return [f"{m.dblen:8d}{m.dbseqnum:10d}{m.dbstart + 1:10d}  "
                f"{m.direction}{m.queryseqnum:10d}{m.querystart + 1:10d}"
                for m in mems]

    def test_self_maxmat250(self, testdata):
        from genometools_tpu.match.seed_extend import \
            maximal_exact_matches
        at = Encseq.from_files([str(testdata / "at1MB")])
        got = self._render(maximal_exact_matches(at, None, 32, 250))
        want = [l for l in (testdata /
                            "see-ext-at1MB-maxmat250.matches"
                            ).read_text().splitlines()
                if not l.startswith("#")]
        assert got == want

    def test_query_maxmat30(self, testdata):
        from genometools_tpu.match.seed_extend import \
            maximal_exact_matches
        at = Encseq.from_files([str(testdata / "at1MB")])
        u8 = Encseq.from_files([str(testdata / "U89959_genomic.fas")])
        got = self._render(maximal_exact_matches(at, u8, 30, 30))
        want = [l for l in (testdata /
                            "see-ext-at1MB-u8-maxmat30.matches"
                            ).read_text().splitlines()
                if not l.startswith("#")]
        assert got == want


class TestTraceOutfmt:
    """-outfmt trace=50 / dtrace=50 goldens."""

    def test_trace_goldens(self, testdata):
        from genometools_tpu.match.seed_extend import _seq_codes
        from genometools_tpu.match.seedext_display import (ops_to_trace,
                                                           seeded_alignment)
        from genometools_tpu.ops.greedy import PolishingInfo
        at = Encseq.from_files([str(testdata / "at1MB")])
        p = SeedExtendParams(sensitivity=97, minidentity=80,
                             userdefinedleastlength=400,
                             extension="greedy", history=60)
        ms = seed_extend(at, None, p)
        pol = PolishingInfo.new(float(p.errorpercentage), p.history)
        pmh, mad = p.greedy_params()

        def allops(m):
            useq = _seq_codes(at, m.dbseqnum, False)
            vseq = _seq_codes(at, m.queryseqnum, m.direction == "P")
            qs = m.querystart if m.direction == "F" else m.querystart_rc
            ops, *_ = seeded_alignment(
                useq, vseq, m.dbstart, m.dblen, qs, m.querylen,
                m.db_seedpos, m.query_seedpos, m.seedlen, pol, pmh, mad)
            return ops

        opslist = [allops(m) for m in ms]
        for dtrace, golden in [(False, "see-ext-at1MB-400-trace.matches"),
                               (True, "see-ext-at1MB-400-dtrace.matches")]:
            want = [l for l in
                    (testdata / golden).read_text().splitlines()
                    if not l.startswith("#")]
            got = [m.line() + " " + ops_to_trace(o, 50, dtrace)
                   for m, o in zip(ms, opslist)]
            assert got == want, golden


class TestTabsepCustom:
    """-mincoverage 200 -outfmt tabsep custom golden."""

    def test_tabsep(self, testdata):
        at = Encseq.from_files([str(testdata / "at1MB")])
        p = SeedExtendParams(sensitivity=97, minidentity=80,
                             userdefinedleastlength=200, mincoverage=200,
                             extension="greedy", history=60)
        ms = seed_extend(at, None, p)
        got = ["\t".join([str(m.dbseqnum), str(m.dbstart), str(m.dblen),
                          m.direction, str(m.queryseqnum),
                          str(m.querystart), str(m.querylen),
                          str(m.distance)]) for m in ms]
        want = [l for l in
                (testdata / "see-ext-at1MB-mincoverage200-tabsep.matches"
                 ).read_text().splitlines() if not l.startswith("#")]
        assert got == want


class TestBlastOutfmt:
    """-outfmt blast piped through matchtool
    (ref: gt_seed_extend_include.rb:94, matchtool_see-ext.match)."""

    def test_blast_matchtool_golden(self, testdata):
        from genometools_tpu.match.karlin_altschul import (
            KarlinAltschulStat, evalue_for_match)
        from genometools_tpu.match.matchtool import parse_blast_matches
        at = Encseq.from_files([str(testdata / "at1MB")])
        p = SeedExtendParams(sensitivity=97, minidentity=80,
                             userdefinedleastlength=350, mincoverage=350,
                             seedlength=12, logdiagbandwidth=3,
                             extension="greedy", history=60)
        ms = seed_extend(at, None, p)
        ka = KarlinAltschulStat.new_gapped(at.total_length,
                                           at.num_sequences)
        lines = []
        for m in ms:
            qid = at.descs[m.queryseqnum].split()[0]
            sid = at.descs[m.dbseqnum].split()[0]
            alignedlen = m.dblen + m.querylen
            mism = m.mismatches
            indels = m.distance - mism
            # blast 'alignment length' = (alignedlen - indels)/2
            # (ref: querymatch.c:257)
            alilen = (alignedlen - indels) // 2
            pident = 100.0 * (alilen - mism) / alilen
            ev, bs = evalue_for_match(
                ka, int(at.seq_length(m.queryseqnum)), alignedlen,
                m.distance, mism)
            qs, qe = m.querystart + 1, m.querystart + m.querylen
            if m.direction == "F":
                ss, se = m.dbstart + 1, m.dbstart + m.dblen
            else:
                ss, se = m.dbstart + m.dblen, m.dbstart + 1
            lines.append("\t".join(
                [qid, sid, f"{pident:.2f}", str(alilen), str(mism),
                 str(indels), str(qs), str(qe), str(ss), str(se),
                 f"{ev:1.0e}", f"{bs:.1f}"]))
        got = parse_blast_matches("\n".join(lines)).splitlines()
        want = [l.rstrip("\n") for l in
                (testdata / "matchtool_see-ext.match").read_text()
                .splitlines() if not l.startswith("#")]
        assert got == want


class TestPartsGrid:
    """Part x part grid scheduling (ref: gt_seed_extend.c:1251,
    diagbandseed.c:6044): the reference's own invariance bar is
    sorted-output equality across part counts (testsuite
    gt_seed_extend_include.rb:620 'gt seed_extend: parts')."""

    def _run(self, e, parts, pick=None, qenc=None):
        from genometools_tpu.match.seed_extend import (SeedExtendParams,
                                                       seed_extend)
        p = SeedExtendParams(userdefinedleastlength=10, minidentity=80,
                             sensitivity=97, extension="greedy",
                             parts=parts, pick=pick)
        return sorted(m.line() for m in seed_extend(e, qenc, p))

    def test_parts_invariance_selfcomp(self, testdata):
        e = Encseq.from_files([str(testdata / "small_poly.fas")])
        ref = self._run(e, 1)
        assert ref  # non-empty workload
        for parts in (2, 3):
            assert self._run(e, parts) == ref

    def test_parts_invariance_atinsert(self, testdata):
        e = Encseq.from_files([str(testdata / "Atinsert.fna")])
        ref = self._run(e, 1)
        for parts in (2, 4):
            assert self._run(e, parts) == ref

    def test_pick_cells_union(self, testdata):
        from genometools_tpu.match.seed_extend import sequence_ranges
        e = Encseq.from_files([str(testdata / "Atinsert.fna")])
        nr = len(sequence_ranges(e, 2))
        ref = self._run(e, 1)
        got = []
        for a in range(1, nr + 1):
            for b in range(a, nr + 1):
                got.extend(self._run(e, 2, pick=(a, b)))
        assert sorted(got) == ref


class TestSpacedSeeds:
    def test_tuned_table_consistency(self):
        from genometools_tpu.ops.spaced_seeds_tab import (
            FIRST_SPAN, SEED_TAB, seed_for, seed_span, seed_weight,
            weight_range)
        assert len(SEED_TAB) == 197
        for span in range(FIRST_SPAN, 33):
            lo, hi = weight_range(span)
            for w in range(lo, hi + 1):
                m = seed_for(w, span)
                assert seed_span(m) == span
                assert seed_weight(m) == w

    def test_spaced_seed_extend_runs_and_matches_planted(self):
        # a planted repeat with mismatches at the DON'T-CARE positions
        # of the tuned seed is still seeded
        import numpy as np
        from genometools_tpu.core.encseq import Encseq
        from genometools_tpu.match.seed_extend import (SeedExtendParams,
                                                       seed_extend)
        from genometools_tpu.ops.spaced_seeds_tab import seed_for
        rng = np.random.default_rng(8)
        core = "".join(rng.choice(list("acgt"), 120))
        mask = seed_for(12, 16)
        # mutate ONLY don't-care columns of one window copy
        mut = list(core)
        for b in range(16):
            if not (mask >> (15 - b)) & 1:
                j = 30 + b
                mut[j] = "acgt"[("acgt".index(mut[j]) + 1) % 4]
        s = core + "".join(rng.choice(list("acgt"), 60)) + "".join(mut)
        e = Encseq.from_string(s)
        p = SeedExtendParams(seedlength=16, spacedseedweight=12,
                             userdefinedleastlength=30, reverse=False,
                             extension="greedy")
        matches = seed_extend(e, None, p)
        assert matches, "spaced seed must still seed the mutated repeat"


class TestFusedEngineEquivalence:
    """The fused native engine must equal the wave/per-seed engine on
    arbitrary inputs, both extension modes (goldens pin known inputs;
    this pins random ones)."""

    def _random_enc(self, seed, nseq=3, n=2500):
        import numpy as np

        from genometools_tpu.core.encseq import Encseq
        rng = np.random.default_rng(seed)
        parts = []
        for s in range(nseq):
            base = "".join(rng.choice(list("acgt"), n))
            # plant shared repeats across sequences
            ins = base[100:400]
            parts.append(base[:1200] + ins + base[1200:])
        return Encseq.from_string("|".join(parts))

    def _lines(self, enc, extension, monkeypatch, device):
        import os

        from genometools_tpu.match.seed_extend import (SeedExtendParams,
                                                       seed_extend)
        if device:
            monkeypatch.setenv("GT_TPU_DEVICE_EXTEND", "1")
        else:
            monkeypatch.delenv("GT_TPU_DEVICE_EXTEND", raising=False)
        p = SeedExtendParams(seedlength=12, minidentity=85,
                             extension=extension,
                             userdefinedleastlength=20)
        return [m.line() for m in seed_extend(enc, None, p)]

    def test_greedy_equivalence(self, monkeypatch):
        enc = self._random_enc(21)
        fused = self._lines(enc, "greedy", monkeypatch, device=False)
        wave = self._lines(enc, "greedy", monkeypatch, device=True)
        assert fused == wave and fused

    def test_xdrop_equivalence(self, monkeypatch):
        enc = self._random_enc(22)
        fused = self._lines(enc, "xdrop", monkeypatch, device=False)
        wave = self._lines(enc, "xdrop", monkeypatch, device=True)
        assert fused == wave and fused


class TestWaveEngineChoice:
    """The wave provider (-outfmt failed_seed, use_apos) extends greedy
    flanks with the C++ batch; the XLA device batch runs only when
    GT_TPU_DEVICE_EXTEND asks for it (or the native library is
    missing), and both give the same matches."""

    @staticmethod
    def _lines(monkeypatch, device):
        import numpy as np

        import genometools_tpu.ops.greedy_batch as gb
        from genometools_tpu.core.encseq import Encseq
        from genometools_tpu.match.seed_extend import (SeedExtendParams,
                                                       seed_extend)
        calls = []
        orig = gb.greedy_extend_batch

        def spy(*a, **kw):
            calls.append(len(a[0]))
            return orig(*a, **kw)

        monkeypatch.setattr(gb, "greedy_extend_batch", spy)
        if device:
            monkeypatch.setenv("GT_TPU_DEVICE_EXTEND", "1")
        else:
            monkeypatch.delenv("GT_TPU_DEVICE_EXTEND", raising=False)
        rng = np.random.default_rng(31)
        base = "".join(rng.choice(list("acgt"), 2400))
        enc = Encseq.from_string(base + "|" + base[300:1500] + base[:600])
        p = SeedExtendParams(seedlength=12, minidentity=85,
                             extension="greedy", use_apos=1,
                             userdefinedleastlength=20)
        return [m.line() for m in seed_extend(enc, None, p)], calls

    @pytest.mark.parametrize("device", [False, True])
    def test_engine_follows_device_option(self, monkeypatch, device):
        from genometools_tpu.core.native import get_lib
        lines, calls = self._lines(monkeypatch, device)
        assert lines
        assert bool(calls) == (device or get_lib() is None)
        other, _ = self._lines(monkeypatch, not device)
        assert lines == other
