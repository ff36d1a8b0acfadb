"""tagerator + packedindex depth: golden parity with the compiled
reference `gt tagerator` (goldens in tests/golden_tagerator/, regenerate
with scripts/regen_golden_tagerator.sh) and device-batched FM rank.

The reference's own equivalence bar for the two index paths is
`-cmp` (online recomputation, set equality) — goldens are compared as
per-tag sorted row sets; emission order inside a tag follows our DFS.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
GDIR = REPO / "tests" / "golden_tagerator"
TAGS = GDIR / "tags.fna"


def _rows(text):
    per_tag, cur = {}, None
    for l in text.splitlines():
        if l.startswith("#\t"):
            cur = l.split("\t")[1]
            per_tag.setdefault(cur, [])
        elif not l.startswith("#") and l.strip():
            per_tag[cur].append(tuple(l.split()))
    return {k: sorted(v) for k, v in per_tag.items()}


def _run(args, cwd):
    r = subprocess.run([sys.executable, "-m", "genometools_tpu"] + args,
                       cwd=cwd, capture_output=True, text=True,
                       env={"PYTHONPATH": str(REPO),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-1500:]
    return r.stdout


@pytest.fixture(scope="module")
def atinsert(golden_fasta):
    return str(golden_fasta("Atinsert.fna"))


@pytest.fixture(scope="module")
def sfx(tmp_path_factory, atinsert):
    w = tmp_path_factory.mktemp("tag")
    _run(["suffixerator", "-db", atinsert, "-indexname", "sfx", "-dna",
          "-suf", "-tis", "-lcp", "-ssp", "--cpu"], w)
    return w


class TestTageratorGolden:
    @pytest.mark.parametrize("e", [0, 1, 2])
    def test_esa_match_sets(self, sfx, e):
        out = _run(["tagerator", "-e", str(e), "-q", str(TAGS),
                    "-esa", "sfx", "--cpu"], sfx)
        want = (GDIR / f"golden_e_{e}.txt").read_text()
        assert _rows(out) == _rows(want)

    def test_best_nod_nop_edist(self, sfx):
        cases = [
            (["-e", "2", "-best"], "golden_e_2_best.txt"),
            (["-e", "1", "-nop"], "golden_e_1_nop.txt"),
            (["-e", "1", "-nod"], "golden_e_1_nod.txt"),
            (["-e", "1", "-output", "tagnum", "tagseq", "dblength",
              "dbstartpos", "strand", "edist"],
             "golden_e_1_output_tagnum_tagseq_dblength_dbstartpos_"
             "strand_edist.txt"),
        ]
        for extra, golden in cases:
            out = _run(["tagerator"] + extra +
                       ["-q", str(TAGS), "-esa", "sfx", "--cpu"], sfx)
            assert _rows(out) == _rows((GDIR / golden).read_text()), golden

    def test_pck_path_matches_esa_golden(self, sfx, atinsert):
        _run(["packedindex", "mkindex", "-db", atinsert,
              "-indexname", "pck", "--cpu"], sfx)
        out = _run(["tagerator", "-e", "1", "-q", str(TAGS),
                    "-pck", "pck", "--cpu"], sfx)
        assert _rows(out) == _rows((GDIR / "golden_e_1.txt").read_text())


class TestFMIndexDepth:
    def test_from_codes_matches_esa_intervals(self):
        import jax
        jax.config.update("jax_platforms", "cpu")
        from genometools_tpu.core.encseq import Encseq
        from genometools_tpu.index.esa import build_esa
        from genometools_tpu.index.fmindex import fmindex_from_codes
        from genometools_tpu.match.querysearch import SuffixArraySearcher
        rng = np.random.default_rng(0)
        s = "".join(rng.choice(list("acgtn"), 800, p=[0.24] * 4 + [0.04]))
        e = Encseq.from_string(s[:300] + "|" + s[300:])
        fm = fmindex_from_codes(e.codes)
        esa = build_esa(e, 0, with_lcp=False)
        searcher = SuffixArraySearcher(esa)
        for _ in range(40):
            p = rng.integers(0, e.total_length - 8)
            pat = e.codes[p:p + 8]
            if (pat >= 4).any():
                continue
            lo, hi = searcher.interval(pat)
            assert fm.count(pat) == hi - lo
            got = fm.locate(pat, esa_sa=fm.sa_full)
            want = np.sort(esa.suftab[lo:hi])
            assert got.tolist() == want.tolist()

    def test_device_rank_and_batched_search(self):
        import jax
        jax.config.update("jax_platforms", "cpu")
        from genometools_tpu.core.encseq import Encseq
        from genometools_tpu.index.fmindex import (FMDeviceRank,
                                                   fmindex_from_codes)
        rng = np.random.default_rng(1)
        s = "".join(rng.choice(list("acgt"), 3000))
        e = Encseq.from_string(s)
        fm = fmindex_from_codes(e.codes)
        dev = FMDeviceRank(fm)
        # batched occ == host occ
        cs = rng.integers(0, 4, 200).astype(np.int32)
        ps = rng.integers(0, fm.bwt.size + 1, 200).astype(np.int32)
        import jax.numpy as jnp
        got = np.asarray(dev.occ_batch(jnp.asarray(cs), jnp.asarray(ps)))
        want = [fm.occ(int(c), int(p)) for c, p in zip(cs, ps)]
        assert got.tolist() == want
        # batched backward search == host backward search
        B, m = 64, 12
        pats = np.full((B, m), 255, np.uint8)
        for i in range(B):
            p = rng.integers(0, e.total_length - m)
            L = rng.integers(4, m + 1)
            pats[i, m - L:] = e.codes[p:p + L]
        lo, hi = dev.backward_search_batch(pats)
        for i in range(B):
            pat = pats[i][pats[i] != 255]
            wlo, whi = fm.backward_search(pat)
            assert (lo[i], hi[i]) == (wlo, whi), i
