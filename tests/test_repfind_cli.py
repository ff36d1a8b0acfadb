"""End-to-end CLI repfind tests: verbatim output diffs vs reference
goldens, mirroring the reference testsuite's checkrepfind
(ref: testsuite/gt_repfind_include.rb:37-66 — `diff -I '^#'` against
testdata/repfind-result/*)."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(args, cwd):
    r = subprocess.run([sys.executable, "-m", "genometools_tpu"] + args,
                       cwd=cwd, capture_output=True, text=True,
                       env={"PYTHONPATH": str(REPO),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def _nonhash(text):
    return [l for l in text.splitlines() if not l.startswith("#")]


@pytest.fixture(scope="module")
def rdir(testdata):
    return testdata / "repfind-result"


@pytest.fixture(scope="module")
def dup_index(tmp_path_factory, testdata):
    w = tmp_path_factory.mktemp("repfind_cli")
    _run(["suffixerator", "-db", str(testdata / "Duplicate.fna"),
          "-indexname", "sfxidx", "-dna", "-suf", "-tis", "-lcp", "-ssp",
          "--cpu"], w)
    return w


class TestRepfindCLIVerbatim:
    def test_forward_bytes(self, dup_index, rdir):
        out = _run(["repfind", "-l", "8", "-ii", "sfxidx", "--cpu"],
                   dup_index)
        want = (rdir / "Duplicate.fna.result").read_text()
        assert _nonhash(out) == _nonhash(want)

    def test_reverse_bytes(self, dup_index, rdir):
        out = _run(["repfind", "-l", "8", "-r", "-ii", "sfxidx", "--cpu"],
                   dup_index)
        want = (rdir / "Duplicate.fna-r.result").read_text()
        assert _nonhash(out) == _nonhash(want)

    def test_greedy_extend_bytes(self, dup_index, rdir):
        out = _run(["repfind", "-l", "8", "-ii", "sfxidx", "-extendgreedy",
                    "-minidentity", "90", "-maxalilendiff", "30",
                    "-percmathistory", "55", "--cpu"], dup_index)
        want = (rdir / "Duplicate.fna-greedy-8-8-90-30-55").read_text()
        assert _nonhash(out) == _nonhash(want)

    def test_atinsert_forward_bytes(self, tmp_path, testdata, rdir):
        _run(["suffixerator", "-db", str(testdata / "Atinsert.fna"),
              "-indexname", "sfx", "-dna", "-tis", "-suf", "-lcp", "-ssp",
              "--cpu"], tmp_path)
        out = _run(["repfind", "-l", "8", "-ii", "sfx", "--cpu"], tmp_path)
        want = (rdir / "Atinsert-8-8").read_text()
        # reference diffs with -w (whitespace-insensitive)
        got_rows = [l.split() for l in _nonhash(out)]
        want_rows = [l.split() for l in _nonhash(want) if l.strip()]
        assert got_rows == want_rows
