"""Bottom-up lcp-interval traversal vs gt goldens (ref:
src/match/esa-bottomup.c, esa-lcpintervals.c, esa_spmitvs_visitor.c;
goldens written by the compiled gt binary's `dev sfxmap -enum...`)."""

import io
import pathlib
import subprocess
import sys

import pytest

GOLD = pathlib.Path(__file__).parent / "golden_lcpitv"
REPO = pathlib.Path(__file__).resolve().parent.parent
ENV = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"}


@pytest.fixture(scope="module")
def dup_index(tmp_path_factory, golden_fasta):
    d = tmp_path_factory.mktemp("dup")
    r = subprocess.run(
        [sys.executable, "-m", "genometools_tpu", "suffixerator", "-db",
         str(golden_fasta("Duplicate.fna")), "-indexname", "dup", "-suf",
         "-lcp", "-tis", "--cpu"], cwd=d, env=ENV, capture_output=True)
    assert r.returncode == 0, r.stderr[-800:]
    return d / "dup"


@pytest.mark.parametrize("mode", ["enumlcpitvs", "enumlcpitvtree",
                                  "spmitv"])
def test_matches_gt_golden(dup_index, mode):
    r = subprocess.run(
        [sys.executable, "-m", "genometools_tpu", "dev", "sfxmap",
         "-esa", str(dup_index), f"-{mode}", "--cpu"],
        capture_output=True, text=True, env=ENV)
    assert r.returncode == 0, r.stderr[-800:]
    want = (GOLD / f"Duplicate.{mode}").read_text()
    assert r.stdout == want
