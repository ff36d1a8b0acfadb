"""What the CLI, the bench and chip_smoke.py stand on: the compile-cache
placement rule, the decode of a golden index back to its FASTA input,
and the multi-device dry run's refusal to run short of devices."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from genometools_tpu.core.encseq import Encseq
from genometools_tpu.core.esq import (_Reader, write_all,
                                      write_fasta_from_index)

REPO = Path(__file__).resolve().parent.parent
AT1MB = REPO / "tests" / "golden_esa" / "at1MB" / "idx"

CACHE_PROBE = (
    "import jax\n"
    "from genometools_tpu.utils.compile_cache import enable_compile_cache\n"
    "print(enable_compile_cache())\n"
    "print(jax.config.jax_compilation_cache_dir)\n")


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache; otherwise the
    cache is <checkout>/.jax_cache, whatever the working directory."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    want = str(REPO / ".jax_cache")
    if env_set:
        want = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    r = subprocess.run([sys.executable, "-c", CACHE_PROBE], env=env,
                       cwd=tmp_path, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-800:]
    assert r.stdout.split() == [want, want]


def _source_fields(esq: bytes):
    """(filenames, numofallchars, maxsubalphasize) from an .esq header:
    the fields that describe the input file rather than the sequence."""
    r = _Reader(esq)
    r.take(1)
    _, _, _, _, nfiles, lenfn = r.u64(6).tolist()
    r.u64(14 + 3)
    r.take(int(r.u64()[0]))
    names = [f.decode() for f in r.take(lenfn).split(b"\0") if f]
    maxsub = r.take(1)[0]
    return names, int(r.u64()[0]), int(maxsub)


def test_at1mb_decode_reproduces_esq_and_md5(tmp_path):
    """Re-encoding the decoded at1MB FASTA gives gt's .md5 and, with the
    input file's own header fields restored, gt's .esq byte for byte."""
    fasta = tmp_path / "at1MB.fna"
    write_fasta_from_index(str(AT1MB), str(fasta))
    enc = Encseq.from_files([str(fasta)])
    gold = Path(str(AT1MB) + ".esq").read_bytes()
    names, nall, maxsub = _source_fields(gold)
    enc.origin.filenames = names
    enc.origin.numofallchars = nall
    enc.origin.maxsubalphasize = maxsub
    write_all(enc, str(tmp_path / "re"))
    assert (tmp_path / "re.md5").read_bytes() == \
        Path(str(AT1MB) + ".md5").read_bytes()
    assert (tmp_path / "re.esq").read_bytes() == gold
    assert enc.total_length == 772376 and enc.num_sequences == 1952
    assert np.count_nonzero(enc.codes == 254) + \
        np.count_nonzero(enc.codes == 255) == 18923


def test_dryrun_multichip_refuses_too_few_devices():
    import jax

    import __graft_entry__
    have = len(jax.devices())
    with pytest.raises(RuntimeError, match=f"needs {2 * have} devices"):
        __graft_entry__.dryrun_multichip(2 * have)
