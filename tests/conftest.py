"""Test configuration: run the suite on a virtual 8-device CPU mesh so
sharding/collective code paths are exercised without accelerator
hardware.  Code that runs only on a GPU is marked `gpu`; such tests skip
here and `python chip_smoke.py` covers them on the card."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
# persistent compile cache keeps repeat runs fast
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(os.path.dirname(__file__), "..", ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

REFERENCE_TESTDATA = pathlib.Path("/root/reference/testdata")
GOLDEN_ESA = pathlib.Path(__file__).parent / "golden_esa"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs only on a GPU (skips on the CPU; "
                   "chip_smoke.py covers it on the card)")


@pytest.fixture(scope="session")
def testdata():
    if not REFERENCE_TESTDATA.is_dir():
        pytest.skip("reference testdata not available")
    return REFERENCE_TESTDATA


@pytest.fixture(scope="session")
def golden_fasta(tmp_path_factory):
    """FASTA input of a tests/golden_esa index, decoded from its
    .esq/.ssp/.des (wildcards come back as 'N')."""
    from genometools_tpu.core.esq import write_fasta_from_index
    made = {}

    def get(name: str) -> pathlib.Path:
        if name not in made:
            path = tmp_path_factory.mktemp("golden_fasta") / name
            write_fasta_from_index(str(GOLDEN_ESA / name / "idx"),
                                   str(path))
            made[name] = path
        return made[name]
    return get
