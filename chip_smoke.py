#!/usr/bin/env python3
"""GPU smoke test: the suffixerator and the tools built on its index,
driven through the CLI entry point on the card, every output compared
exactly.

    python chip_smoke.py             # one card: phases 1-3
    python chip_smoke.py --cards 4   # the sharded suffix sort, four cards

One card:
  1. at1MB (772,376 symbols, decoded from tests/golden_esa/at1MB):
     `suffixerator -suf -lcp -tis`, .suf/.lcp/.llv byte-compared with
     the files the reference gt binary wrote.
  2. 32 Mbp seeded random DNA (4 sequences, seed 42): the same call,
     .suf/.lcp/.llv byte-compared with the host SA-IS + Kasai
     constructors; then `tallymer mkindex`, `repfind` and
     `seed_extend -extendgreedy` on that index must exit 0 with output.
  3. Device extension: `seed_extend` on at1MB with GT_TPU_DEVICE_EXTEND=1
     (batched greedy extension on the card) must print the same bytes as
     the host engine.
Four cards: `suffixerator -dist 4` byte-compared with `-dist 0`, then
`__graft_entry__.dryrun_multichip(4)`.

Every CLI call runs in this process (`genometools_tpu.cli.main`, through
bench.run_cli), so one process holds the card.  The script exits
non-zero, and prints no result line, when JAX finds no GPU or any phase
fails.  Its last line is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import filecmp
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
GOLDEN_AT1MB = REPO / "tests" / "golden_esa" / "at1MB"

# what the run requires of JAX (a rehearsal on the CPU overrides these)
PLATFORM = "cuda"
EXPECT_PLATFORM = "gpu"
BIG_SYMBOLS = 32 * 1024 * 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def same_bytes(a: Path, b: Path) -> bool:
    return filecmp.cmp(a, b, shallow=False)


def check(name: str, ok: bool) -> None:
    log(f"  {name}: {'identical' if ok else 'DIFFERENT'}")
    if not ok:
        raise AssertionError(f"{name} differs")


def card_line() -> str:
    """The cards' names and power limits, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def peak_bytes(devices) -> list:
    return [(d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in devices]


def suffixerator(db: Path, name: str, work: Path, dist: int) -> float:
    from bench import run_cli
    return run_cli(["suffixerator", "-db", str(db), "-indexname", name,
                    "-suf", "-lcp", "-tis", "-dist", str(dist)],
                   work, work / f"{name}.stdout")


def phase_at1mb(work: Path) -> None:
    from genometools_tpu.core.esq import write_fasta_from_index
    log("phase 1: at1MB suffixerator vs gt's own index files")
    fasta = work / "at1MB.fna"
    write_fasta_from_index(str(GOLDEN_AT1MB / "idx"), str(fasta))
    cold = suffixerator(fasta, "at1", work, 0)
    warm = suffixerator(fasta, "at1", work, 0)
    log(f"  suffixerator at1MB: cold {cold:.3f} s, warm {warm:.3f} s")
    with gzip.open(GOLDEN_AT1MB / "idx.suf.gz") as g:
        (work / "gold.suf").write_bytes(g.read())
    check(".suf vs gt", same_bytes(work / "at1.suf", work / "gold.suf"))
    for ext in (".lcp", ".llv"):
        check(f"{ext} vs gt", same_bytes(work / f"at1{ext}",
                                         GOLDEN_AT1MB / f"idx{ext}"))


def write_oracle(fasta: Path, name: Path) -> None:
    """Host SA-IS + Kasai index tables (independent of the device code)."""
    from genometools_tpu.core.encseq import Encseq
    from genometools_tpu.core.native import kasai_lcp_native, sais_native
    from genometools_tpu.index.esa import (EnhancedSuffixArray,
                                           recommended_prefixlength,
                                           write_esa)
    enc = Encseq.from_files([str(fasta)])
    keys = enc.suffix_keys()
    sa = sais_native(keys)
    if sa is None:
        raise RuntimeError("native SA-IS library unavailable")
    lcp = kasai_lcp_native(keys, sa)
    esa = EnhancedSuffixArray(
        encseq=enc, readmode=0, suftab=sa, lcptab=lcp,
        prefixlength=recommended_prefixlength(enc.alphabet.num_chars,
                                              enc.total_length))
    write_esa(esa, str(name), suf=True, lcp=True)


def big_fasta(work: Path) -> Path:
    from bench import write_random_fasta
    return Path(write_random_fasta(work / "big.fna", n=BIG_SYMBOLS))


def phase_big(work: Path) -> None:
    log(f"phase 2: {BIG_SYMBOLS} symbols, suffixerator vs host SA-IS + "
        f"Kasai, then the tools on its index")
    fasta = big_fasta(work)
    cold = suffixerator(fasta, "big", work, 0)
    warm = suffixerator(fasta, "big", work, 0)
    log(f"  suffixerator {BIG_SYMBOLS} symbols: cold {cold:.3f} s, "
        f"warm {warm:.3f} s")
    t0 = time.perf_counter()
    write_oracle(fasta, work / "oracle")
    log(f"  host SA-IS + Kasai oracle: {time.perf_counter() - t0:.3f} s")
    for ext in (".suf", ".lcp", ".llv"):
        check(f"{ext} vs SA-IS + Kasai",
              same_bytes(work / f"big{ext}", work / f"oracle{ext}"))
    tools = {
        "tallymer mkindex": ["tallymer", "mkindex", "-mersize", "19",
                             "-esa", "big"],
        "repfind": ["repfind", "-l", "14", "-ii", "big"],
        "seed_extend": ["seed_extend", "-ii", "big", "-l", "14",
                        "-minidentity", "90", "-extendgreedy"],
    }
    from bench import run_cli
    for name, argv in tools.items():
        out = work / f"{argv[0]}.out"
        dt = run_cli(argv, work, out)
        size = out.stat().st_size
        log(f"  {name}: exit 0, {size} bytes of output, {dt:.3f} s")
        if size == 0:
            raise AssertionError(f"{name} printed nothing")


def phase_device_extend(work: Path) -> None:
    from bench import run_cli
    log("phase 3: seed_extend on at1MB, device extension vs host engine")
    argv = ["seed_extend", "-ii", "at1", "-l", "14", "-minidentity", "90",
            "-extendgreedy"]
    dev = {"GT_TPU_DEVICE_EXTEND": "1"}
    cold = run_cli(argv, work, work / "ext_dev.out", dev)
    warm = run_cli(argv, work, work / "ext_dev.out", dev)
    host = run_cli(argv, work, work / "ext_host.out")
    lines = sum(1 for _ in open(work / "ext_host.out", "rb"))
    log(f"  seed_extend device extension: cold {cold:.3f} s, warm "
        f"{warm:.3f} s; host engine {host:.3f} s; {lines} lines")
    check("device-extension output vs host engine",
          same_bytes(work / "ext_dev.out", work / "ext_host.out"))


def phase_four_cards(work: Path, n: int) -> None:
    import jax

    import __graft_entry__
    log(f"phase 4: suffixerator -dist {n} vs -dist 0, "
        f"dryrun_multichip({n})")
    fasta = big_fasta(work)
    cold = suffixerator(fasta, "d4", work, n)
    warm = suffixerator(fasta, "d4", work, n)
    log(f"  suffixerator -dist {n}: cold {cold:.3f} s, warm {warm:.3f} s; "
        f"peak_bytes_in_use per card {peak_bytes(jax.devices())}")
    one = suffixerator(fasta, "d0", work, 0)
    log(f"  suffixerator -dist 0: cold {one:.3f} s")
    for ext in (".suf", ".lcp", ".llv"):
        check(f"{ext} -dist {n} vs -dist 0",
              same_bytes(work / f"d4{ext}", work / f"d0{ext}"))
    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(n)
    log(f"  dryrun_multichip({n}): ok, {time.perf_counter() - t0:.3f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="1: phases 1-3 on one card; 4: the sharded "
                         "suffix sort on four cards")
    args = ap.parse_args(argv)
    if not (REPO / "genometools_tpu" / "cli.py").is_file():
        print(f"chip_smoke: no genometools_tpu package beside {__file__}",
              file=sys.stderr)
        return 2
    os.environ["JAX_PLATFORMS"] = PLATFORM
    if args.cards == 1:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    sys.path.insert(0, str(REPO))
    import jax

    from genometools_tpu.utils.compile_cache import enable_compile_cache
    cache = enable_compile_cache()
    devices = jax.devices()
    d0 = devices[0]
    if d0.platform != EXPECT_PLATFORM or len(devices) != args.cards:
        print(f"chip_smoke: need {args.cards} {EXPECT_PLATFORM} device(s), "
              f"JAX has {len(devices)} {d0.platform}", file=sys.stderr)
        return 1
    log(card_line())
    log(f"jax {jax.__version__}: {len(devices)} x {d0.device_kind}, "
        f"compile cache {cache}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        if args.cards == 1:
            for phase in (phase_at1mb, phase_big, phase_device_extend):
                phase(work)
                log(f"  peak_bytes_in_use: {peak_bytes(devices)}")
        else:
            phase_four_cards(work, args.cards)
            for d, peak in zip(devices, peak_bytes(devices)):
                log(f"  {d}: peak_bytes_in_use {peak}")
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
