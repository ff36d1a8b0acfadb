#!/usr/bin/env python
"""Benchmark: genometools_tpu headline metrics on the GPU.

Prints ONE JSON line:
  {"metric": "esa_suffixes_per_sec", "value": N, "unit": "suffixes/s",
   "n_suffixes": n, "extra_metrics": [...], "device": {...}}

    python bench.py [suffix] [extension] [workloads]   # default: all

Parts, all measured live on the first GPU:
  * suffix: esa_suffixes_per_sec — device prefix-doubling suffix sort
    (index/suffix._sa_pipeline) of the seeded 32 Mbp random-DNA input;
    extra: the same at at1MB (decoded from tests/golden_esa/at1MB).
  * extension, on the greedy flank-extension tasks of
    `seed_extend -extendgreedy` on at1MB self-comparison (both strands,
    diagband filter, no seed skipped; GT_BENCH_MAX_TASKS caps them):
      - seed_extend_extensions_per_sec — the XLA device batch
        (ops/greedy_batch.greedy_extend_batch); vs_baseline = its rate
        over the C++ host batch (native/gtnative.cpp greedy_batch) on
        the same tasks, every non-fallback lane checked equal;
      - xdrop_extensions_per_sec — the product xdrop batch (C++) on up
        to 65,536 of those tasks; device_value is the lax device batch
        (ops/xdrop_batch._run_device), every safe lane checked equal;
      - seed_extend_device_extension_at1MB_s — `seed_extend` on at1MB
        with GT_TPU_DEVICE_EXTEND=1 (wave size from GT_TPU_WAVE when
        set), output checked equal to the host engine's.
  * workloads: suffixerator_e2e_s — FASTA -> tables on disk for the
    32 Mbp input through index/fastpipe.suffixerator_e2e (a bench-only
    path; users run index/esa.build_esa through the CLI);
    <tool>_e2e_s — wall time of in-process CLI runs (tallymer, repfind,
    readjoiner, seed_extend) on the 32 Mbp index.  With GT_REFERENCE_BIN
    naming a compiled gt binary, each also carries gt's time and the
    ratio gt/ours.

Any disagreement between engines raises.  Exits non-zero, printing no result line, when JAX finds no GPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).parent
AT1MB_INDEX = HERE / "tests" / "golden_esa" / "at1MB" / "idx"
WORKLOAD = HERE / ".bench_ext_workload.npz"
BIG = HERE / ".bench_big.fna"          # 32Mbp synthetic (saturating size)
IDXDIR = HERE / ".bench_work"
GT_BIN = os.environ.get("GT_REFERENCE_BIN")
DESC = ("u_off", "u_len", "v_off", "v_len", "rev")


def write_random_fasta(path, n: int = 32 * 1024 * 1024, nseq: int = 4,
                       seed: int = 42) -> str:
    """Seeded random-DNA FASTA: n symbols in nseq equal records, 70
    symbols per line."""
    rng = np.random.default_rng(seed)
    b = np.frombuffer(b"acgt", np.uint8)[
        rng.integers(0, 4, n, dtype=np.uint8)]
    per = n // nseq
    with open(path, "wb") as f:
        for s in range(nseq):
            f.write(b">synthetic_%d\n" % s)
            chunk = b[s * per:(s + 1) * per]
            m = per - per % 70
            body = chunk[:m].reshape(-1, 70)
            out = np.empty((body.shape[0], 71), np.uint8)
            out[:, :70] = body
            out[:, 70] = 10
            f.write(out.tobytes())
            tail = chunk[m:]
            if tail.size:
                f.write(tail.tobytes() + b"\n")
    return str(path)


def _ensure_big() -> str:
    """Deterministic 32Mbp random-DNA FASTA (4 sequences, seed 42)."""
    if BIG.exists() and BIG.stat().st_size > 30_000_000:
        return str(BIG)
    return write_random_fasta(BIG)


def _ensure_at1mb() -> str:
    """at1MB as FASTA, decoded from the reference binary's index."""
    from genometools_tpu.core.esq import write_fasta_from_index
    IDXDIR.mkdir(exist_ok=True)
    path = IDXDIR / "at1MB.fna"
    if not path.exists():
        write_fasta_from_index(str(AT1MB_INDEX), str(path))
    return str(path)


def _log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------- suffix

def _build_rate(keys_padded: np.ndarray, n1: int, device,
                reps: int = 3) -> float:
    """suffixes/s for the SA build of keys (padded to pow2) on device
    (the packed-bootstrap engine, index/suffix._sa_pipeline)."""
    import jax

    from genometools_tpu.index.suffix import _sa_pipeline

    sigma = int(keys_padded[n1 - 1]) - (n1 - 1)
    with jax.default_device(device):
        k = jax.device_put(jax.numpy.asarray(keys_padded), device)
        sa, _ = _sa_pipeline(k, n1, sigma, False)     # warmup / compile
        sa.block_until_ready()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            sa, _ = _sa_pipeline(k, n1, sigma, False)
            sa.block_until_ready()
            times.append(time.perf_counter() - t0)
    return n1 / min(times)


def _padded_keys(encseq):
    from genometools_tpu.index.suffix import _pad_size

    keys = encseq.suffix_keys()
    n1 = keys.size
    npad = _pad_size(n1)
    maxkey = int(keys.max())
    pad = maxkey + 1 + np.arange(npad - n1, dtype=np.int32)
    return np.concatenate([keys, pad]).astype(np.int32), n1


def bench_suffix(dev, enc_big, enc_small, out: dict) -> None:
    """Primary: 32Mbp synthetic (saturating size). Secondary: at1MB."""
    for name, enc in (("suffix", enc_big), ("suffix_at1MB", enc_small)):
        keys_p, n1 = _padded_keys(enc)
        rate = _build_rate(keys_p, n1, dev)
        _log(f"{name}: n1={n1} rate={rate:,.0f} suffixes/s")
        out[name] = {"rate": rate, "n": n1}


# ------------------------------------------------------------- extension

def _ext_workload(encseq):
    """(us, vs, k) for the at1MB greedy workload; the task pool is
    cached on disk (deterministic, ~30s to collect)."""
    cap = int(os.environ.get("GT_BENCH_MAX_TASKS", "0")) or None
    if WORKLOAD.exists():
        z = np.load(WORKLOAD)
        pool, k = z["pool"], int(z["k"])
        desc = [z[key][:cap] for key in DESC]
    else:
        from genometools_tpu.match.ext_workload import \
            collect_extension_pool
        from genometools_tpu.match.seed_extend import SeedExtendParams
        pool, *desc, k = collect_extension_pool(
            encseq, SeedExtendParams(extension="greedy"), max_tasks=cap)
        if cap is None:
            np.savez_compressed(WORKLOAD, pool=pool, k=np.int32(k),
                                **dict(zip(DESC, desc)))
    u_off, u_len, v_off, v_len, rev = desc
    us, vs = [], []
    for i in range(u_off.size):
        u = pool[u_off[i]:u_off[i] + u_len[i]]
        v = pool[v_off[i]:v_off[i] + v_len[i]]
        if rev[i]:
            u, v = u[::-1], v[::-1]
        us.append(u)
        vs.append(v)
    return us, vs, k


def _timed(fn):
    t0 = time.perf_counter()
    res = fn()
    return res, time.perf_counter() - t0


def _greedy_engines(us, vs, k, out: dict) -> None:
    """XLA device batch (ops/greedy_batch.greedy_extend_batch) against the
    C++ host batch on the same tasks; every lane the device does not hand
    back as fallback must agree with C++ exactly."""
    from genometools_tpu.core.native import greedy_batch_native
    from genometools_tpu.match.seed_extend import SeedExtendParams
    from genometools_tpu.ops.greedy import PolishingInfo
    from genometools_tpu.ops.greedy_batch import greedy_extend_batch

    params = SeedExtendParams(extension="greedy")
    pmh, mad = params.greedy_params()
    pol = PolishingInfo.new(float(params.errorpercentage), params.history)
    n = len(us)

    def dev():
        return greedy_extend_batch(
            us, vs, seedlengths=k, perc_mat_history=pmh,
            maxalignedlendifference=mad, pol_info=pol,
            history=params.history)

    _, cold = _timed(dev)
    res, warm = _timed(dev)
    cxx, tc = _timed(lambda: greedy_batch_native(
        us, vs, max_history=params.history, perc_mat_history=pmh,
        maxalignedlendifference=mad, seedlengths=np.full(n, k, np.int64),
        pol=pol))
    ok = ~res["fallback"]
    agree = all(np.array_equal(res[key][ok], cxx[ok, col])
                for key, col in (("alignedlen", 0), ("row", 1),
                                 ("distance", 2), ("mismatches", 3)))
    _log(f"greedy: {n} tasks; XLA device batch cold {cold:.3f} s, warm "
         f"{warm:.3f} s = {n / warm:,.0f} ext/s ({int((~ok).sum())} "
         f"fallback lanes); C++ batch {tc:.3f} s = {n / tc:,.0f} ext/s; "
         f"other lanes {'agree' if agree else 'DISAGREE'}")
    if not agree:
        raise AssertionError("XLA greedy batch disagrees with C++")
    out["extension"] = {"rate": n / warm, "vs": tc / warm, "tasks": n}


def _xdrop_engines(us, vs, out: dict, belowscore: int = 7, W: int = 512,
                   D: int = 64, lanes: int = 2048) -> None:
    """lax device batch (ops/xdrop_batch._run_device, `lanes` per call)
    against the C++ batch, which is also the product batch
    (xdrop_extend_batch_exact); every lane the device does not mark
    unsafe must agree with C++ exactly."""
    from genometools_tpu.core.native import xdrop_batch_native
    from genometools_tpu.ops.xdrop_batch import _run_device
    n = len(us)

    def dev():
        parts = [_run_device(us[s:s + lanes], vs[s:s + lanes], belowscore,
                             W, D) for s in range(0, n, lanes)]
        return [np.concatenate(p) for p in zip(*parts)]

    _, cold = _timed(dev)
    (iv, jv, sv, unsafe), warm = _timed(dev)
    cxx, tc = _timed(lambda: xdrop_batch_native(us, vs, belowscore))
    ok = ~unsafe
    agree = (np.array_equal(iv[ok], cxx[ok, 0])
             and np.array_equal(jv[ok], cxx[ok, 1])
             and np.array_equal(sv[ok], cxx[ok, 2]))
    _log(f"xdrop: {n} tasks (W={W}, D={D}, {lanes} lanes per call); lax "
         f"device batch cold {cold:.3f} s, warm {warm:.3f} s = "
         f"{n / warm:,.0f} ext/s ({int(unsafe.sum())} unsafe lanes); C++ "
         f"batch {tc:.3f} s = {n / tc:,.0f} ext/s; other lanes "
         f"{'agree' if agree else 'DISAGREE'}")
    if not agree:
        raise AssertionError("lax xdrop batch disagrees with C++")
    out["xdrop"] = {"rate": n / tc, "device_rate": n / warm, "tasks": n}


def _device_extension_run(at1: str, out: dict) -> None:
    """`seed_extend -extendgreedy` on at1MB with GT_TPU_DEVICE_EXTEND=1
    (wave size from GT_TPU_WAVE when set), cold and warm, against the
    host engine's bytes."""
    if not (IDXDIR / "at1.suf").exists():
        run_cli(["suffixerator", "-db", at1, "-indexname", "at1", "-suf",
                 "-lcp", "-tis", "-ssp", "-des", "-sds", "-dist", "0"],
                IDXDIR, os.devnull)
    argv = ["seed_extend", "-ii", "at1", "-l", "14", "-minidentity", "90",
            "-extendgreedy"]
    host = run_cli(argv, IDXDIR, IDXDIR / "ext_host.out")
    dev = {"GT_TPU_DEVICE_EXTEND": "1"}
    cold = run_cli(argv, IDXDIR, IDXDIR / "ext_dev.out", dev)
    warm = run_cli(argv, IDXDIR, IDXDIR / "ext_dev.out", dev)
    same = (IDXDIR / "ext_host.out").read_bytes() == \
        (IDXDIR / "ext_dev.out").read_bytes()
    wave = os.environ.get("GT_TPU_WAVE", "default")
    _log(f"seed_extend at1MB: host engine {host:.3f} s; device extension "
         f"(wave {wave}) cold {cold:.3f} s, warm {warm:.3f} s, output "
         f"{'identical' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("device-extension output differs")
    out["device_extension"] = {"host_s": host, "cold_s": cold,
                               "warm_s": warm}


def bench_extension(encseq, at1: str, out: dict) -> None:
    us, vs, k = _ext_workload(encseq)
    _greedy_engines(us, vs, k, out)
    m = min(len(us), 65536)
    idx = np.linspace(0, len(us) - 1, m).astype(np.int64)
    _xdrop_engines([us[i] for i in idx], [vs[i] for i in idx], out)
    _device_extension_run(at1, out)


# -------------------------------------------------------- end to end

def run_cli(argv: list, cwd, out, env: dict | None = None) -> float:
    """One in-process CLI call with stdout (fd 1 included) sent to `out`,
    under the extra environment `env`; returns its wall time.  A
    non-zero exit raises."""
    from genometools_tpu.cli import main as gt_main
    saved_env = dict(os.environ)
    os.environ.update(env or {})
    here = os.getcwd()
    os.chdir(cwd)
    sys.stdout.flush()
    saved_fd = os.dup(1)
    try:
        with open(out, "wb") as f:
            os.dup2(f.fileno(), 1)
            t0 = time.perf_counter()
            rc = gt_main(argv)
            sys.stdout.flush()
            dt = time.perf_counter() - t0
    finally:
        os.dup2(saved_fd, 1)
        os.close(saved_fd)
        os.chdir(here)
        os.environ.clear()
        os.environ.update(saved_env)
    if rc:
        raise RuntimeError(f"`{' '.join(argv)}` exited {rc}")
    return dt


def _ours_time(cmds, reps: int = 1) -> float:
    """min wall clock over in-process CLI runs (the steady-state serving
    model: jax/device already initialized, like any long-lived worker)."""
    return min(sum(run_cli(argv, IDXDIR, os.devnull) for argv in cmds)
               for _ in range(reps))


def _gt_time(cmds) -> float | None:
    """Wall clock of the same commands through a compiled gt binary."""
    if not GT_BIN:
        return None
    t0 = time.perf_counter()
    for argv in cmds:
        subprocess.run([GT_BIN] + argv, check=True, capture_output=True,
                       cwd=str(IDXDIR))
    return time.perf_counter() - t0


def _ensure_workdir(big: str) -> None:
    """Build the 32M index and simulated reads once (untimed)."""
    IDXDIR.mkdir(exist_ok=True)
    if not (IDXDIR / "idx.suf").exists():
        run_cli(["suffixerator", "-db", big, "-indexname", "idx", "-suf",
                 "-lcp", "-tis", "-ssp", "-des", "-sds"], IDXDIR, os.devnull)
    reads = IDXDIR / "reads.fna"
    if not reads.exists():
        from genometools_tpu.core.encseq import Encseq
        rng = np.random.default_rng(7)
        enc = Encseq.from_files([big])
        g = enc.alphabet.decode(enc.codes[:int(enc.seq_length(0))]
                                [:4_000_000])
        L, step = 100, 40
        with open(reads, "w") as f:
            i = 0
            for s in range(0, len(g) - L, step):
                p = s + int(rng.integers(0, 10))
                if p + L > len(g):
                    break
                f.write(f">r{i}\n{g[p:p + L]}\n")
                i += 1


def bench_workloads(dev, big: str, at1: str, out: dict) -> None:
    """The suffixerator end to end, then the tools built on its index,
    all on the 32M input."""
    from genometools_tpu.index.fastpipe import suffixerator_e2e
    _ensure_workdir(big)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        suffixerator_e2e([big], str(IDXDIR / "e2e"), device=dev)
        ts.append(time.perf_counter() - t0)
    out["wl_suffixerator"] = {"ours_s": min(ts), "gt_s": _gt_time(
        [["suffixerator", "-db", big, "-indexname", "gidx", "-suf",
          "-lcp", "-tis"]])}
    loads = {
        "tallymer": [["tallymer", "mkindex", "-mersize", "19", "-minocc",
                      "1", "-indexname", "tyr", "-esa", "idx"],
                     ["tallymer", "search", "-tyr", "tyr", "-q", at1,
                      "-output", "qseqnum", "qpos", "counts"]],
        "repfind": [["repfind", "-l", "14", "-ii", "idx"]],
        "readjoiner": [["readjoiner", "prefilter", "-readset", "rs",
                        "-db", "reads.fna"],
                       ["readjoiner", "overlap", "-readset", "rs", "-l",
                        "45"],
                       ["readjoiner", "assembly", "-readset", "rs"]],
        "seed_extend": [["seed_extend", "-ii", "idx", "-l", "14",
                         "-minidentity", "90", "-extendgreedy"]],
    }
    for name, cmds in loads.items():
        ours = _ours_time(cmds, reps=2 if name == "seed_extend" else 3)
        out[f"wl_{name}"] = {"ours_s": ours, "gt_s": _gt_time(cmds)}
        _log(f"workload {name}: {ours:.3f} s")


def _assemble(results: dict, devices) -> dict:
    """The result line, from whichever parts ran."""
    extra = []
    if "suffix_at1MB" in results:
        extra.append({"metric": "esa_suffixes_per_sec_at1MB",
                      "value": round(results["suffix_at1MB"]["rate"]),
                      "unit": "suffixes/s"})
    if "extension" in results:
        ext, xd = results["extension"], results["xdrop"]
        dx = results["device_extension"]
        extra += [
            {"metric": "seed_extend_extensions_per_sec",
             "value": round(ext["rate"]), "unit": "extensions/s",
             "vs_baseline": round(ext["vs"], 3), "tasks": ext["tasks"]},
            {"metric": "xdrop_extensions_per_sec",
             "value": round(xd["rate"]), "unit": "extensions/s",
             "device_value": round(xd["device_rate"]),
             "tasks": xd["tasks"]},
            {"metric": "seed_extend_device_extension_at1MB_s",
             "value": round(dx["warm_s"], 3), "unit": "s",
             "cold_s": round(dx["cold_s"], 3),
             "host_engine_s": round(dx["host_s"], 3)}]
    for name in ("suffixerator", "tallymer", "repfind", "readjoiner",
                 "seed_extend"):
        w = results.get(f"wl_{name}")
        if w is None:
            continue
        row = {"metric": f"{name}_e2e_s", "value": round(w["ours_s"], 3),
               "unit": "s"}
        if w["gt_s"]:
            row.update(gt_s=round(w["gt_s"], 3),
                       vs_gt=round(w["gt_s"] / w["ours_s"], 3))
        extra.append(row)
    suf = results.get("suffix")
    d = devices[0]
    return {"metric": "esa_suffixes_per_sec",
            "value": round(suf["rate"]) if suf else None,
            "unit": "suffixes/s", "n_suffixes": suf["n"] if suf else None,
            "extra_metrics": extra,
            "device": {"platform": d.platform, "kind": d.device_kind,
                       "count": len(devices)}}


PARTS = ("suffix", "extension", "workloads")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parts", nargs="*", choices=PARTS,
                    help="parts to run (default: all)")
    parts = ap.parse_args(argv).parts or PARTS
    os.environ["JAX_PLATFORMS"] = "cuda"
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import jax

    from genometools_tpu.core.encseq import Encseq
    from genometools_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU (JAX has {dev.platform})")
    IDXDIR.mkdir(exist_ok=True)
    at1 = _ensure_at1mb()
    enc_small = Encseq.from_files([at1])
    results: dict = {}
    if "suffix" in parts:
        big = _ensure_big()
        bench_suffix(dev, Encseq.from_files([big]), enc_small, results)
    if "extension" in parts:
        bench_extension(enc_small, at1, results)
    if "workloads" in parts:
        bench_workloads(dev, _ensure_big(), at1, results)
    print(json.dumps(_assemble(results, devices)))


if __name__ == "__main__":
    main()
