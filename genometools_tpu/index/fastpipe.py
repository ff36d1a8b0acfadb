"""End-to-end suffixerator fast path for accelerator backends.

The complete `gt suffixerator -db X -indexname idx -suf -lcp -tis` job
(ref: src/match/sfx-run.c:428 gt_runsuffixerator): FASTA -> encseq ->
SA+LCP -> reference-format tables on disk — engineered around two
costs of an accelerator behind a host link (the link of the machine the
package first ran on was slow; neither cost is yet measured on a GPU):

  * host<->device bandwidth: the input travels as 2-bit packed words
    (16 symbols per uint32, ~n/4 bytes) and the suffix table comes back
    split-plane packed (low 16 bits as uint16 + three 10-bit high parts
    per uint32, 26 bits/position total ~= its entropy); the LCP table
    returns as the final on-disk u8 plane plus the (rare) overflow
    pairs, so the device ships ~3.4 bytes/suffix instead of 8;
  * latency hiding: the .esq/.ssp/.des/.sds/.md5 writers run on a host
    thread while the device sorts; the LCP kernels are dispatched
    before the suffix-table fetch so they compute during the transfer;
    .suf conversion+write runs on a thread while the LCP plane is in
    flight.

Output files are byte-identical to the slow path (index.esa.write_esa /
core.esq.write_all), which is itself byte-parity-tested against the
compiled reference binary (tests/test_esa_refparity.py).
"""

from __future__ import annotations

import threading
from functools import partial
from pathlib import Path

import numpy as np

from ..core.chardef import WILDCARD, is_special
from ..core.encseq import FWD, Encseq
from .esa import (EnhancedSuffixArray, LCP_OVERFLOW,
                  recommended_prefixlength)
from .suffix import _next_pow2, _pad_size


def _pack2(codes: np.ndarray, npad: int) -> np.ndarray:
    """Host: 2-bit pack regular symbols (specials as 0) into uint32
    words, 16 symbols each, first symbol in the MSBs."""
    n = codes.size
    sym = np.where(codes >= 4, 0, codes).astype(np.uint8)
    padded = np.zeros(npad, np.uint8)
    padded[:n] = sym
    q = padded.reshape(-1, 4)
    b = ((q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3])
    return np.ascontiguousarray(
        b.reshape(-1, 4)[:, ::-1]).reshape(-1).view(np.uint32)


def _special_word_mask(codes: np.ndarray, npad: int) -> np.ndarray:
    """Host: one bit per position (1 = special), packed 16/uint32 word
    aligned with _pack2 (bit 2*(15-(i%16))+1 unused; we use a plain
    16-bit lane: bit (15-(i%16)) of word i//16)."""
    n = codes.size
    bits = np.zeros(npad, bool)
    bits[:n] = codes >= 4
    return np.packbits(bits).view(">u2").astype(np.uint32).reshape(-1)


def _device_jits(npad: int, n1: int, sigma: int, pl: int):
    """Build the jitted device stages for a given padded size."""
    import jax
    import jax.numpy as jnp

    nw = npad // 16

    @jax.jit
    def build_keys(words, specbits):
        # unpack 2-bit symbols and the special mask; canonical key map:
        # regular -> code, special/pad/sentinel at p -> sigma + p
        i = jnp.arange(npad, dtype=jnp.int32)
        w = words[i >> 4]
        sh = (15 - (i & 15)) * 2
        code = (w >> sh) & 3
        sb = (specbits[i >> 4] >> (15 - (i & 15))) & 1
        special = (sb == 1) | (i >= n1 - 1)      # sentinel + pad
        return jnp.where(special, sigma + i, code).astype(jnp.int32)

    @jax.jit
    def pack_sa(sa):
        # split-plane: low 16 bits (uint16) + 10-bit highs packed 3/word
        low = (sa[:n1] & 0xFFFF).astype(jnp.uint16)
        h = sa[:n1] >> 16
        hpad = (n1 + 2) // 3 * 3
        h = jnp.concatenate(
            [h, jnp.zeros(hpad - n1, jnp.int32)]).reshape(-1, 3)
        hp = h[:, 0] | (h[:, 1] << 10) | (h[:, 2] << 20)
        return low, hp

    @jax.jit
    def lcp_planes(lcp, sa, keys):
        # 6-bit LCP plane, 5 values per uint32 (values 0..62 direct;
        # 63 escapes to a sparse (idx, value) side list): the on-disk
        # u8 plane reconstructs on host from ~n1*0.8 transferred bytes
        v6 = jnp.minimum(lcp[:n1], 63)
        p5 = -(-n1 // 5) * 5
        v6p = jnp.concatenate([v6, jnp.zeros(p5 - n1, jnp.int32)])
        q = v6p.reshape(-1, 5)
        nib = (q[:, 0] | (q[:, 1] << 6) | (q[:, 2] << 12)
               | (q[:, 3] << 18) | (q[:, 4] << 24))
        escmask = lcp[:n1] >= 63
        nesc = escmask.sum()
        novf = (lcp[:n1] >= LCP_OVERFLOW).sum()
        maxbd = lcp[:n1].max()
        # averagelcp numerator: lcp values of suffixes whose full
        # prefixlength window is special-free (ref: sfx-lcpvalues.c:414;
        # see index.esa.write_esa) — chunked int32 partial sums so the
        # host can reduce in int64
        spec = (keys[:n1] >= sigma).astype(jnp.int32)
        spc = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(spec)])
        sav = sa[:n1]
        valid = sav + pl <= n1 - 1
        cnt = jnp.where(valid,
                        spc[jnp.minimum(sav + pl, n1)] - spc[sav], 1)
        contrib = jnp.where(valid & (cnt == 0), lcp[:n1], 0)
        csize = -(-n1 // 1024)
        cpad = jnp.concatenate(
            [contrib, jnp.zeros(csize * 1024 - n1, jnp.int32)])
        sums = cpad.reshape(1024, -1).sum(axis=1)
        longest = jnp.argmax(sa[:n1] == 0).astype(jnp.int32)
        return nib, escmask, nesc, novf, maxbd, sums, longest

    @partial(jax.jit, static_argnames=("k",))
    def grab_escapes(lcp, escmask, k: int):
        idx = jnp.nonzero(escmask, size=k, fill_value=n1)[0]
        val = jnp.minimum(lcp[jnp.minimum(idx, n1 - 1)], LCP_OVERFLOW)
        return idx.astype(jnp.int32), val.astype(jnp.int32)

    return build_keys, pack_sa, lcp_planes, grab_escapes


def _overflow_pairs(lcp_dev, n1: int, count: int):
    import jax
    import jax.numpy as jnp
    k = max(1, _next_pow2(count))

    @partial(jax.jit, static_argnames=("kk",))
    def grab(lcp, kk):
        idx = jnp.nonzero(lcp[:n1] >= LCP_OVERFLOW, size=kk,
                          fill_value=0)[0]
        return idx.astype(jnp.int32), lcp[idx]

    idx, val = grab(lcp_dev, k)
    return np.asarray(idx)[:count], np.asarray(val)[:count]


def suffixerator_e2e(fasta_paths: list[str], indexname: str,
                     device=None) -> None:
    """FASTA -> .esq/.ssp/.des/.sds/.md5 + .suf/.lcp/.llv/.prj, with host
    and device work overlapped (see module docstring)."""
    import os
    import sys
    import time
    import jax
    import jax.numpy as jnp

    if os.environ.get("GT_E2E_DEBUG") == "1":
        _t0 = time.perf_counter()

        def _mark(label):
            print(f"  [e2e] {label:28s} {time.perf_counter() - _t0:6.2f}s",
                  file=sys.stderr, flush=True)
    else:
        def _mark(label):
            pass

    if device is None:
        device = jax.devices()[0]

    enc = Encseq.from_files(fasta_paths)
    _mark("parse+encode")
    n = enc.total_length
    n1 = n + 1
    # small-input latency floor: below GT_E2E_HOST_MAX symbols (default
    # 4M, chosen on the machine the package first ran on, not yet
    # measured on a GPU; 0 disables) run the host C++ SA-IS + Kasai
    # path (independent second constructor, gt byte-exact) with the
    # encseq writers overlapped.
    host_max = int(os.environ.get("GT_E2E_HOST_MAX", 4 << 20))
    if 0 < n1 <= host_max:
        from ..core.native import kasai_lcp_native, sais_native
        keys = enc.suffix_keys()
        sa = sais_native(keys)
        if sa is not None:
            herrs: list[BaseException] = []

            def _esq():
                try:
                    from ..core.esq import write_all
                    write_all(enc, indexname)
                except BaseException as exc:   # noqa: BLE001
                    herrs.append(exc)

            wt = threading.Thread(target=_esq)
            wt.start()
            lcp = kasai_lcp_native(keys, sa)
            from . import esa as esa_mod
            esa = esa_mod.EnhancedSuffixArray(
                encseq=enc, readmode=0, suftab=np.asarray(sa),
                lcptab=None if lcp is None else np.asarray(lcp),
                prefixlength=esa_mod.recommended_prefixlength(
                    enc.alphabet.num_chars, n))
            esa_mod.write_esa(esa, indexname, suf=True,
                              lcp=lcp is not None)
            wt.join()
            if herrs:
                raise herrs[0]
            _mark("host sais+kasai e2e")
            return
    sigma = enc.alphabet.num_chars
    npad = max(16, _pad_size(n1))
    if npad > 2 ** 26:
        raise NotImplementedError("split-plane packing assumes n < 2^26")
    pl = recommended_prefixlength(sigma, n)

    errs: list[BaseException] = []

    def _guard(fn):
        def run():
            try:
                fn()
            except BaseException as exc:      # noqa: BLE001
                errs.append(exc)
        return run

    # host writers for the encseq family run while the device sorts
    def write_encseq_side():
        from ..core.esq import write_all
        write_all(enc, indexname)

    w1 = threading.Thread(target=_guard(write_encseq_side))
    w1.start()

    build_keys, pack_sa, lcp_planes, grab_escapes = \
        _device_jits(npad, n1, sigma, pl)
    words = _pack2(enc.codes, npad)
    specb = _special_word_mask(enc.codes, npad)
    _mark("pack2+specmask")
    with jax.default_device(device):
        wdev = jax.device_put(jnp.asarray(words), device)
        sdev = jax.device_put(jnp.asarray(specb), device)
        keys = build_keys(wdev, sdev)
        _mark("h2d+keys dispatched")

        from .suffix import _sa_pipeline
        sa, lcp = _sa_pipeline(keys, n1, sigma, True)
        _mark("sa+lcp dispatched")

        low, hp = pack_sa(sa)
        nib, escmask, nesc, novf, maxbd, sums, longest = \
            lcp_planes(lcp, sa, keys)
        _mark("pack/lcp-planes dispatched")

        # overlapped chunked fetch + write: the suffix planes come back
        # as ~6MB slices pulled by a small thread pool (parallel
        # transfer streams beat one serial fetch on the link it was
        # tuned for; not yet measured on a GPU), and the
        # writer thread packs+appends each chunk while later chunks are
        # still in flight — so the 8-byte-word .suf materializes during
        # the transfer instead of after it
        from concurrent.futures import ThreadPoolExecutor
        suf_path = Path(indexname + ".suf")
        CH = 6 * (1 << 20)                  # multiple of 3
        nchunks = max(1, -(-n1 // CH))

        def fetch_chunk(ci):
            a = ci * CH
            b = min(n1, a + CH)
            lo = np.asarray(low[a:b])
            hpc = np.asarray(hp[a // 3:(b + 2) // 3]).view(np.uint32)
            return lo, hpc

        pool = ThreadPoolExecutor(max_workers=4)
        # the lcp nib plane gates the serial .lcp/.llv tail: fetch it
        # on the first worker, suf chunks stream on the rest
        nib_fut = pool.submit(
            lambda: np.asarray(nib).view(np.uint32))
        futs = [pool.submit(fetch_chunk, ci) for ci in range(nchunks)]

        def write_suf():
            from ..core.native import pack_suf_native
            buf = np.empty(CH, np.uint64)
            with open(suf_path, "wb") as f:
                for ci in range(nchunks):
                    lo, hpc = futs[ci].result()
                    m = lo.size
                    if not pack_suf_native(lo, hpc, buf[:m]):
                        h0 = np.repeat(hpc.astype(np.uint32), 3)[:m]
                        sh = np.tile(np.arange(3, dtype=np.uint32),
                                     (m + 2) // 3)[:m] * 10
                        hi = (h0 >> sh) & 1023
                        buf[:m] = lo.astype(np.uint64) \
                            | (hi.astype(np.uint64) << 16)
                    buf[:m].tofile(f)

        w2 = threading.Thread(target=_guard(write_suf))
        w2.start()

        nib_np = nib_fut.result()
        _mark("fetched lcp plane")
        nesc_i = int(np.asarray(nesc))
        small_np = np.empty((nib_np.size, 5), np.uint8)
        for j in range(5):
            small_np[:, j] = (nib_np >> (6 * j)) & 63
        small_np = small_np.reshape(-1)[:n1]
        if nesc_i:
            eidx, eval_ = grab_escapes(lcp, escmask,
                                       max(1, _next_pow2(nesc_i)))
            eidx = np.asarray(eidx)[:nesc_i]
            small_np[eidx] = np.asarray(eval_)[:nesc_i].astype(np.uint8)
        novf_i = int(np.asarray(novf))
        maxbd_i = int(np.asarray(maxbd))
        lcpsum = int(np.asarray(sums).astype(np.int64).sum())
        longest_i = int(np.asarray(longest))

        small_np.tofile(indexname + ".lcp")
        if novf_i:
            idx, val = _overflow_pairs(lcp, n1, novf_i)
            llv = np.empty((novf_i, 2), np.uint64)
            llv[:, 0] = idx.astype(np.uint64)
            llv[:, 1] = val.astype(np.uint64)
            llv.tofile(indexname + ".llv")
        else:
            Path(indexname + ".llv").write_bytes(b"")

        esa = EnhancedSuffixArray(
            encseq=enc, readmode=FWD,
            suftab=np.zeros(0, np.int64), prefixlength=pl)
        _write_prj_fast(esa, indexname, novf_i, lcpsum / n1, maxbd_i,
                        longest_i, n1)
        w2.join()
        pool.shutdown(wait=False)
        _mark("suf written")
    w1.join()
    _mark("esq side written (join)")
    if errs:
        raise errs[0]


def _write_prj_fast(esa, indexname: str, numoflargelcps: int,
                    averagelcp: float, maxbranchdepth: int,
                    longest: int, numsorted: int) -> None:
    """Identical .prj content to index.esa._write_prj without touching
    esa.suftab (longest is passed in from the device)."""
    import sys as _sys
    enc = esa.encseq
    codes = enc.codes
    sp = is_special(codes)
    nn = codes.size
    lpre = int(np.argmin(sp)) if not sp.all() else nn
    lsuf = int(np.argmin(sp[::-1])) if not sp.all() else nn
    wc = codes == WILDCARD
    wpre = int(np.argmin(wc)) if not wc.all() else nn
    wsuf = int(np.argmin(wc[::-1])) if not wc.all() else nn
    lines = [
        f"totallength={nn}",
        f"specialcharacters={enc.special_ranges.total}",
        f"specialranges={enc.special_ranges.count}",
        f"realspecialranges={enc.special_ranges.count}",
        f"lengthofspecialprefix={lpre if sp.size and sp[0] else 0}",
        f"lengthofspecialsuffix={lsuf if sp.size and sp[-1] else 0}",
        f"wildcards={enc.wildcard_ranges.total}",
        f"wildcardranges={enc.wildcard_ranges.count}",
        f"realwildcardranges={enc.wildcard_ranges.count}",
        f"lengthofwildcardprefix={wpre if wc.size and wc[0] else 0}",
        f"lengthofwildcardsuffix={wsuf if wc.size and wc[-1] else 0}",
        f"numofsequences={enc.num_sequences}",
        f"numofdbsequences={enc.num_sequences}",
        "numofquerysequences=0",
        f"numberofallsortedsuffixes={numsorted}",
        f"longest={longest}",
        f"prefixlength={esa.prefixlength}",
        f"largelcpvalues={numoflargelcps}",
        f"averagelcp={averagelcp:.2f}",
        f"maxbranchdepth={maxbranchdepth}",
        "integersize=64",
        f"littleendian={'1' if _sys.byteorder == 'little' else '0'}",
        "readmode=0",
        f"mirrored={'1' if enc.mirrored else '0'}",
    ]
    Path(indexname + ".prj").write_text("\n".join(lines) + "\n")
