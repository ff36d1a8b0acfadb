"""Mesh-sharded readjoiner overlap counting — the firstcodes analog.

The reference distributes the overlap phase by sharding k-mer code
ranges over threads/parts (ref: src/match/firstcodes.c:1517 parts
logic + the rdj pipeline wiring): pass A counts suffix-window vs
read-prefix code collisions per part to size buffers and balance the
parts, pass B materializes the matches part by part.

Mesh-native shape of the same design: suffix-window positions are
sharded over the device mesh; every device holds the (replicated)
sorted prefix-code list — the replicated-encseq model — and counts its
windows' candidate matches with two device `searchsorted`s, reduced
with one `psum`.  Codes are rank-compressed to dense int32 ids on the
host first (order-preserving, so searchsorted semantics are unchanged;
the mesh runs without x64 — same trick as dist_seed_grid).  The count
sizes and balances the emission stage (the host window-scan join,
native/gtnative.cpp gt_spm_find, already partitioned by contiguous
read ranges), exactly like the sharded mlistlen drives the seed_extend
grid dispatch.

Exactness bar: the device count equals a host mirror of the candidate
count (tests/test_parallel.py TestDistributedReadjoiner).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


@partial(jax.jit, static_argnames=("npos", "mesh"))
def _count_stage(wids, sorted_pref_ids, npos: int, mesh: Mesh):
    """Sharded candidate count: position block per device, two
    searchsorted over the replicated sorted prefix ids, psum."""
    ndev = mesh.devices.size
    npad = ((npos + ndev - 1) // ndev) * ndev
    pos_all = jnp.arange(npad, dtype=jnp.int32)

    def stage(pos_shard):
        valid = pos_shard < npos
        wc = wids[jnp.minimum(pos_shard, npos - 1)]
        lo = jnp.searchsorted(sorted_pref_ids, wc, side="left")
        hi = jnp.searchsorted(sorted_pref_ids, wc, side="right")
        return jax.lax.psum(jnp.where(valid, hi - lo, 0).sum(), "shard")

    return jax.shard_map(stage, mesh=mesh, in_specs=(P("shard"),),
                         out_specs=P(), check_vma=False)(pos_all)


def _mirrored(readset):
    """(blob, starts, lens) of the mirrored read list (fwd + rc),
    matching assembly.readjoiner.find_spms's numbering."""
    n = readset.num_reads
    lens_f = np.fromiter((len(x) for x in readset.reads), np.int64, n)
    blob_f = np.concatenate(readset.reads)
    lens = np.concatenate([lens_f, lens_f[::-1]])
    blob = np.concatenate([blob_f, (3 - blob_f[::-1]).astype(np.uint8)])
    return blob, np.cumsum(lens) - lens, lens


def sharded_spm_candidate_count(readset, minlen: int, mesh: Mesh) -> int:
    """Pass-A: total (suffix window, read prefix) code collisions over
    the mirrored read set, counted sharded over the mesh — the quantity
    firstcodes accumulates per code part to size pass-B buffers
    (ref: firstcodes.c gt_firstcodes_accumulatecounts)."""
    if readset.num_reads == 0:
        return 0
    k = min(minlen, 31)
    blob, starts, lens = _mirrored(readset)
    total = int(blob.size)
    if total < k:
        return 0
    npos = total - k + 1
    wcode = np.zeros(npos, np.int64)
    for j in range(k):
        wcode = wcode * 4 + blob[j:j + npos]
    rid = np.repeat(np.arange(lens.size, dtype=np.int64), lens)
    offs = np.arange(total, dtype=np.int64) - starts[rid]
    sel = np.flatnonzero((lens[rid] - offs)[:npos] >= minlen)
    pref = wcode[starts[lens >= k]]
    # dense order-preserving int32 ids (no x64 on the mesh)
    union = np.unique(np.concatenate([wcode[sel], pref]))
    wids = np.searchsorted(union, wcode[sel]).astype(np.int32)
    pids = np.sort(np.searchsorted(union, pref)).astype(np.int32)
    cnt = _count_stage(jnp.asarray(wids), jnp.asarray(pids),
                       int(sel.size), mesh)
    return int(np.asarray(cnt))


def distributed_find_spms(readset, minlen: int, mesh: Mesh,
                          irreducible: bool = True):
    """Counting-informed overlap: pass A sizes the workload on the
    mesh (candidate count -> emission lane count), pass B runs the
    window-scan join over contiguous read-range lanes. Output is
    identical to assembly.readjoiner.find_spms (same engine, same
    order) — the reference's part-count invariance."""
    candidates = sharded_spm_candidate_count(readset, minlen, mesh)
    import os
    lanes = max(1, min(mesh.devices.size, os.cpu_count() or 1,
                       1 + candidates // 4096))
    os.environ["GT_SPM_LANES"] = str(lanes)
    try:
        from ..assembly.readjoiner import find_spms
        return find_spms(readset, minlen, irreducible=irreducible)
    finally:
        os.environ.pop("GT_SPM_LANES", None)
