"""Lockstep validation of the device-batched greedy extension kernel
(ops/greedy_batch.py) against the scalar mirror ops/greedy.py — itself
golden-verified against the reference front-prune engine
(ref: src/match/ft-front-prune.c:633, ft-polish.c)."""

import numpy as np
import pytest

from genometools_tpu.ops.greedy import PolishingInfo, greedy_extend
from genometools_tpu.ops.greedy_batch import (_GreedyBatchConfig,
                                              _polish_walk,
                                              greedy_extend_batch)


def _gen_cases(seed, count, maxlen, special_p=0.25):
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(count):
        n = int(rng.integers(1, maxlen))
        m = int(rng.integers(1, maxlen))
        u = rng.integers(0, 4, n).astype(np.uint8)
        if rng.random() < 0.75:
            v = u.copy()[:m] if m <= n else np.concatenate(
                [u, rng.integers(0, 4, m - n).astype(np.uint8)])
            for _ in range(int(rng.integers(0, max(1, m // 8)))):
                p = int(rng.integers(0, m))
                v[p] = rng.integers(0, 4)
        else:
            v = rng.integers(0, 4, m).astype(np.uint8)
        if rng.random() < special_p:
            u[rng.integers(0, n)] = 254
        if rng.random() < special_p:
            v[rng.integers(0, m)] = 255
        cases.append((u, v))
    return cases


def _check(cases, hist=64, pmh=55, mad=30, errp=20.0, cfg=None):
    pol = PolishingInfo.new(errp, hist)
    res = greedy_extend_batch(
        [u for u, v in cases], [v for u, v in cases],
        seedlengths=14, perc_mat_history=pmh,
        maxalignedlendifference=mad, pol_info=pol, history=hist, cfg=cfg)
    n_fb = int(res["fallback"].sum())
    for i, (u, v) in enumerate(cases):
        if res["fallback"][i]:
            continue
        dist, best = greedy_extend(
            u, v, max_history=hist, perc_mat_history=pmh,
            maxalignedlendifference=mad, seedlength=14, pol_info=pol)
        died = dist == len(u) + len(v) + 1
        assert res["alignedlen"][i] == best.alignedlen, i
        assert res["row"][i] == best.row, i
        assert res["distance"][i] == best.distance, i
        assert res["mismatches"][i] == best.max_mismatches, i
        assert bool(res["died"][i]) == died, i
    return n_fb


class TestGreedyBatchLockstep:
    def test_small_random(self):
        assert _check(_gen_cases(0, 150, 120)) == 0

    def test_multi_chunk(self):
        """Sequences longer than the first window tier force the
        chunked continuation path (pause/rollback + host rebase)."""
        assert _check(_gen_cases(7, 60, 1500)) == 0

    def test_long_runs_escalate_tiers(self):
        """An identical 30k pair forces two window-tier escalations
        (match run crosses the whole window) and must stay exact."""
        rng = np.random.default_rng(3)
        big = rng.integers(0, 4, 30000).astype(np.uint8)
        cases = [(big, big.copy())] + _gen_cases(9, 10, 300)
        assert _check(cases) == 0

    def test_history_sizes(self):
        cases = _gen_cases(21, 60, 400)
        for hist in (30, 45, 60, 64):
            assert _check(cases, hist=hist) == 0

    def test_edge_lanes(self):
        z = np.zeros(0, np.uint8)
        sp = np.full(50, 254, np.uint8)
        one = np.array([2], np.uint8)
        cases = [(z, z), (sp, sp.copy()), (one, one.copy()),
                 (z, one), (one, z)]
        assert _check(cases) == 0

    def test_polish_walk_matches_reference_table(self):
        import jax.numpy as jnp
        pol = PolishingInfo.new(20.0, 64)
        idx = np.arange(1 << 15, dtype=np.int32)
        dfm, ss = _polish_walk(jnp.asarray(idx),
                               jnp.int32(pol.match_score),
                               jnp.int32(pol.difference_score), 15)
        assert np.array_equal(np.asarray(dfm), pol.diff_from_max)
        assert np.array_equal(np.asarray(ss), pol.score_sum)


class TestSeedExtendDevicePath:
    def test_golden_equal_with_and_without_device(self, testdata):
        """seed_extend greedy output must be identical whether the
        extension batch runs on device or the host scalar engine."""
        import os
        from genometools_tpu.core.encseq import Encseq
        from genometools_tpu.match.seed_extend import (SeedExtendParams,
                                                       seed_extend)
        e = Encseq.from_files([str(testdata / "small_poly.fas")])

        def run():
            p = SeedExtendParams(sensitivity=97, minidentity=80,
                                 userdefinedleastlength=10,
                                 extension="greedy")
            return [m.line() for m in seed_extend(e, None, p)]

        os.environ["GT_TPU_DEVICE_EXTEND"] = "1"
        try:
            dev = run()
        finally:
            del os.environ["GT_TPU_DEVICE_EXTEND"]
        host = run()   # cpu backend default: host engine
        assert dev == host
        want = [l.strip() for l in
                open(str(testdata / "seedextend3.out")) if l.strip()]
        assert dev == want


class TestPoolResidentPath:
    """The workload's pool form (one sequence pool plus per-task
    offsets) describes the same flank tasks as its array form."""

    def test_workload_pool_equals_tasks(self, tmp_path):
        from genometools_tpu.core.encseq import Encseq
        from genometools_tpu.match.ext_workload import (
            collect_extension_pool, collect_extension_tasks)
        rng = np.random.default_rng(5)
        pieces = ["".join(rng.choice(list("acgt"), 300)) for _ in range(4)]
        pieces.append(pieces[0][:250])            # force seeds
        e = Encseq.from_string("|".join(pieces))
        tasks, k = collect_extension_tasks(e)
        pool, uo, ul, vo, vl, rv, k2 = collect_extension_pool(e)
        assert k == k2 and len(tasks) == uo.size
        for t, (u, v) in enumerate(tasks):
            pu = pool[uo[t]:uo[t] + ul[t]]
            pv = pool[vo[t]:vo[t] + vl[t]]
            if rv[t]:
                pu, pv = pu[::-1], pv[::-1]
            assert np.array_equal(u, pu) and np.array_equal(v, pv), t
