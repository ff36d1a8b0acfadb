"""Batched extension engines on the device paths (XLA greedy chunk
recurrence, lax xdrop batch) against the scalar mirrors ops/greedy.py
and ops/xdrop.py, which are the golden oracles (ref:
src/match/ft-front-prune.c:633, src/match/xdrop.c:224)."""

import numpy as np
import pytest

from genometools_tpu.ops import xdrop_batch as xb
from genometools_tpu.ops.greedy import PolishingInfo, greedy_extend
from genometools_tpu.ops.greedy_batch import greedy_extend_batch
from genometools_tpu.ops.xdrop import xdrop_extend

GREEDY_KW = dict(seedlengths=14, perc_mat_history=55,
                 maxalignedlendifference=30, history=60)


def _mutated_pairs(rng, n, err, length):
    """v is u with a share `err` of substitutions, sometimes two
    deletions; u sometimes carries a wildcard."""
    us, vs = [], []
    for _ in range(n):
        u = rng.integers(0, 4, length).astype(np.uint8)
        v = u.copy()
        for p in rng.integers(0, length, int(err * length)):
            v[p] = rng.integers(0, 4)
        if rng.random() < 0.3:
            v = np.delete(v, rng.integers(0, len(v), 2))
        if rng.random() < 0.3:
            u[rng.integers(0, len(u))] = 254
        us.append(u)
        vs.append(v)
    return us, vs


def _homology_pairs(rng, n, maxlen, identity=0.85):
    """v is an edited copy of u (substitutions, insertions, deletions),
    so the xdrop front actually extends."""
    us, vs = [], []
    for _ in range(n):
        lu = int(rng.integers(5, maxlen))
        u = rng.integers(0, 4, lu).astype(np.uint8)
        v = []
        i = 0
        while i < lu:
            r = rng.random()
            if r < identity:
                v.append(u[i])
                i += 1
            elif r < identity + 0.05:
                v.append(rng.integers(0, 4))
                i += 1
            elif r < identity + 0.10:
                i += 1
            else:
                v.append(rng.integers(0, 4))
        v = np.asarray(v, np.uint8)[:maxlen]
        if v.size == 0:
            v = rng.integers(0, 4, 3).astype(np.uint8)
        us.append(u)
        vs.append(v)
    return us, vs


def _check_greedy(us, vs, pol, res, allow_fallback=True):
    if not allow_fallback:
        assert not res["fallback"].any()
    for i in range(len(us)):
        if res["fallback"][i]:
            continue
        _, best = greedy_extend(
            us[i], vs[i], max_history=60, perc_mat_history=55,
            maxalignedlendifference=30, seedlength=14, pol_info=pol)
        assert res["alignedlen"][i] == best.alignedlen, i
        assert res["row"][i] == best.row, i
        assert res["distance"][i] == best.distance, i
        assert res["mismatches"][i] == best.max_mismatches, i


class TestGreedyXlaBatch:
    @pytest.mark.parametrize("seed", [0, 17])
    @pytest.mark.parametrize("err", [0.02, 0.15, 0.4])
    def test_matches_scalar_engine(self, seed, err):
        rng = np.random.default_rng(seed + int(err * 100))
        us, vs = _mutated_pairs(rng, 48, err, 300)
        pol = PolishingInfo.new(20.0, 60)
        res = greedy_extend_batch(us, vs, pol_info=pol, **GREEDY_KW)
        _check_greedy(us, vs, pol, res, allow_fallback=False)

    def test_long_extensions(self):
        """Near-identical 2000-symbol pairs run through several window
        rebases (pause, rollback, recentre) and stay exact."""
        rng = np.random.default_rng(7)
        u = rng.integers(0, 4, 2000).astype(np.uint8)
        v = u.copy()
        for p in rng.integers(0, 2000, 60):
            v[p] = rng.integers(0, 4)
        pol = PolishingInfo.new(20.0, 60)
        res = greedy_extend_batch([u] * 3, [v] * 3, pol_info=pol,
                                  **GREEDY_KW)
        _check_greedy([u] * 3, [v] * 3, pol, res, allow_fallback=False)

    def test_reversed_pool_flanks(self):
        """Flanks cut from one sequence pool, left flanks read reversed
        as seed_extend cuts them, wildcards in the pool."""
        rng = np.random.default_rng(23)
        pool = rng.integers(0, 4, 4000).astype(np.uint8)
        pool[rng.integers(0, 4000, 40)] = 254
        us, vs = [], []
        for _ in range(96):
            uo, vo = rng.integers(0, 3000, 2)
            ul, vl = rng.integers(1, 220, 2)
            u, v = pool[uo:uo + ul], pool[vo:vo + vl]
            if rng.random() < 0.5:
                u, v = u[::-1], v[::-1]
            us.append(u)
            vs.append(v)
        pol = PolishingInfo.new(20.0, 60)
        res = greedy_extend_batch(us, vs, pol_info=pol, **GREEDY_KW)
        _check_greedy(us, vs, pol, res)


class TestXdropLaxBatch:
    @pytest.mark.parametrize("belowscore", [4, 7])
    def test_matches_scalar(self, belowscore):
        rng = np.random.default_rng(7)
        us, vs = _homology_pairs(rng, 64, 126)
        iv, jv, sv, unsafe = xb._run_device(us, vs, belowscore, 128, 16)
        safe = 0
        for t in range(len(us)):
            if unsafe[t]:
                continue
            safe += 1
            ref = xdrop_extend(us[t], vs[t], belowscore)
            assert (iv[t], jv[t], sv[t]) == \
                (ref.ivalue, ref.jvalue, ref.score), t
        assert safe >= len(us) // 2, "device must finish most tasks"

    def test_specials_and_tiny(self):
        """Wildcards never match; one- and three-symbol tasks end at
        once."""
        rng = np.random.default_rng(3)
        us, vs = _homology_pairs(rng, 30, 100)
        for i in range(0, 30, 3):
            u = us[i].copy()
            u[rng.integers(0, len(u))] = 254
            us[i] = u
        us += [np.array([1, 2, 3], np.uint8), np.array([0], np.uint8)]
        vs += [np.array([1, 2, 3], np.uint8), np.array([3, 3], np.uint8)]
        iv, jv, sv, unsafe = xb._run_device(us, vs, 7, 128, 16)
        for t in range(len(us)):
            if unsafe[t]:
                continue
            ref = xdrop_extend(us[t], vs[t], 7)
            assert (iv[t], jv[t], sv[t]) == \
                (ref.ivalue, ref.jvalue, ref.score), t

    def test_exact_batch_without_native_library(self, monkeypatch):
        """With no C++ library the product batch takes the lax device
        path and re-runs unverified lanes on the scalar mirror: every
        lane equals the scalar engine."""
        from genometools_tpu.core import native
        monkeypatch.setattr(native, "xdrop_batch_native",
                            lambda *a, **k: None)
        rng = np.random.default_rng(11)
        us, vs = _homology_pairs(rng, 48, 300)
        iv, jv, sv = xb.xdrop_extend_batch_exact(us, vs, 7)
        for t in range(len(us)):
            ref = xdrop_extend(us[t], vs[t], 7)
            assert (iv[t], jv[t], sv[t]) == \
                (ref.ivalue, ref.jvalue, ref.score), t
