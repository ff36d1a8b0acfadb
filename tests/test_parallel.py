"""Multi-device pipeline tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

from genometools_tpu.core.encseq import Encseq
from genometools_tpu.index.suffix import build_suffix_array
from genometools_tpu.parallel.dist_esa import (make_mesh,
                                               sharded_kmer_histogram,
                                               sharded_suffix_sort)


def _keys_padded(seqstr, ndev=8):
    import jax.numpy as jnp
    e = Encseq.from_string(seqstr)
    keys = e.suffix_keys()
    n1 = keys.size
    npad = ((n1 + ndev - 1) // ndev) * ndev
    pad = keys.max() + 1 + np.arange(npad - n1, dtype=np.int32)
    return np.concatenate([keys, pad]).astype(np.int32), n1, npad


class TestShardedPipeline:
    def test_histogram(self):
        import jax.numpy as jnp
        mesh = make_mesh(8)
        keys, n1, npad = _keys_padded("acgtacgtnn|ggg")
        hist = sharded_kmer_histogram(jnp.asarray(keys), npad, mesh)
        assert int(np.asarray(hist).sum()) == npad

    def test_sharded_sort_matches_single(self):
        import jax.numpy as jnp
        mesh = make_mesh(8)
        rng = np.random.default_rng(0)
        s = "".join(rng.choice(list("acgtn"), 301, p=[0.24] * 4 + [0.04]))
        keys, n1, npad = _keys_padded(s)
        sa, hist = sharded_suffix_sort(jnp.asarray(keys), npad, 32, mesh)
        ref, _ = build_suffix_array(keys, with_lcp=False)
        assert np.asarray(sa).tolist() == np.asarray(ref)[:npad].tolist()


class TestDistributedDoubling:
    @pytest.mark.parametrize("seed", range(3))
    def test_matches_single_chip(self, seed):
        import jax.numpy as jnp
        from genometools_tpu.parallel.dist_doubling import \
            distributed_build_sa
        mesh = make_mesh(8)
        rng = np.random.default_rng(seed)
        s = "".join(rng.choice(list("acgtn"), 500, p=[0.24] * 4 + [0.04]))
        keys, n1, npad = _keys_padded(s)
        sa = distributed_build_sa(jnp.asarray(keys), npad, mesh)
        ref, _ = build_suffix_array(keys, with_lcp=False)
        assert np.asarray(sa).tolist() == np.asarray(ref)[:npad].tolist()

    def test_repetitive(self):
        import jax.numpy as jnp
        from genometools_tpu.parallel.dist_doubling import \
            distributed_build_sa
        mesh = make_mesh(8)
        keys, n1, npad = _keys_padded("acg" * 120)
        sa = distributed_build_sa(jnp.asarray(keys), npad, mesh)
        ref, _ = build_suffix_array(keys, with_lcp=False)
        assert np.asarray(sa).tolist() == np.asarray(ref)[:npad].tolist()


class TestShardedDoubling:
    """Position-sharded engine: O(n/P) per-device memory and traffic
    (parallel/dist_doubling_sharded.py)."""

    @pytest.mark.parametrize("n", [16, 253, 1000, 4096])
    def test_matches_single_chip(self, n):
        from genometools_tpu.parallel.dist_doubling_sharded import \
            sharded_suffix_array
        mesh = make_mesh(8)
        rng = np.random.default_rng(n)
        s = "".join(rng.choice(list("acgtn"), n, p=[0.24] * 4 + [0.04]))
        e = Encseq.from_string(s)
        keys = e.suffix_keys()
        sa = sharded_suffix_array(keys, mesh)
        ref, _ = build_suffix_array(keys, with_lcp=False)
        assert sa.tolist() == np.asarray(ref).tolist()

    def test_repetitive_no_skew_sensitivity(self):
        # heavy rank duplication: the block-bitonic network has no
        # value-range routing, so repetitive inputs cannot overflow
        from genometools_tpu.parallel.dist_doubling_sharded import \
            sharded_suffix_array
        mesh = make_mesh(8)
        e = Encseq.from_string("acg" * 1000 + "t")
        keys = e.suffix_keys()
        sa = sharded_suffix_array(keys, mesh)
        ref, _ = build_suffix_array(keys, with_lcp=False)
        assert sa.tolist() == np.asarray(ref).tolist()

    @pytest.mark.parametrize("ndev", [1, 2, 4])
    def test_smaller_meshes(self, ndev):
        from genometools_tpu.parallel.dist_doubling_sharded import \
            sharded_suffix_array
        mesh = make_mesh(ndev)
        e = Encseq.from_string("mississippimississippi|acgtacgt")
        keys = e.suffix_keys()
        sa = sharded_suffix_array(keys, mesh)
        ref, _ = build_suffix_array(keys, with_lcp=False)
        assert sa.tolist() == np.asarray(ref).tolist()


class TestRolledRounds:
    """The doubling rounds run as one while_loop: the shifted block fetch
    takes a traced shift h = q*C + r, and h doubles as (q, r)."""

    _fetch = None

    @classmethod
    def _traced_fetch(cls):
        """One compiled fetch for every shift (nP = 8 blocks of C = 4)."""
        if cls._fetch is None:
            import jax
            import jax.numpy as jnp
            from jax.sharding import PartitionSpec as P

            from genometools_tpu.parallel.dist_doubling_sharded import \
                _shifted_fetch
            mesh = make_mesh(8)

            def stage(blk, q, r):
                return _shifted_fetch(blk, q, r, 8, "shard", 4,
                                      np.int32(-7))

            cls._fetch = jax.jit(jax.shard_map(
                stage, mesh=mesh, in_specs=(P("shard"), P(), P()),
                out_specs=P("shard"), check_vma=False))
            cls._jnp = jnp
        return cls._fetch

    @pytest.mark.parametrize("h", [0, 1, 3, 4, 5, 17, 28, 31])
    def test_traced_shift_matches_global_shift(self, h):
        fetch = self._traced_fetch()
        jnp = self._jnp
        x = np.arange(100, 132, dtype=np.int32)
        got = np.asarray(fetch(jnp.asarray(x), jnp.int32(h // 4),
                               jnp.int32(h % 4)))
        want = np.concatenate([x[h:], np.full(h, -7, np.int32)])
        assert got.tolist() == want.tolist()

    @pytest.mark.parametrize("C", [4, 1000, 1 << 30])
    def test_double_shift_matches_integer_doubling(self, C):
        import jax.numpy as jnp

        from genometools_tpu.parallel.dist_doubling_sharded import \
            _double_shift
        h = 4
        q, r = jnp.int32(h // C), jnp.int32(h % C)
        for _ in range(40):
            q, r = _double_shift(q, r, C)
            h *= 2
            if h // C >= 8:
                break
            assert (int(q), int(r)) == divmod(h, C)


class TestSampleSortExchange:
    """Sample-sort exchange engine (splitter broadcast + bucketed
    all_to_all, overflow-checked; ~1/P per-device traffic per round)."""

    @pytest.mark.parametrize("seed", range(4))
    def test_sample_engine_no_overflow_on_random(self, seed):
        import jax.numpy as jnp
        from genometools_tpu.parallel.dist_doubling_sharded import \
            sharded_build_sa_sample
        mesh = make_mesh(8)
        rng = np.random.default_rng(seed)
        n = int(rng.integers(300, 3000))
        s = "".join(rng.choice(list("acgtn"), n, p=[0.24] * 4 + [0.04]))
        e = Encseq.from_string(s)
        keys = e.suffix_keys()
        n1 = keys.size
        npad = 1 << max(3, (n1 - 1).bit_length())
        pad = keys.max() + 1 + np.arange(npad - n1, dtype=np.int32)
        keysp = np.concatenate([keys, pad]).astype(np.int32)
        sa, ovf = sharded_build_sa_sample(jnp.asarray(keysp), npad, mesh)
        assert int(np.asarray(ovf)) == 0, \
            "random DNA must not overflow the sample-sort buckets"
        ref, _ = build_suffix_array(keys, with_lcp=False)
        assert np.asarray(sa)[:n1].tolist() == np.asarray(ref).tolist()

    def test_bitonic_engine_still_exact(self):
        from genometools_tpu.parallel.dist_doubling_sharded import \
            sharded_suffix_array
        mesh = make_mesh(8)
        rng = np.random.default_rng(11)
        s = "".join(rng.choice(list("acgt"), 700))
        keys = Encseq.from_string(s).suffix_keys()
        sa = sharded_suffix_array(keys, mesh, engine="bitonic")
        ref, _ = build_suffix_array(keys, with_lcp=False)
        assert sa.tolist() == np.asarray(ref).tolist()

    @pytest.mark.parametrize("text", ["a" * 1200, "acg" * 500,
                                      "a" * 600 + "c" * 600])
    def test_pathological_skew_no_overflow(self, text):
        # worst-case skew (rank plateaus, sorted pad tail): the two-hop
        # balanced routing bounds every per-pair bucket by construction,
        # so even these inputs must route without overflow AND be exact
        import jax.numpy as jnp
        from genometools_tpu.parallel.dist_doubling_sharded import \
            sharded_build_sa_sample
        mesh = make_mesh(8)
        keys = Encseq.from_string(text).suffix_keys()
        n1 = keys.size
        npad = 1 << max(3, (n1 - 1).bit_length())
        pad = keys.max() + 1 + np.arange(npad - n1, dtype=np.int32)
        keysp = np.concatenate([keys, pad]).astype(np.int32)
        sa, ovf = sharded_build_sa_sample(jnp.asarray(keysp), npad, mesh)
        assert int(np.asarray(ovf)) == 0
        ref, _ = build_suffix_array(keys, with_lcp=False)
        assert np.asarray(sa)[:n1].tolist() == np.asarray(ref).tolist()


class TestDistSeedGrid:
    def test_grid_counts_match_host(self):
        from collections import Counter

        from genometools_tpu.match.seed_extend import (enumerate_kmers,
                                                       sequence_ranges)
        from genometools_tpu.parallel.dist_seed_grid import grid_mlistlen
        rng = np.random.default_rng(2)
        pieces = ["".join(rng.choice(list("acgt"), rng.integers(80, 300)))
                  for _ in range(9)]
        e = Encseq.from_string("|".join(pieces))
        k = 8
        alist = enumerate_kmers(e, k, revcomp=False)
        aranges = sequence_ranges(e, 3)
        blists = []
        for lo, hi in aranges:
            m = (alist[1] >= lo) & (alist[1] <= hi)
            blists.append((alist[0][m], alist[1][m], alist[2][m]))
        mesh = make_mesh(8)
        got = grid_mlistlen(alist, blists, aranges, mesh, selfcomp=True)
        # host mirror
        want = []
        for ai, (alo, ahi) in enumerate(aranges):
            for bi in range(ai, len(aranges)):
                cb = Counter(blists[bi][0].tolist())
                am = (alist[1] >= alo) & (alist[1] <= ahi)
                want.append(sum(cb[c] for c in alist[0][am].tolist()))
        assert got.tolist() == want


class TestPairLanes:
    """int32-pair (base-C hi/lo) lanes for >2^31 positions/key values
    (dist_doubling_sharded.sharded_build_sa_sample_pair; the VERDICT's
    'rank-pair int32x2 scheme'). x64 is off, so wide values travel as
    two int32 planes."""

    @pytest.mark.parametrize("n", [40, 253, 1000])
    def test_forced_pair_matches_int32(self, n, monkeypatch):
        from genometools_tpu.parallel.dist_doubling_sharded import \
            sharded_suffix_array
        mesh = make_mesh(8)
        rng = np.random.default_rng(n + 7)
        s = "".join(rng.choice(list("acgtn"), n, p=[0.24] * 4 + [0.04]))
        keys = Encseq.from_string(s).suffix_keys()
        base = sharded_suffix_array(keys, mesh)
        monkeypatch.setenv("GT_TPU_FORCE_PAIR", "1")
        pair = sharded_suffix_array(keys, mesh)
        assert pair.dtype == np.int64
        assert pair.tolist() == base.tolist()

    def test_key_values_beyond_int32(self, monkeypatch):
        # adding a constant to every key preserves all suffix
        # comparisons, so the suffix array is unchanged — but every hi
        # plane is now nonzero and comparisons genuinely need 64 bits
        from genometools_tpu.parallel.dist_doubling_sharded import \
            sharded_suffix_array
        mesh = make_mesh(8)
        rng = np.random.default_rng(99)
        s = "".join(rng.choice(list("acgtn"), 700,
                               p=[0.24] * 4 + [0.04]))
        keys = Encseq.from_string(s).suffix_keys()
        ref, _ = build_suffix_array(keys, with_lcp=False)
        wide = keys.astype(np.int64) + (7 << 32)
        sa = sharded_suffix_array(wide, mesh)
        assert sa.tolist() == np.asarray(ref).tolist()

    def test_repetitive_pair_lanes(self, monkeypatch):
        # rank plateaus stress the ragged dense-ranking carry chain
        from genometools_tpu.parallel.dist_doubling_sharded import \
            sharded_suffix_array
        mesh = make_mesh(8)
        keys = Encseq.from_string("acg" * 700 + "t").suffix_keys()
        monkeypatch.setenv("GT_TPU_FORCE_PAIR", "1")
        sa = sharded_suffix_array(keys, mesh)
        ref, _ = build_suffix_array(keys, with_lcp=False)
        assert sa.tolist() == np.asarray(ref).tolist()

    def test_wide_encseq_keys_dtype(self):
        # the suffix-key contract survives the int64 promotion
        e = Encseq.from_string("acgtnacgt|ggcc")
        k32 = e.suffix_keys()
        # same mapping computed through the wide branch
        import genometools_tpu.core.encseq as em
        c = e.codes_view(0)
        keys = np.empty(c.size + 1, np.int64)
        keys[:c.size] = c
        sp = np.flatnonzero(em.is_special(c))
        keys[sp] = e.alphabet.num_chars + sp
        keys[c.size] = e.alphabet.num_chars + c.size
        assert k32.tolist() == keys.tolist()


class TestDistributedSeedExtend:
    """Mesh-dispatched seed_extend grid (dist_seed_grid.
    distributed_seed_extend): cells fan out over device lanes; output
    must be byte-identical to the single-device grid in cell order
    (the reference's thread-count invariance,
    ref: diagbandseed.c:5982)."""

    def _single(self, e, parts, qenc=None):
        from genometools_tpu.match.seed_extend import (SeedExtendParams,
                                                       seed_extend)
        p = SeedExtendParams(userdefinedleastlength=10, minidentity=80,
                             sensitivity=97, extension="greedy",
                             parts=parts)
        return [m.line() for m in seed_extend(e, qenc, p)]

    def _dist(self, e, parts, qenc=None, ndev=8):
        import jax
        from genometools_tpu.match.seed_extend import SeedExtendParams
        from genometools_tpu.parallel.dist_seed_grid import \
            distributed_seed_extend
        p = SeedExtendParams(userdefinedleastlength=10, minidentity=80,
                             sensitivity=97, extension="greedy",
                             parts=parts)
        return [m.line() for m in distributed_seed_extend(
            e, qenc, p, devices=jax.devices()[:ndev])]

    def test_selfcomp_grid_exact(self, testdata):
        e = Encseq.from_files([str(testdata / "Atinsert.fna")])
        ref = self._single(e, 4)
        assert ref
        assert self._dist(e, 4) == ref

    def test_two_lane_mesh_exact(self, testdata):
        e = Encseq.from_files([str(testdata / "small_poly.fas")])
        ref = self._single(e, 2)
        assert self._dist(e, 2, ndev=2) == ref

    def test_events_order_preserved(self, testdata):
        from genometools_tpu.match.seed_extend import (SeedExtendParams,
                                                       seed_extend)
        from genometools_tpu.parallel.dist_seed_grid import \
            distributed_seed_extend
        e = Encseq.from_files([str(testdata / "Atinsert.fna")])

        def run(fn):
            ev = []
            p = SeedExtendParams(userdefinedleastlength=10,
                                 minidentity=80, sensitivity=97,
                                 extension="greedy", parts=3)
            fn(e, None, p, events=ev)
            return [(x[0],) + tuple(
                getattr(x[1], "line", lambda: x[1:])()
                for _ in (0,)) if x[0] == "match" else x
                for x in ev]

        assert run(seed_extend) == run(distributed_seed_extend)


class TestDistributedReadjoiner:
    """Sharded overlap counting (dist_readjoiner — the firstcodes
    analog, ref: src/match/firstcodes.c pass-A accumulation)."""

    def _readset(self, nreads=60, L=50, seed=3):
        from genometools_tpu.assembly.readjoiner import ReadSet
        rng = np.random.default_rng(seed)
        g = rng.integers(0, 4, 2000).astype(np.uint8)
        reads = []
        for _ in range(nreads):
            s = int(rng.integers(0, g.size - L))
            reads.append(g[s:s + L].copy())
        return ReadSet(reads)

    def _host_count(self, rs, minlen):
        # host mirror of the pass-A candidate count
        from collections import Counter
        n = rs.num_reads
        k = min(minlen, 31)
        lens_f = np.fromiter((len(x) for x in rs.reads), np.int64, n)
        blob_f = np.concatenate(rs.reads)
        lens = np.concatenate([lens_f, lens_f[::-1]])
        blob = np.concatenate([blob_f,
                               (3 - blob_f[::-1]).astype(np.uint8)])
        starts = np.cumsum(lens) - lens
        total = blob.size
        npos = total - k + 1
        wcode = np.zeros(npos, np.int64)
        for j in range(k):
            wcode = wcode * 4 + blob[j:j + npos]
        pc = Counter(wcode[starts[lens >= k]].tolist())
        cnt = 0
        for m, (s, ln) in enumerate(zip(starts, lens)):
            for off in range(0, ln - minlen + 1):
                cnt += pc.get(int(wcode[s + off]), 0)
        return cnt

    def test_count_matches_host_mirror(self):
        from genometools_tpu.parallel.dist_readjoiner import \
            sharded_spm_candidate_count
        rs = self._readset()
        mesh = make_mesh(8)
        got = sharded_spm_candidate_count(rs, 20, mesh)
        assert got == self._host_count(rs, 20)
        assert got > 0

    def test_distributed_find_spms_identical(self):
        from genometools_tpu.assembly.readjoiner import find_spms
        from genometools_tpu.parallel.dist_readjoiner import \
            distributed_find_spms
        rs = self._readset(nreads=120, L=80, seed=9)
        mesh = make_mesh(8)
        ref = find_spms(rs, 30)
        got = distributed_find_spms(rs, 30, mesh)
        assert got.lines() == ref.lines()


class TestDistTallymerMaxpairs:
    def test_sharded_mer_counts(self):
        import numpy as np

        from genometools_tpu.parallel.dist_tallymer import \
            sharded_mer_counts
        rng = np.random.default_rng(3)
        codes = rng.integers(0, 4 ** 9, 50000).astype(np.int64)
        m, c = sharded_mer_counts(codes, 9, make_mesh(8))
        wm, wc = np.unique(codes, return_counts=True)
        assert (m == wm).all() and (c == wc).all()

    def test_sharded_mer_counts_wide_raises(self):
        import numpy as np
        import pytest

        from genometools_tpu.parallel.dist_tallymer import \
            sharded_mer_counts
        with pytest.raises(ValueError):
            sharded_mer_counts(np.zeros(4, np.int64), 19, make_mesh(8))

    def test_distributed_maxpairs(self):
        import numpy as np

        from genometools_tpu.core.encseq import Encseq
        from genometools_tpu.index.esa import build_esa
        from genometools_tpu.match.maxpairs import enumerate_maxpairs
        from genometools_tpu.parallel.dist_maxpairs import \
            distributed_maxpairs
        rng = np.random.default_rng(11)
        s = "".join(rng.choice(list("acgt"), 4000))
        s = s + s[:600]                      # guaranteed repeats
        esa = build_esa(Encseq.from_string(s), 0, with_lcp=True)
        got = distributed_maxpairs(esa, 12, devices=list(range(4)))
        want = enumerate_maxpairs(esa, 12)
        assert got.pos1.tolist() == want.pos1.tolist()
        assert got.pos2.tolist() == want.pos2.tolist()
        assert got.length.tolist() == want.length.tolist()
