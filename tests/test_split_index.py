"""Frequency-split index: exact score/tf parity with the single-table path.

The split (a matmul for frequent terms + narrow compare tail) must be a
pure performance transform — scores and tf counts equal the doc-major
compare path on every query."""

import numpy as np
import pytest

from bayesian_bm25_tpu.engine import index as eidx, scoring
from bayesian_bm25_tpu.engine import split_index as sidx


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    V, D, L = 800, 300, 60
    corpus = [[f"t{t}" for t in rng.zipf(1.4, size=L) % V] for _ in range(D)]
    idx = eidx.build_index(corpus, doc_pad_multiple=8, pad_multiple=8)
    queries = [
        [f"t{t}" for t in rng.zipf(1.4, size=6) % V] for _ in range(24)
    ] + [["t1", "t1", "t2"], [f"t{V-1}"], [], ["zzz-oov"]]
    return idx, queries


class TestSplitParity:
    @pytest.mark.parametrize("n_frequent", [128, 256, 100000])
    def test_scores_and_tfs_match(self, setup, n_frequent):
        idx, queries = setup
        split = sidx.build_split_index(idx, n_frequent=n_frequent)
        qids, qcnt = eidx.encode_queries(queries, idx.vocab)
        s_old, t_old = scoring.score_all_xla(idx.term_ids, idx.weights,
                                             qids, qcnt)
        enc = sidx.encode_queries_split(queries, split)
        s_new, t_new = sidx.score_all_split(split, *enc)
        np.testing.assert_allclose(
            np.asarray(s_new), np.asarray(s_old), rtol=2e-4, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(t_new), np.asarray(t_old))

    def test_retrieve_matches(self, setup):
        idx, queries = setup
        split = sidx.build_split_index(idx, n_frequent=256)
        qids, qcnt = eidx.encode_queries(queries, idx.vocab)
        old = scoring.retrieve_topk(
            idx.term_ids, idx.weights, idx.doc_lengths, idx.avgdl,
            qids, qcnt, 5, 1.0, 2.0, 0.05, n_docs=idx.n_docs)
        enc = sidx.encode_queries_split(queries, split)
        new = sidx.retrieve_topk_split(
            split.dense_impact, split.dense_presence, split.tail_term_ids,
            split.tail_weights, idx.doc_lengths, idx.avgdl, *enc, 5,
            1.0, 2.0, 0.05, n_docs=idx.n_docs,
            overflow=sidx._overflow_of(split))
        np.testing.assert_allclose(
            np.asarray(new[2]), np.asarray(old[2]), rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(new[1]), np.asarray(old[1]), rtol=2e-4, atol=1e-5)

    def test_probabilities_all_matches(self, setup):
        idx, queries = setup
        split = sidx.build_split_index(idx, n_frequent=256)
        qids, qcnt = eidx.encode_queries(queries, idx.vocab)
        p_old, _, _ = scoring.probabilities_all(
            idx.term_ids, idx.weights, idx.doc_lengths, idx.avgdl,
            qids, qcnt, 1.0, 2.0, 0.05, n_docs=idx.n_docs)
        enc = sidx.encode_queries_split(queries, split)
        p_new = sidx.probabilities_all_split(
            split.dense_impact, split.dense_presence, split.tail_term_ids,
            split.tail_weights, idx.doc_lengths, idx.avgdl, *enc,
            1.0, 2.0, 0.05, n_docs=idx.n_docs,
            overflow=sidx._overflow_of(split))
        np.testing.assert_allclose(
            np.asarray(p_new), np.asarray(p_old), rtol=2e-4, atol=1e-6)

    def test_idf_zero_frequent_term_counts_in_tf(self, setup):
        """A frequent term with weight 0 still counts toward |q ∩ doc|."""
        corpus = [["common", f"u{i}"] for i in range(20)]
        idx = eidx.build_index(corpus, doc_pad_multiple=8, pad_multiple=8,
                               method="robertson")  # idf('common') floors to 0
        split = sidx.build_split_index(idx, n_frequent=128)
        enc = sidx.encode_queries_split([["common", "u3"]], split)
        s, t = sidx.score_all_split(split, *enc)
        tf = np.asarray(t)[0]
        assert tf[3] == 2.0  # both terms present
        assert tf[0] == 1.0  # only 'common'


class TestScorerUsesSplit:
    def test_scorer_split_consistency(self):
        from bayesian_bm25_tpu import BayesianBM25Scorer

        rng = np.random.default_rng(1)
        corpus = [[f"t{t}" for t in rng.zipf(1.4, size=40) % 600]
                  for _ in range(200)]
        s = BayesianBM25Scorer(base_rate=0.05)
        s.index(corpus, show_progress=False)
        assert s._split is not None  # 600 terms > 256 threshold
        queries = [corpus[3][:4], ["t1"]]
        ids, probs = s.retrieve(queries, k=5)
        # compare against the non-split path
        s._split = None
        ids2, probs2 = s.retrieve(queries, k=5)
        np.testing.assert_allclose(probs, probs2, rtol=2e-4, atol=1e-6)
        dense1 = None
        s._maybe_build_split()
        dense1 = s.get_probabilities_batch(queries)
        s._split = None
        dense2 = s.get_probabilities_batch(queries)
        np.testing.assert_allclose(dense1, dense2, rtol=2e-4, atol=1e-6)


class TestOverflowTail:
    def test_overflow_table_built_and_exact(self):
        """A corpus with one rare-term-heavy outlier doc uses the overflow
        level and still matches the compare path exactly."""
        rng = np.random.default_rng(9)
        corpus = [[f"t{t}" for t in rng.zipf(1.4, size=30) % 400]
                  for _ in range(100)]
        # outlier: many distinct ultra-rare terms
        corpus[7] = [f"rare{i}" for i in range(60)]
        idx = eidx.build_index(corpus, doc_pad_multiple=8, pad_multiple=8)
        split = sidx.build_split_index(idx, n_frequent=128,
                                       enable_overflow=True)
        assert split.over_term_ids is not None
        queries = [["rare3", "rare55", "t2"], corpus[5][:4]]
        qids, qcnt = eidx.encode_queries(queries, idx.vocab)
        s_old, t_old = scoring.score_all_xla(idx.term_ids, idx.weights,
                                             qids, qcnt)
        enc = sidx.encode_queries_split(queries, split)
        s_new, t_new = sidx.score_all_split(split, *enc)
        np.testing.assert_allclose(np.asarray(s_new), np.asarray(s_old),
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(t_new), np.asarray(t_old))

    def test_disable_overflow(self):
        rng = np.random.default_rng(10)
        corpus = [[f"t{t}" for t in rng.zipf(1.4, size=30) % 400]
                  for _ in range(64)]
        corpus[3] = [f"rare{i}" for i in range(50)]
        idx = eidx.build_index(corpus, doc_pad_multiple=8, pad_multiple=8)
        split = sidx.build_split_index(idx, n_frequent=128,
                                       enable_overflow=False)
        assert split.over_term_ids is None


class TestTfFromSign:
    """The sign-derived tf payload (two-operand merge sort) must be a
    pure perf transform: bit-identical retrieval when all posting
    weights are positive, and build_split_index must only set the flag
    in that case."""

    def _sparse_args(self, idx, split, queries, k=7):
        import jax.numpy as jnp

        enc = sidx.encode_queries_split(queries, split)
        fslots, fcnt, trows, tqids, tqcnt = enc
        tslots = sidx.map_tail_slots(tqids, split)
        cap = sidx.candidate_cap(split, tslots, k)
        common = (split.dense_impact, split.dense_presence,
                  split.post_doc_ids, split.post_weights,
                  idx.doc_lengths, idx.avgdl,
                  jnp.asarray(fslots), jnp.asarray(fcnt),
                  jnp.asarray(trows), jnp.asarray(tslots),
                  jnp.asarray(tqcnt), k, cap, 1.0, 2.0, 0.05)
        return common, dict(n_docs=idx.n_docs,
                            impact_lo=split.dense_impact_lo)

    def test_flag_set_on_positive_weights(self, setup):
        idx, _ = setup
        split = sidx.build_split_index(idx, n_frequent=256)
        if split.post_doc_ids is None:
            pytest.skip("no rare postings")
        assert split.post_w_positive is True

    def test_bit_identical_on_and_off(self, setup):
        idx, queries = setup
        split = sidx.build_split_index(idx, n_frequent=256)
        if split.post_doc_ids is None:
            pytest.skip("no rare postings")
        common, kw = self._sparse_args(idx, split, queries)
        out0 = sidx.retrieve_topk_split_sparse(
            *common, **kw, tf_from_sign=False)
        out1 = sidx.retrieve_topk_split_sparse(
            *common, **kw, tf_from_sign=True)
        for a, b in zip(out0, out1):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_zero_weight_corpus_disables_flag(self):
        """Robertson IDF floors at 0 for df > N/2; a zero-weight rare
        posting is sign-invisible, so the builder must keep the explicit
        tf sort operand in that case."""
        corpus = [["c1"] + (["c2"] if i < 6 else []) + [f"u{i}"]
                  for i in range(8)]
        idx = eidx.build_index(corpus, method="robertson",
                               doc_pad_multiple=8, pad_multiple=8)
        split = sidx.build_split_index(idx, n_frequent=1)
        if split.post_doc_ids is None:
            pytest.skip("no rare postings")
        pw = np.asarray(split.post_weights)
        real = pw[np.asarray(split.post_doc_ids) < idx.n_docs]
        if (real > 0).all():
            pytest.skip("zero-weight term not in rare postings")
        assert split.post_w_positive is False


class TestCompactBuild:
    """The gather+scatter candidate build (compact_tail_postings) must
    reproduce the dense post_ids[tail_slots] build bit-for-bit: empty
    grid cells reconstruct the sentinel row's id-D_pad/weight-0 content,
    so every downstream stage (sort, merge, top-k) sees identical
    inputs."""

    @pytest.mark.parametrize("tf_from_sign", [True, False])
    def test_bit_identical_to_dense_build(self, setup, tf_from_sign):
        import jax.numpy as jnp
        idx, queries = setup
        split = sidx.build_split_index(idx, n_frequent=256)
        if split.post_doc_ids is None:
            pytest.skip("no rare postings")
        enc = sidx.encode_queries_split(queries, split)
        fslots, fcnt, trows, tqids, tqcnt = enc
        tslots = sidx.map_tail_slots(tqids, split)
        cap = sidx.candidate_cap(split, tslots, 7)
        R = split.post_doc_ids.shape[0] - 1
        packed, r_max = sidx.compact_tail_postings(tslots, tqcnt, R)
        assert r_max < tslots.shape[1]  # fixture must exercise packing
        common = (split.dense_impact, split.dense_presence,
                  split.post_doc_ids, split.post_weights,
                  idx.doc_lengths, idx.avgdl,
                  jnp.asarray(fslots), jnp.asarray(fcnt),
                  jnp.asarray(trows), jnp.asarray(tslots),
                  jnp.asarray(tqcnt), 7, cap, 1.0, 2.0, 0.05)
        kw = dict(n_docs=idx.n_docs, impact_lo=split.dense_impact_lo,
                  tf_from_sign=tf_from_sign and split.post_w_positive)
        dense = sidx.retrieve_topk_split_sparse(*common, **kw)
        comp = sidx.retrieve_topk_split_sparse(
            *common, **kw, compact=jnp.asarray(packed),
            compact_rmax=r_max)
        for a, b in zip(dense, comp):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_compaction_layout(self):
        tslots = np.array([[3, 9, 9], [9, 9, 9], [0, 1, 9]], np.int32)
        qcnt = np.array([[2., 0., 0.], [0., 0., 0.], [1., 3., 0.]],
                        np.float32)
        packed, r_max = sidx.compact_tail_postings(tslots, qcnt, R=9)
        fs, fd = packed[0], packed[1]
        # counts travel as plain int32 (widened to f32 on device) so the
        # whole batch can pack into one int16 ship_arrays buffer
        fq = packed[2].astype(np.float32)
        assert r_max == 2  # row 2 has two real terms
        assert len(fs) == 64  # pow2 bucket floor
        np.testing.assert_array_equal(fs[:3], [3, 0, 1])
        # rank-packed destinations: row*r_max + rank
        np.testing.assert_array_equal(fd[:3], [0, 4, 5])
        np.testing.assert_array_equal(fq[:3], [2., 1., 3.])
        assert (fs[3:] == 9).all() and (fd[3:] == 6).all()
        assert (fq[3:] == 0).all()


class TestCompactBuildFuzz:
    """Multi-seed randomized bit-parity of the packed candidate build:
    random corpus shapes, query mixes (empty/OOV/heavy-rare), ks, and
    caps — every output must equal the dense build bit-for-bit."""

    @pytest.mark.parametrize("seed", [11, 23, 37, 51])
    def test_random_regimes(self, seed):
        import jax.numpy as jnp
        rng = np.random.default_rng(seed)
        n_docs = int(rng.integers(150, 700))
        vocab = int(rng.integers(300, 3000))
        corpus = [[f"t{t}" for t in rng.zipf(1.3 + 0.2 * rng.random(),
                                             size=rng.integers(3, 50))
                   % vocab] for _ in range(n_docs)]
        idx = eidx.build_index(corpus)
        split = sidx.build_split_index(
            idx, n_frequent=int(rng.choice([128, 256, 512])))
        if split.post_doc_ids is None:
            pytest.skip("no rare postings at this draw")
        nq = int(rng.integers(2, 20))
        queries = [[f"t{t}" for t in rng.zipf(1.35, size=rng.integers(1, 9))
                    % vocab] for _ in range(nq)]
        queries += [[], ["zz_oov"]]
        k = int(rng.integers(1, 12))
        enc = sidx.encode_queries_split(queries, split)
        fslots, fcnt, trows, tqids, tqcnt = enc
        tslots = sidx.map_tail_slots(tqids, split)
        cap = sidx.candidate_cap(split, tslots, k)
        R = split.post_doc_ids.shape[0] - 1
        packed, r_max = sidx.compact_tail_postings(tslots, tqcnt, R)
        common = (split.dense_impact, split.dense_presence,
                  split.post_doc_ids, split.post_weights,
                  idx.doc_lengths, idx.avgdl,
                  jnp.asarray(fslots), jnp.asarray(fcnt),
                  jnp.asarray(trows), jnp.asarray(tslots),
                  jnp.asarray(tqcnt), k, cap, 1.0, 2.0, 0.05)
        kw = dict(n_docs=idx.n_docs, impact_lo=split.dense_impact_lo,
                  tf_from_sign=split.post_w_positive)
        dense = sidx.retrieve_topk_split_sparse(*common, **kw)
        comp = sidx.retrieve_topk_split_sparse(
            *common, **kw, compact=jnp.asarray(packed),
            compact_rmax=r_max)
        for a, b in zip(dense, comp):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestPackedBuildScorerPath:
    """End-to-end scorer retrieval must be identical with the packed
    candidate build on and off (the flag only changes the build
    layout)."""

    def test_retrieve_equal_packed_on_off(self, monkeypatch):
        from bayesian_bm25_tpu import BayesianBM25Scorer

        rng = np.random.default_rng(7)
        corpus = [[f"t{t}" for t in rng.zipf(1.35, size=40) % 2000]
                  for _ in range(600)]
        queries = [[f"t{t}" for t in rng.zipf(1.35, size=5) % 2000]
                   for _ in range(12)] + [[], ["t1999"]]
        s = BayesianBM25Scorer(base_rate=0.02)
        s.index(corpus, show_progress=False)
        if s._split is None or s._split.post_doc_ids is None:
            pytest.skip("sparse path not engaged at this scale")
        monkeypatch.setattr(sidx, "PACKED_BUILD", False)
        ids0, probs0 = s.retrieve(queries, k=8)
        monkeypatch.setattr(sidx, "PACKED_BUILD", True)
        ids1, probs1 = s.retrieve(queries, k=8)
        np.testing.assert_array_equal(np.asarray(ids0), np.asarray(ids1))
        np.testing.assert_array_equal(np.asarray(probs0),
                                      np.asarray(probs1))


class TestLeanWinnerTf:
    """retrieve_topk_split without an overflow table reconstructs tf
    only at the winners; must be bit-equal to the dense compare path."""

    def test_tf_and_probs_match_compare_kernel(self, setup):
        idx, queries = setup
        split = sidx.build_split_index(idx, n_frequent=256,
                                       enable_overflow=False)
        assert split.over_term_ids is None
        qids, qcnt = eidx.encode_queries(queries, idx.vocab)
        old = scoring.retrieve_topk(
            idx.term_ids, idx.weights, idx.doc_lengths, idx.avgdl,
            qids, qcnt, 7, 1.0, 2.0, 0.05, n_docs=idx.n_docs)
        enc = sidx.encode_queries_split(queries, split)
        new = sidx.retrieve_topk_split(
            split.dense_impact, split.dense_presence,
            split.tail_term_ids, split.tail_weights, idx.doc_lengths,
            idx.avgdl, *enc, 7, 1.0, 2.0, 0.05, n_docs=idx.n_docs,
            overflow=None)
        np.testing.assert_array_equal(np.asarray(new[0]),
                                      np.asarray(old[0]))
        np.testing.assert_array_equal(np.asarray(new[3]),
                                      np.asarray(old[3]))  # tf exact
        np.testing.assert_allclose(np.asarray(new[1]),
                                   np.asarray(old[1]),
                                   rtol=2e-4, atol=1e-5)

    def test_doc_mask_still_exact(self, setup):
        idx, queries = setup
        split = sidx.build_split_index(idx, n_frequent=256,
                                       enable_overflow=False)
        rng = np.random.default_rng(4)
        mask = rng.uniform(size=idx.n_docs) < 0.5
        import jax.numpy as jnp
        enc = sidx.encode_queries_split(queries, split)
        out = sidx.retrieve_topk_split(
            split.dense_impact, split.dense_presence,
            split.tail_term_ids, split.tail_weights, idx.doc_lengths,
            idx.avgdl, *enc, 5, 1.0, 2.0, 0.05, n_docs=idx.n_docs,
            overflow=None, doc_mask=jnp.asarray(mask))
        ids = np.asarray(out[0])
        assert (mask[ids[ids >= 0]]).all()


class TestShipArrays:
    """ship_arrays: the packed one-buffer host->device transfer must
    reconstruct every operand exactly (shapes, dtypes, values) for both
    the int16 fast path and the int32 fallback."""

    def test_int16_pack_roundtrip(self):
        rng = np.random.default_rng(0)
        arrs = [
            rng.integers(-2, 2000, size=(16, 8)).astype(np.int32),
            rng.integers(0, 9, size=(16, 8)).astype(np.float32),
            rng.integers(0, 16, size=(4,)).astype(np.int32),
            np.array([[-2, 31000], [7, -1]], np.int32),
            rng.integers(0, 5, size=(4, 2)).astype(np.float32),
        ]
        out = sidx.ship_arrays(arrs)
        assert len(out) == len(arrs)
        for a, o in zip(arrs, out):
            assert np.asarray(o).dtype == a.dtype
            np.testing.assert_array_equal(np.asarray(o), a)

    def test_int32_fallback(self):
        # a value beyond int16 forces the int32 buffer
        arrs = [np.array([1, 70000, -3], np.int32),
                np.array([[2.0, 40000.0]], np.float32)]
        out = sidx.ship_arrays(arrs)
        np.testing.assert_array_equal(np.asarray(out[0]), arrs[0])
        np.testing.assert_array_equal(np.asarray(out[1]), arrs[1])

    def test_empty_list(self):
        assert sidx.ship_arrays([]) == ()
