"""int8 impact storage: (hi, lo) int8 pair + per-doc scales.

Scoring under ``storage="int8"`` runs two int8 x int8 -> int32 dot
passes (integer GEMMs, exact int32 accumulation) with the per-doc
scales applied in the epilogue: score_d = s_d*hidot_d + s2_d*lodot_d.
Error class: ABSOLUTE per doc row (<= ~amax_d/64500 per element), so
score-relative error stays ~1e-4 even for docs whose matched weights
are far below their max weight — an order sharper than single-bf16
storage's ~4e-3-relative class at the same 2 bytes/element.

The one behavioral difference vs f32/hilo: EXACT cross-doc score ties
can quantize apart (per-doc scales differ), so tie ORDER may diverge
from the lowest-id contract; the selected set stays value-correct.
Reference numeric contract: SURVEY.md section 2.4."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bayesian_bm25_tpu import BayesianBM25Scorer
from bayesian_bm25_tpu.engine import split_index as sidx


def _corpus(rng, n_docs=700, vocab=1800, lmin=8, lmax=60):
    # Varied doc lengths: exercises the doc-length factor and keeps
    # cross-doc ties rare (as in real corpora).
    return [[f"t{t}" for t in rng.zipf(1.35, size=rng.integers(lmin, lmax))
             % vocab] for _ in range(n_docs)]


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(29)
    corpus = _corpus(rng)
    queries = [[f"t{t}" for t in rng.zipf(1.35, size=5) % 1800]
               for _ in range(24)] + [[], ["t1799"], ["zzz_oov"]]
    ref = BayesianBM25Scorer(base_rate=0.02, matmul_precision="highest")
    ref.index(corpus, show_progress=False)
    i8 = BayesianBM25Scorer(base_rate=0.02, impact_storage="int8")
    i8.index(corpus, show_progress=False)
    return ref, i8, corpus, queries


class TestQuantization:
    def test_int8_engages(self, pair):
        _, i8, _, _ = pair
        s = i8._split
        assert s.impact_scale is not None
        assert s.dense_impact.dtype == jnp.int8
        assert s.dense_impact_lo.dtype == jnp.int8
        assert s.impact_scale.shape == (2, s.dense_impact.shape[0])

    def test_elementwise_bound(self, pair):
        """Dequantized matrix within amax_d/64500 of the f32 impact:
        |w - (s*hi + s2*lo)| <= s2/2, s2 <= s/254 (+ rounding eps)."""
        ref, i8, _, _ = pair
        w_ref = np.asarray(ref._split.dense_impact, np.float32)
        s = i8._split
        sc = np.asarray(s.impact_scale)
        deq = (np.asarray(s.dense_impact, np.float32) * sc[0][:, None]
               + np.asarray(s.dense_impact_lo, np.float32)
               * sc[1][:, None])
        err = np.abs(deq - w_ref)
        # s2/2 rounding + f32 eps of the two scale products
        bound = (sc[1][:, None] * 0.505
                 + np.abs(w_ref) * 1e-6 + 1e-12)
        assert (err <= bound).all()
        amax = np.abs(w_ref).max(axis=1)
        m = amax > 0
        assert (err[m].max(axis=1) <= amax[m] / 5.9e4 + 1e-12).all()

    def test_bad_storage_rejected(self):
        with pytest.raises(ValueError):
            BayesianBM25Scorer(impact_storage="int4")
        rng = np.random.default_rng(0)
        idx_corpus = _corpus(rng, n_docs=50, vocab=300)
        s = BayesianBM25Scorer()
        s.index(idx_corpus, show_progress=False)
        with pytest.raises(ValueError):
            sidx.build_split_index(s._index, n_frequent=128,
                                   storage="fp8")


class TestScoreParity:
    def test_score_relative_error(self, pair):
        ref, i8, _, queries = pair
        enc = sidx.encode_queries_split(queries, ref._split)
        s_ref = np.asarray(sidx.score_all_split(
            ref._split, *enc,
            precision=jax.lax.Precision.HIGHEST)[0])
        enc8 = sidx.encode_queries_split(queries, i8._split)
        s_i8 = np.asarray(sidx.score_all_split(i8._split, *enc8)[0])
        m = np.abs(s_ref) > 1e-3
        rel = np.abs(s_i8[m] - s_ref[m]) / np.abs(s_ref[m])
        # Error is absolute-per-doc (<= amax_d/64500 per element), so a
        # doc matched only on weights far below its max weight can see
        # ~1e-3 score-relative deviation; typical is ~1e-5.
        assert rel.max() < 5e-3
        assert rel.mean() < 2e-4

    def test_retrieval_value_correct(self, pair):
        """Any id disagreement with the exact path must be an exact tie
        in TRUE score: the int8 top-k set is value-identical."""
        ref, i8, _, queries = pair
        enc = sidx.encode_queries_split(queries, ref._split)
        s_ref = np.asarray(sidx.score_all_split(
            ref._split, *enc,
            precision=jax.lax.Precision.HIGHEST)[0])
        ids_r, _ = ref.retrieve(queries, k=10)
        ids_8, probs_8 = i8.retrieve(queries, k=10)
        ids_r, ids_8 = np.asarray(ids_r), np.asarray(ids_8)
        probs_8 = np.asarray(probs_8)
        for q in range(len(queries)):
            a = set(ids_r[q]) - set(ids_8[q]) - {-1}
            b = set(ids_8[q]) - set(ids_r[q]) - {-1}
            assert len(a) == len(b)
            if not a:
                continue
            sa = sorted(float(s_ref[q, d]) for d in a)
            sb = sorted(float(s_ref[q, d]) for d in b)
            # exact ties (gap 0) or near-ties inside the quantization
            # error class may swap; anything larger is a real bug
            np.testing.assert_allclose(sa, sb, rtol=2e-3)
        # winners with clearly positive true scores carry probabilities
        # in (0,1); zero-score winners (empty/OOV rows) zero out just
        # like the exact path
        pos = s_ref[np.arange(len(queries))[:, None],
                    np.maximum(ids_8, 0)] > 1e-6
        sel = pos & (ids_8 >= 0)
        assert ((probs_8 > 0) & (probs_8 < 1))[sel].all()

    def test_tf_and_dead_slots(self, pair):
        """tf/presence math is exact under int8 storage (presence stays
        bf16 0/1); empty/OOV queries behave exactly like the exact
        path (zero probabilities, same id filling)."""
        ref, i8, corpus, _ = pair
        q = [corpus[5][:4], [], ["zzz_oov"]]
        ids, probs = map(np.asarray, i8.retrieve(q, k=5))
        r_ids, r_probs = map(np.asarray, ref.retrieve(q, k=5))
        assert (probs[1] == 0).all() and (probs[2] == 0).all()
        np.testing.assert_array_equal(ids[1:], r_ids[1:])
        np.testing.assert_array_equal(probs[1:], r_probs[1:])
        assert r_ids[0, 0] == ids[0, 0]


class TestCountFallback:
    def test_query_count_over_127(self, pair):
        """Counts beyond int8 route to the dequantizing f32 fallback;
        results stay in the same tolerance class."""
        ref, i8, corpus, _ = pair
        big = [["t7"] * 200 + corpus[3][:3], corpus[8][:5]]
        assert not sidx._q_int8_ok(
            i8._split, sidx.encode_queries_split(big, i8._split)[1])
        ids_r, _ = ref.retrieve(big, k=5)
        ids_8, _ = i8.retrieve(big, k=5)
        np.testing.assert_array_equal(np.asarray(ids_r)[:, 0],
                                      np.asarray(ids_8)[:, 0])

    def test_flag_true_for_normal_batches(self, pair):
        _, i8, corpus, _ = pair
        enc = sidx.encode_queries_split([corpus[0][:5]], i8._split)
        assert sidx._q_int8_ok(i8._split, enc[1])


class TestGetProbabilities:
    def test_dense_probs_close(self, pair):
        ref, i8, corpus, _ = pair
        q = [corpus[2][:5], corpus[9][:3]]
        p_ref = np.asarray(ref.get_probabilities_batch(q))
        p_i8 = np.asarray(i8.get_probabilities_batch(q))
        np.testing.assert_allclose(p_i8, p_ref, rtol=2e-2, atol=1e-5)


class TestCheckpoint:
    def test_kernel_cfg_round_trip(self, pair, tmp_path):
        from bayesian_bm25_tpu.utils.io import load_scorer, save_scorer
        _, i8, corpus, queries = pair
        path = str(tmp_path / "i8.npz")
        save_scorer(path, i8)
        s2 = load_scorer(path)
        assert s2._impact_storage == "int8"
        assert s2._split.impact_scale is not None
        ids_a, probs_a = i8.retrieve(queries, k=8)
        ids_b, probs_b = s2.retrieve(queries, k=8)
        np.testing.assert_array_equal(np.asarray(ids_a),
                                      np.asarray(ids_b))
        np.testing.assert_array_equal(np.asarray(probs_a),
                                      np.asarray(probs_b))

    def test_precision_round_trip(self, tmp_path):
        from bayesian_bm25_tpu.utils.io import load_scorer, save_scorer
        rng = np.random.default_rng(3)
        s = BayesianBM25Scorer(matmul_precision="highest")
        s.index(_corpus(rng, n_docs=80, vocab=400), show_progress=False)
        path = str(tmp_path / "hp.npz")
        save_scorer(path, s)
        assert load_scorer(path)._matmul_precision_name == "highest"


class TestInt8PublicPaths:
    """The remaining public entry points under int8 storage: thresholded
    (self-consistent counts), explain traces, approx, doc_mask,
    retrieve_many."""

    def test_thresholded_self_consistent(self, pair):
        _, i8, corpus, _ = pair
        q = [corpus[4][:5], corpus[9][:4]]
        ids, probs, n_pass = i8.retrieve_thresholded(
            q, threshold=1e-3, k=10)
        dense = i8.get_probabilities_batch(q)
        np.testing.assert_array_equal(
            n_pass, (dense >= 1e-3).sum(axis=1))
        for r in range(len(q)):
            got = [p for p in probs[r] if p > 0]
            assert all(p >= 1e-3 for p in got)

    def test_explain_approx_mask_many(self, pair):
        _, i8, corpus, _ = pair
        q = [corpus[6][:5]]
        res = i8.retrieve(q, k=4, explain=True)
        assert res.explanations[0][0] is not None
        ids_a, _ = i8.retrieve(q, k=4, approx=True)
        assert np.asarray(ids_a).shape == (1, 4)
        mask = np.ones(i8.num_docs, bool)
        mask[int(np.asarray(ids_a)[0, 0])] = False
        ids_m, _ = i8.retrieve(q, k=4, doc_mask=mask)
        assert int(np.asarray(ids_a)[0, 0]) not in set(
            np.asarray(ids_m)[0].tolist())
        outs = i8.retrieve_many([q, q], k=4)
        np.testing.assert_array_equal(np.asarray(outs[0][0]),
                                      np.asarray(outs[1][0]))


class TestRankingMetricInvariance:
    def test_mini_beir_ndcg_unchanged(self):
        """Retrieval-quality invariance on the checked-in mini-BEIR
        fixture: NDCG@5 under int8 storage equals the exact-storage
        run to 1e-9 (int8's absolute-per-doc error only re-orders
        exact ties, which NDCG scores identically)."""
        import os
        import sys
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "benchmarks"))
        from benchmarks.hybrid_beir import load_beir_dataset
        from benchmarks.metrics import evaluate_run
        from bayesian_bm25_tpu.engine.tokenize import tokenize_texts

        root = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "benchmarks", "data",
            "mini_beir")
        if not os.path.isdir(root):
            pytest.skip("mini_beir fixture missing")
        ds = load_beir_dataset(root)
        doc_ids = list(ds.corpus.keys())
        corpus_tokens = tokenize_texts(
            [ds.corpus[d] for d in doc_ids], stem="snowball")
        qids = list(ds.queries.keys())
        query_tokens = tokenize_texts(
            [ds.queries[q] for q in qids], stem="snowball")

        ndcg = {}
        for storage in ("highest", "int8"):
            kw = (dict(matmul_precision="highest") if storage == "highest"
                  else dict(impact_storage="int8"))
            s = BayesianBM25Scorer(base_rate="auto", **kw)
            s.index(corpus_tokens, show_progress=False)
            ids, probs = s.retrieve(query_tokens, k=5)
            ids, probs = np.asarray(ids), np.asarray(probs)
            run = {
                q: {doc_ids[d]: float(probs[i, r])
                    for r, d in enumerate(ids[i]) if d >= 0}
                for i, q in enumerate(qids)
            }
            ndcg[storage] = evaluate_run(run, ds.qrels, k=5)["ndcg@5"]
        assert ndcg["int8"] == pytest.approx(ndcg["highest"], abs=1e-9)


@pytest.mark.skipif(len(jax.devices()) < 8,
                    reason="needs 8 virtual devices")
class TestShardedInt8:
    """Sharded int8 vs single-chip int8: ids/ordering/scores bit-exact
    (integer dots are order-free, so per-shard score slabs match the
    single-chip columns bit-for-bit — stronger than the last-ulp story
    of the float storages); probabilities to last-ulp (scalar
    operands)."""

    def _pair(self, rng):
        from bayesian_bm25_tpu import ShardedBayesianBM25Scorer
        corpus = _corpus(rng, n_docs=300, vocab=500)
        single = BayesianBM25Scorer(base_rate="auto",
                                    impact_storage="int8")
        single.index(corpus, show_progress=False)
        sh8 = ShardedBayesianBM25Scorer(
            base_rate="auto", n_devices=8, impact_storage="int8")
        sh8.index(corpus, show_progress=False)
        return single, sh8, corpus

    def test_retrieve_bit_exact(self):
        rng = np.random.default_rng(17)
        single, sh8, corpus = self._pair(rng)
        assert sh8._split.impact_scale is not None
        queries = [corpus[i][:5] for i in range(0, 50, 7)]
        queries += [[], ["zzz_oov"], ["t7"] * 200]  # incl. int8 fallback
        ids_a, probs_a = single.retrieve(queries, k=7)
        ids_b, probs_b = sh8.retrieve(queries, k=7)
        # ids/ordering exact (integer dots are order-free, so per-shard
        # score slabs match the single-chip columns bit-for-bit);
        # probabilities agree to last-ulp — the sharded bodies take
        # alpha/beta as f32 operands rather than baked constants.
        np.testing.assert_array_equal(np.asarray(ids_a),
                                      np.asarray(ids_b))
        np.testing.assert_allclose(np.asarray(probs_a),
                                   np.asarray(probs_b), rtol=5e-7)

    def test_scores_bit_exact(self):
        rng = np.random.default_rng(23)
        single, sh8, corpus = self._pair(rng)
        queries = [corpus[i][:4] for i in range(0, 30, 5)]
        a = single.get_scores_batch(queries)
        b = sh8.get_scores_batch(queries)
        np.testing.assert_array_equal(a, b)

    def test_2d_mesh_int8(self):
        from bayesian_bm25_tpu import ShardedBayesianBM25Scorer
        rng = np.random.default_rng(31)
        corpus = _corpus(rng, n_docs=300, vocab=500)
        single = BayesianBM25Scorer(base_rate="auto",
                                    impact_storage="int8")
        single.index(corpus, show_progress=False)
        sh = ShardedBayesianBM25Scorer(
            base_rate="auto", mesh_shape=(2, 4), impact_storage="int8")
        sh.index(corpus, show_progress=False)
        queries = [corpus[i][:5] for i in range(0, 40, 7)]
        ids_a, probs_a = single.retrieve(queries, k=6)
        ids_b, probs_b = sh.retrieve(queries, k=6)
        np.testing.assert_array_equal(np.asarray(ids_a),
                                      np.asarray(ids_b))
        np.testing.assert_allclose(np.asarray(probs_a),
                                   np.asarray(probs_b), rtol=1e-6)
