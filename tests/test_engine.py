"""BM25 engine tests: score parity with a brute-force oracle, tf counts,
variants, and query encoding."""

import numpy as np
import pytest

from bayesian_bm25_tpu.engine import index as eidx
from bayesian_bm25_tpu.engine import scoring


def brute_force_bm25(corpus, query, k1=1.2, b=0.75, method="robertson"):
    """Straightforward reference BM25 (per module formula docstring)."""
    n = len(corpus)
    dl = np.array([len(d) for d in corpus], dtype=float)
    avgdl = dl.mean()
    df = {}
    for doc in corpus:
        for t in set(doc):
            df[t] = df.get(t, 0) + 1
    scores = np.zeros(n)
    for d_i, doc in enumerate(corpus):
        for q_tok in query:  # multiplicity counts
            tf = doc.count(q_tok)
            if tf == 0 or q_tok not in df:
                continue
            idf = eidx.compute_idf(np.array([df[q_tok]]), n, method)[0]
            K = k1 * (1 - b + b * dl[d_i] / avgdl)
            sat = tf / (tf + K)
            if method in ("robertson", "atire"):
                sat *= (k1 + 1)
            scores[d_i] += idf * sat
    return scores


CORPUS = [
    "the quick brown fox jumps over the lazy dog".split(),
    "a fast auburn fox leaped over a sleepy canine".split(),
    "the dog barked at the mailman all day long".split(),
    "foxes are wild animals related to dogs and wolves".split(),
    "quick reflexes help the fox escape the hunter".split(),
    "the cat sat on the mat".split(),
]


class TestIndexBuild:
    def test_stats(self):
        idx = eidx.build_index(CORPUS)
        assert idx.n_docs == 6
        assert idx.avgdl == pytest.approx(np.mean([len(d) for d in CORPUS]))
        assert idx.n_terms == len({t for d in CORPUS for t in d})
        # padded shapes
        assert idx.term_ids.shape[0] % 512 == 0
        assert idx.term_ids.shape[1] % 128 == 0

    def test_df_counts(self):
        idx = eidx.build_index(CORPUS)
        assert idx.doc_frequencies[idx.vocab["the"]] == 4
        assert idx.doc_frequencies[idx.vocab["fox"]] == 3

    def test_empty_corpus_raises(self):
        with pytest.raises(ValueError):
            eidx.build_index([])

    def test_invalid_method(self):
        with pytest.raises(ValueError):
            eidx.build_index(CORPUS, method="bm25plus")


class TestScoringParity:
    @pytest.mark.parametrize("method", ["robertson", "lucene", "atire"])
    def test_matches_brute_force(self, method):
        idx = eidx.build_index(CORPUS, method=method)
        queries = [
            "quick fox".split(),
            "the the dog".split(),  # duplicate query term
            "sleepy canine mailman".split(),
            ["unseenword"],
        ]
        qids, qcnt = eidx.encode_queries(queries, idx.vocab)
        scores, _ = scoring.score_all_xla(idx.term_ids, idx.weights, qids, qcnt)
        scores = np.asarray(scores)[:, : idx.n_docs]
        for i, q in enumerate(queries):
            expected = brute_force_bm25(CORPUS, q, method=method)
            np.testing.assert_allclose(scores[i], expected, rtol=1e-5, atol=1e-6)

    def test_tf_is_unique_overlap(self):
        idx = eidx.build_index(CORPUS)
        queries = ["the quick fox fox".split(), "dog cat".split()]
        qids, qcnt = eidx.encode_queries(queries, idx.vocab)
        _, tfs = scoring.score_all_xla(idx.term_ids, idx.weights, qids, qcnt)
        tfs = np.asarray(tfs)[:, : idx.n_docs]
        for i, q in enumerate(queries):
            qset = set(q)
            expected = [len(qset & set(d)) for d in CORPUS]
            np.testing.assert_array_equal(tfs[i], expected)

    def test_empty_query_scores_zero(self):
        idx = eidx.build_index(CORPUS)
        qids, qcnt = eidx.encode_queries([[]], idx.vocab)
        scores, tfs = scoring.score_all_xla(idx.term_ids, idx.weights, qids, qcnt)
        assert np.all(np.asarray(scores) == 0)
        assert np.all(np.asarray(tfs) == 0)

    def test_pad_rows_score_zero(self):
        idx = eidx.build_index(CORPUS)
        qids, qcnt = eidx.encode_queries(["the fox".split()], idx.vocab)
        scores, _ = scoring.score_all_xla(idx.term_ids, idx.weights, qids, qcnt)
        assert np.all(np.asarray(scores)[:, idx.n_docs:] == 0)


class TestEncodeQueries:
    def test_oov_dropped(self):
        idx = eidx.build_index(CORPUS)
        qids, qcnt = eidx.encode_queries([["zzz", "fox"]], idx.vocab)
        valid = qids[0][qids[0] >= 0]
        assert len(valid) == 1
        assert valid[0] == idx.vocab["fox"]

    def test_multiplicity_counts(self):
        idx = eidx.build_index(CORPUS)
        qids, qcnt = eidx.encode_queries([["fox", "fox", "dog"]], idx.vocab)
        m = {int(t): float(c) for t, c in zip(qids[0], qcnt[0]) if t >= 0}
        assert m[idx.vocab["fox"]] == 2.0
        assert m[idx.vocab["dog"]] == 1.0


class TestPackedTransport:
    """pack_ids_probs / unpack_ids_probs: the single-pull transport for
    (ids, probabilities). Ids bitcast through f32 — including -1 dead
    slots, whose bit pattern is a NaN payload that must survive the
    round trip unchanged."""

    def test_roundtrip_including_negative_ids(self):
        import jax.numpy as jnp

        from bayesian_bm25_tpu.engine import scoring
        ids = jnp.asarray(np.array(
            [[5, -1, 2_000_000_000, 0, -1], [1, 2, 3, 4, 5]], np.int32))
        probs = jnp.asarray(np.array(
            [[0.5, 0.0, 0.25, 1.0, 0.0], [0.1, 0.2, 0.3, 0.4, 0.5]],
            np.float32))
        packed = np.asarray(scoring.pack_ids_probs(ids, probs))
        out_ids, out_probs = scoring.unpack_ids_probs(packed, 2)
        np.testing.assert_array_equal(out_ids, np.asarray(ids))
        np.testing.assert_array_equal(out_probs,
                                      np.asarray(probs, np.float64))
        assert out_probs.dtype == np.float64

    def test_nq_slice(self):
        import jax.numpy as jnp

        from bayesian_bm25_tpu.engine import scoring
        ids = jnp.zeros((4, 3), jnp.int32)
        probs = jnp.ones((4, 3), jnp.float32)
        packed = np.asarray(scoring.pack_ids_probs(ids, probs))
        out_ids, out_probs = scoring.unpack_ids_probs(packed, 2)
        assert out_ids.shape == (2, 3) and out_probs.shape == (2, 3)


class TestExactTopkBlockwise:
    """exact_topk_blockwise: tie-order-identical to lax.top_k (utility;
    the proof lives in its docstring — these fuzz it, tie-heavy)."""

    def test_fuzz_vs_lax_topk(self):
        import jax
        import jax.numpy as jnp

        from bayesian_bm25_tpu.engine import split_index as sidx
        rng = np.random.default_rng(0)
        for trial in range(6):
            nq = int(rng.integers(1, 9))
            D = int(rng.integers(200, 3000))
            k = int(rng.integers(1, 16))
            # quantized values force heavy value ties
            s = jnp.asarray(
                rng.integers(0, 12, size=(nq, D)).astype(np.float32))
            v1, i1 = jax.lax.top_k(s, k)
            v2, i2 = sidx.exact_topk_blockwise(s, k, block=128)
            np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
            np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))

    def test_with_neg_inf_and_few_blocks(self):
        import jax
        import jax.numpy as jnp

        from bayesian_bm25_tpu.engine import split_index as sidx
        s = jnp.full((2, 300), -jnp.inf).at[0, 7].set(1.0)
        v1, i1 = jax.lax.top_k(s, 5)
        v2, i2 = sidx.exact_topk_blockwise(s, 5, block=128)
        np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
