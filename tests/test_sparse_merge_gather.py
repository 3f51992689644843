"""The sparse merge's base-score gather (engine/split_index.py:
_sparse_merge), an XLA gather that clamps the D_pad sentinel to the last
column, against the doc-major compare path (engine/scoring.py): ids and
tf equal, scores to f32 reassociation, across the merge passes and with
a doc mask."""

import numpy as np
import pytest

import jax.numpy as jnp

from bayesian_bm25_tpu import BayesianBM25Scorer
from bayesian_bm25_tpu.engine import index as eidx
from bayesian_bm25_tpu.engine import scoring
from bayesian_bm25_tpu.engine import split_index as sidx


def _corpus(seed=7, n_docs=500, vocab=300):
    rng = np.random.default_rng(seed)
    words = [f"t{i}" for i in range(vocab)]
    return [list(rng.choice(words, size=rng.integers(3, 30)))
            for _ in range(n_docs)]


def _queries(seed=8, n=96, vocab=300):
    rng = np.random.default_rng(seed)
    words = [f"t{i}" for i in range(vocab)]
    return [list(rng.choice(words, size=rng.integers(1, 6)))
            for _ in range(n)]


def _sparse(idx, split, queries, k, doc_mask=None):
    fslots, fcnt, trows, tqids, tqcnt = sidx.encode_queries_split(
        queries, split)
    tslots = sidx.map_tail_slots(tqids, split)
    cap = sidx.candidate_cap(split, tslots, k)
    return sidx.retrieve_topk_split_sparse(
        split.dense_impact, split.dense_presence, split.post_doc_ids,
        split.post_weights, idx.doc_lengths, idx.avgdl,
        jnp.asarray(fslots), jnp.asarray(fcnt), jnp.asarray(trows),
        jnp.asarray(tslots), jnp.asarray(tqcnt), k, cap, 1.0, 2.0, None,
        n_docs=idx.n_docs, impact_lo=split.dense_impact_lo,
        doc_mask=doc_mask)


def _compare(idx, queries, k, doc_mask=None):
    qids, qcnt = eidx.encode_queries(queries, idx.vocab)
    return scoring.retrieve_topk(
        idx.term_ids, idx.weights, idx.doc_lengths, idx.avgdl, qids, qcnt,
        k, 1.0, 2.0, None, n_docs=idx.n_docs, doc_mask=doc_mask)


def _assert_same(a, b):
    ids_a, p_a, s_a, tf_a = (np.asarray(x) for x in a)
    ids_b, p_b, s_b, tf_b = (np.asarray(x) for x in b)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(s_a, s_b, rtol=1e-6)
    np.testing.assert_array_equal(tf_a, tf_b)
    np.testing.assert_allclose(p_a, p_b, rtol=1e-6)


@pytest.fixture(scope="module")
def built():
    idx = eidx.build_index(_corpus())
    split = sidx.build_split_index(idx, n_frequent=64)
    assert split.post_doc_ids is not None
    return idx, split


class TestSparseGather:
    def test_matches_compare_path(self, built):
        idx, split = built
        qs = _queries()
        _assert_same(_sparse(idx, split, qs, 10), _compare(idx, qs, 10))

    def test_sentinel_slots_clamp_and_drop(self, built):
        # Rare terms whose postings rows are shorter than the table width
        # leave D_pad sentinel slots in every candidate row; the gather
        # clamps them to the last (pad) column and the merge drops them.
        idx, split = built
        assert idx.n_docs < split.dense_impact.shape[0]  # pad docs exist
        R = split.post_doc_ids.shape[0] - 1
        df = split.rare_df[:R]
        inv = {v: t for t, v in idx.vocab.items()}
        rare_terms = [inv[t] for t in np.nonzero(
            split.rare_slot_of_term[:idx.n_terms] < R)[0]]
        qs = [[t] for t in rare_terms[:32]]
        assert (df < split.post_doc_ids.shape[1]).any()
        got = _sparse(idx, split, qs, 5)
        ids = np.asarray(got[0])
        assert ids.max() < idx.n_docs
        _assert_same(got, _compare(idx, qs, 5))

    def test_with_doc_mask(self, built):
        idx, split = built
        qs = _queries(seed=9)
        mask = np.random.default_rng(2).random(idx.n_docs) < 0.6
        got = _sparse(idx, split, qs, 10, doc_mask=jnp.asarray(mask))
        ids = np.asarray(got[0])
        assert np.all(mask[ids[ids >= 0]])
        _assert_same(got, _compare(idx, qs, 10, doc_mask=jnp.asarray(mask)))

    def test_repeated_tail_rows_of_one_query(self, built):
        # The same query twice in a batch: two tail rows gather from two
        # score rows holding identical values.
        idx, split = built
        qs = _queries(seed=10, n=8)
        qs = qs + qs
        got = _sparse(idx, split, qs, 10)
        ids = np.asarray(got[0])
        np.testing.assert_array_equal(ids[:8], ids[8:])
        _assert_same(got, _compare(idx, qs, 10))

    def test_scorer_light_heavy_passes(self, monkeypatch):
        # Light/heavy split forced on: the heavy pass's gather runs at
        # its own cap; results still equal the compare path.
        monkeypatch.setattr(BayesianBM25Scorer, "_SPLIT_BUDGET_BYTES",
                            2_000_000)
        monkeypatch.setattr(sidx, "_LH_MIN_SAVE", 0)
        monkeypatch.setattr(sidx, "_LH_MIN_RATIO", 1.0)
        self._scorer_vs_compare(monkeypatch)

    def test_scorer_tier2_pass(self, monkeypatch):
        # A capped postings budget moves high-df rare terms to the tier-2
        # rectangle; its merge pass gathers from the same score matrix.
        monkeypatch.setattr(BayesianBM25Scorer, "_SPLIT_BUDGET_BYTES",
                            2_000_000)
        monkeypatch.setattr(sidx, "_POSTINGS_MAX_ENTRIES", 20_000)
        s = self._scorer_vs_compare(monkeypatch)
        assert s._split.post2_doc_ids is not None

    @staticmethod
    def _scorer_vs_compare(monkeypatch):
        rng = np.random.default_rng(0)
        corpus = [[f"t{t}" for t in rng.zipf(1.25, size=80) % 900]
                  for _ in range(800)]
        qs = [[f"t{t}" for t in rng.zipf(1.3, size=6) % 900]
              for _ in range(48)]
        s = BayesianBM25Scorer(base_rate=0.01, matmul_precision="highest")
        s.index(corpus, show_progress=False)
        assert s._split is not None and s._split.post_doc_ids is not None
        nq, ids, probs, scores, tfs = s._retrieve_launch(qs, 10, False,
                                                         None)
        idx, t = s.bm25_index, s.transform
        qids, qcnt = eidx.encode_queries(qs, idx.vocab)
        ref = scoring.retrieve_topk(
            idx.term_ids, idx.weights, idx.doc_lengths, idx.avgdl, qids,
            qcnt, 10, t.alpha, t.beta, t.base_rate, n_docs=idx.n_docs)
        _assert_same((ids, probs, scores, tfs), ref)
        return s
