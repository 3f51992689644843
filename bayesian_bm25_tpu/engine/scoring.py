"""Batched BM25 scoring kernels (XLA path) + fused probability transform.

The scoring core evaluates, for a query with unique term ids q and counts c:

    score[d] = sum_j c[j] * sum_t weights[d, t] * (term_ids[d, t] == q[j])
    tf[d]    = sum_j        sum_t                (term_ids[d, t] == q[j])

over the doc-major padded term table (engine/index.py). All shapes are
static; the inner loop over the (padded) query width is a lax.fori_loop of
dense (D, T) compare-multiply-reduce steps — elementwise work that XLA fuses,
with no gathers or scatters. ``tf`` is exactly the reference's
unique-overlap count |query_set ∩ doc_set| (scorer.py:592-601) because doc
rows and query ids are unique.

This doc-major compare path is the plain reference the frequency-split
kernels (engine/split_index.py) are tested against.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from bayesian_bm25_tpu.ops import transform as T


def _score_one_query(term_ids, weights, qids_row, qcnt_row):
    """Score a single query against the full doc table -> (scores, tfs)."""
    Q = qids_row.shape[0]
    f32 = weights.dtype

    def body(j, carry):
        acc, tf = carry
        m = term_ids == qids_row[j]
        mf = m.astype(f32)
        acc = acc + qcnt_row[j] * jnp.sum(weights * mf, axis=1)
        tf = tf + jnp.sum(mf, axis=1)
        return acc, tf

    # Derive the carry init from `weights` so its sharding/varying-axis type
    # matches the body outputs under shard_map (a bare jnp.zeros is
    # "unvarying" and trips the vma check).
    zeros = jnp.sum(weights, axis=1) * 0.0
    return jax.lax.fori_loop(0, Q, body, (zeros, zeros))


@partial(jax.jit, static_argnames=("query_chunk",))
def score_all_xla(term_ids, weights, qids, qcnt, query_chunk: int = 16):
    """(nq, D) BM25 scores and unique-overlap tf counts for a query batch.

    Queries are processed in vmapped chunks inside a lax.map so the
    intermediate (chunk, D, T) comparisons stay bounded.
    """
    nq = qids.shape[0]
    pad = (-nq) % query_chunk
    qids_p = jnp.pad(qids, ((0, pad), (0, 0)), constant_values=-2)
    qcnt_p = jnp.pad(qcnt, ((0, pad), (0, 0)))
    n_chunks = qids_p.shape[0] // query_chunk

    qids_c = qids_p.reshape(n_chunks, query_chunk, -1)
    qcnt_c = qcnt_p.reshape(n_chunks, query_chunk, -1)

    def chunk_fn(args):
        qi, qc = args
        return jax.vmap(lambda a, b: _score_one_query(term_ids, weights, a, b))(qi, qc)

    scores, tfs = jax.lax.map(chunk_fn, (qids_c, qcnt_c))
    D = term_ids.shape[0]
    return (
        scores.reshape(-1, D)[:nq],
        tfs.reshape(-1, D)[:nq],
    )


def score_all(term_ids, weights, qids, qcnt):
    """(nq, D) BM25 scores and unique-overlap tf counts (compare path)."""
    return score_all_xla(term_ids, weights, qids, qcnt)


# ---------------------------------------------------------------------------
# Fused scoring -> probability pipelines (the hot query path)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("n_docs", "prior_free"))
def probabilities_all(
    term_ids, weights, doc_lengths, avgdl, qids, qcnt,
    alpha, beta, base_rate=None, *, n_docs: int | None = None,
    prior_free: bool = False,
):
    """Dense calibrated probabilities for every document (nq, n_docs).

    Fuses scoring, doc-length ratios, unique-overlap tf, and the Bayesian
    transform in one jitted graph; probability is 0 where score <= 0
    (reference scorer.py:603-640). ``n_docs`` slices off index pad rows.
    """
    scores, tfs = score_all(term_ids, weights, qids, qcnt)
    if n_docs is not None:
        scores = scores[:, :n_docs]
        tfs = tfs[:, :n_docs]
        doc_lengths = doc_lengths[:n_docs]
    dlr = (doc_lengths / avgdl)[None, :]
    probs = T.score_to_probability(
        scores, tfs, dlr, alpha, beta, base_rate, prior_free=prior_free
    )
    return jnp.where(scores > 0, probs.astype(scores.dtype), 0.0), scores, tfs


@partial(jax.jit, static_argnames=("k",))
def thresholded_topk(probs, threshold: float, k: int):
    """(ids, probs, n_passing) of the k most probable docs with
    P >= threshold per query; ids -1 / probs 0 beyond the passing set.

    Operates on a dense probability matrix, so the passing set is complete
    (no score-ordered filter can drop a passing doc). Entries with
    probability 0 (zero-score docs, and docs zeroed by a doc_mask) never
    pass — even at threshold=0.0 — so the mask contract holds for every
    threshold: a true probability is strictly positive (sigmoid output),
    so this excludes exactly the no-evidence/masked set."""
    passing = (probs >= threshold) & (probs > 0.0)
    n_passing = jnp.sum(passing, axis=1).astype(jnp.int32)
    masked = jnp.where(passing, probs, -1.0)
    top_p, top_ids = jax.lax.top_k(masked, k)
    keep = top_p >= threshold
    return (jnp.where(keep, top_ids, -1),
            jnp.where(keep, top_p, 0.0),
            n_passing)


@jax.jit
def pack_ids_probs(ids, probs):
    """Pack (ids, probs) into ONE f32 array (2, nq, k) for a single
    device->host pull, so a result costs one transfer's fixed latency
    instead of two. Ids travel bitcast (exact); unpack with
    ``unpack_ids_probs``."""
    return jnp.stack([
        jax.lax.bitcast_convert_type(ids.astype(jnp.int32), jnp.float32),
        probs.astype(jnp.float32),
    ])


def unpack_ids_probs(packed_np, nq):
    """Host-side inverse of ``pack_ids_probs`` (numpy views, no copies
    beyond the float64 cast the public API promises)."""
    ids = packed_np[0, :nq].view(np.int32)
    probs = packed_np[1, :nq].astype(np.float64)
    return ids, probs


@jax.jit
def count_above(scores, s_min):
    """Per-query count of positive scores >= s_min (candidate sizing for
    the pruned thresholded path; one memory-bound pass)."""
    return jnp.sum((scores > 0) & (scores >= s_min), axis=1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("k", "prior_free"))
def thresholded_topk_from_scores(
    scores, tfs, doc_lengths, avgdl, threshold: float, k: int,
    alpha, beta, base_rate=None, *, prior_free: bool = False,
):
    """Dense thresholded retrieval from precomputed (scores, tfs): the
    fallback when the WAND prefilter keeps too many candidates — reuses
    the score pass instead of recomputing it (probabilities identical to
    ``probabilities_all_split`` + ``thresholded_topk``: same elementwise
    ops on the same inputs). Masked (-inf) scores yield probability 0."""
    from bayesian_bm25_tpu.ops import transform as T

    dlr = (doc_lengths / avgdl)[None, :]
    probs = T.score_to_probability(scores, tfs, dlr, alpha, beta,
                                   base_rate, prior_free=prior_free)
    probs = jnp.where(scores > 0, probs.astype(scores.dtype), 0.0)
    passing = (probs >= threshold) & (probs > 0.0)
    n_passing = jnp.sum(passing, axis=1).astype(jnp.int32)
    masked = jnp.where(passing, probs, -1.0)
    top_p, top_ids = jax.lax.top_k(masked, k)
    keep = top_p >= threshold
    return (jnp.where(keep, top_ids, -1),
            jnp.where(keep, top_p, 0.0),
            n_passing)


@partial(jax.jit, static_argnames=("k", "C", "prior_free"))
def thresholded_topk_pruned(
    scores, tfs, doc_lengths, avgdl, threshold: float, s_min,
    k: int, C: int, alpha, beta, base_rate=None, *, prior_free: bool = False,
):
    """WAND-pruned thresholded retrieval: exact probabilities computed for
    candidates only (output-identical to the dense path, which transforms
    all (nq, D) scores).

    The certified bound (ops/transform.py:wand_score_threshold, inverse of
    probability.py:205-236's WAND upper bound) guarantees every doc with
    P >= threshold scores >= s_min, so the candidate set — the top C
    positive scores at/above s_min — contains the entire passing set
    whenever C covers the per-query count (the caller sizes C from
    ``count_above``). Candidates are then re-sorted by doc id so
    probability ties break to the lowest id exactly as the dense
    ``thresholded_topk``'s top_k over the document axis does.

    ``scores`` must already be doc-masked (-inf) and sliced to n_docs.
    """
    from bayesian_bm25_tpu.ops import transform as T

    n_docs = scores.shape[1]
    screen = jnp.where((scores > 0) & (scores >= s_min), scores, -jnp.inf)
    cand_s, cand_ids = jax.lax.top_k(screen, C)
    # Id-ascending stable sort (invalid slots -> sentinel n_docs).
    sort_key = jnp.where(jnp.isfinite(cand_s), cand_ids, n_docs)
    sid, ss = jax.lax.sort((sort_key, cand_s), dimension=1, num_keys=1,
                           is_stable=True)
    valid = jnp.isfinite(ss)
    gi = jnp.minimum(sid, n_docs - 1)
    safe_s = jnp.where(valid, ss, 0.0)
    cand_tf = jnp.take_along_axis(tfs, gi, axis=1)
    cand_dlr = doc_lengths[gi] / avgdl
    probs = T.score_to_probability(
        safe_s, cand_tf, cand_dlr, alpha, beta, base_rate,
        prior_free=prior_free,
    )
    probs = jnp.where(valid & (safe_s > 0), probs.astype(scores.dtype), 0.0)
    passing = (probs >= threshold) & (probs > 0.0)
    n_passing = jnp.sum(passing, axis=1).astype(jnp.int32)
    masked = jnp.where(passing, probs, -1.0)
    top_p, pos = jax.lax.top_k(masked, k)
    keep = top_p >= threshold
    out_ids = jnp.where(keep, jnp.take_along_axis(sid, pos, axis=1), -1)
    return out_ids, jnp.where(keep, top_p, 0.0), n_passing


@partial(jax.jit, static_argnames=("k", "n_docs", "prior_free"))
def retrieve_topk(
    term_ids, weights, doc_lengths, avgdl, qids, qcnt, k: int,
    alpha, beta, base_rate=None, *, n_docs: int | None = None,
    prior_free: bool = False, doc_mask=None,
):
    """Top-k by BM25 score with calibrated probabilities (nq, k).

    Ranking is by raw BM25 score (parity with bm25s retrieve, sorted=True,
    scorer.py:525-529); probabilities are computed for the selected docs.
    ``doc_mask`` (bool, per doc) excludes documents from selection
    entirely (serving-side tenant/metadata filters); slots that cannot be
    filled from the unmasked set return id -1 / probability 0.
    """
    scores, tfs = score_all(term_ids, weights, qids, qcnt)
    if n_docs is not None:
        scores = scores[:, :n_docs]
        tfs = tfs[:, :n_docs]
    if doc_mask is not None:
        scores = jnp.where(doc_mask[None, : scores.shape[1]], scores,
                           -jnp.inf)
    top_scores, top_ids = jax.lax.top_k(scores, k)
    dead = ~jnp.isfinite(top_scores)
    top_scores = jnp.where(dead, 0.0, top_scores)
    top_ids = jnp.where(dead, -1, top_ids)
    top_tfs = jnp.take_along_axis(tfs, jnp.maximum(top_ids, 0), axis=1)
    top_dlr = doc_lengths[jnp.maximum(top_ids, 0)] / avgdl
    probs = T.score_to_probability(
        top_scores, top_tfs, top_dlr, alpha, beta, base_rate,
        prior_free=prior_free,
    )
    probs = jnp.where(top_scores > 0, probs.astype(top_scores.dtype), 0.0)
    return top_ids, probs, top_scores, top_tfs
