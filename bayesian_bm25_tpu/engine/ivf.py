"""IVF cosine index: Lloyd k-means as matmuls + multi-probe search.

Device counterpart of the reference's benchmark-local SimpleIVF
(benchmarks/simple_ivf.py): the k-means assignment/update steps run as one
jitted fori_loop of (n_docs, dim) @ (dim, n_cells) matmuls + segment sums —
the whole build is device work — while the ragged per-query candidate
gather stays host-side (the result object is ragged by design; the hybrid
harness consumes exact per-cell populations and residuals).

Build protocol parity: L2-normalized centroids, empty-cell refill from
seeded draws, auto n_cells = round(sqrt(n)) (min 4), default_nprobe =
round(sqrt(n_cells)), background_distances = 1 - centroid similarity,
per-cell residual mean/q90.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

_EPSILON = 1e-12


def _l2_normalize_rows(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr, dtype=np.float32)
    norms = np.linalg.norm(arr, axis=1, keepdims=True)
    return arr / np.maximum(norms, _EPSILON)


@partial(jax.jit, static_argnames=("n_cells", "max_iterations"))
def _lloyd(embeddings, init_centroids, refill_pool, n_cells: int,
           max_iterations: int):
    """Fixed-iteration Lloyd k-means with empty-cell refill.

    ``refill_pool`` is (max_iterations, n_cells) of pre-drawn doc indices;
    iteration t refills empty cell c from refill_pool[t, c] — the
    data-dependent refill becomes a jnp.where instead of host control flow.
    Returns (centroids, assignments).
    """
    emb = embeddings

    def body(t, carry):
        centroids, _ = carry
        sims = emb @ centroids.T
        assign = jnp.argmax(sims, axis=1).astype(jnp.int32)
        sums = jax.ops.segment_sum(emb, assign, num_segments=n_cells)
        counts = jax.ops.segment_sum(
            jnp.ones(emb.shape[0], jnp.float32), assign, num_segments=n_cells
        )
        new_c = sums / jnp.maximum(counts, 1.0)[:, None]
        refill = emb[refill_pool[t]]
        new_c = jnp.where((counts == 0)[:, None], refill, new_c)
        norms = jnp.linalg.norm(new_c, axis=1, keepdims=True)
        new_c = new_c / jnp.maximum(norms, _EPSILON)
        return new_c, assign

    centroids, assign = jax.lax.fori_loop(
        0, max_iterations, body,
        (init_centroids, jnp.zeros(emb.shape[0], jnp.int32)),
    )
    final_sims = emb @ centroids.T
    assignments = jnp.argmax(final_sims, axis=1)
    centroid_scores = jnp.take_along_axis(
        final_sims, assignments[:, None], axis=1
    )[:, 0]
    return centroids, assignments, centroid_scores


@dataclass
class IVFSearchResult:
    """Per-query IVF search bundle (field parity with simple_ivf.py:25-38)."""

    indices: np.ndarray
    scores: np.ndarray
    cell_ids: np.ndarray
    cell_populations: np.ndarray
    candidate_indices: np.ndarray
    candidate_scores: np.ndarray
    candidate_cell_ids: np.ndarray
    candidate_cell_populations: np.ndarray
    probed_cell_ids: np.ndarray
    probed_cell_scores: np.ndarray
    centroid_scores: np.ndarray


class SimpleIVF:
    """Cosine IVF with CSR-like cell layout (API parity with the reference)."""

    def __init__(self, embeddings, centroids, assignments, sorted_doc_ids,
                 cell_offsets, *, default_nprobe: int, background_distances,
                 cell_residual_means, cell_residual_q90) -> None:
        self.embeddings = np.asarray(embeddings, dtype=np.float32)
        self.centroids = np.asarray(centroids, dtype=np.float32)
        self.assignments = np.asarray(assignments, dtype=np.int32)
        self.sorted_doc_ids = np.asarray(sorted_doc_ids, dtype=np.int32)
        self.cell_offsets = np.asarray(cell_offsets, dtype=np.int64)
        self.default_nprobe = int(default_nprobe)
        self.background_distances = np.asarray(background_distances, np.float64)
        self.cell_residual_means = np.asarray(cell_residual_means, np.float64)
        self.cell_residual_q90 = np.asarray(cell_residual_q90, np.float64)

        self.n_docs = int(self.embeddings.shape[0])
        self.dim = int(self.embeddings.shape[1])
        self.n_cells = int(self.centroids.shape[0])
        self.cell_populations = np.diff(self.cell_offsets).astype(np.int32)
        self.avg_population = float(np.mean(self.cell_populations))
        self._emb_dev = jnp.asarray(self.embeddings)

    @classmethod
    def build(cls, embeddings, *, n_cells: int | None = None,
              max_iterations: int = 10, seed: int = 42) -> "SimpleIVF":
        embeddings = _l2_normalize_rows(embeddings)
        n_docs, dim = embeddings.shape
        if n_docs == 0:
            raise ValueError("embeddings must contain at least one vector")
        if n_cells is None:
            n_cells = max(4, int(round(math.sqrt(n_docs))))
        n_cells = max(1, min(int(n_cells), n_docs))
        if max_iterations <= 0:
            raise ValueError(
                f"max_iterations must be positive, got {max_iterations}"
            )

        rng = np.random.default_rng(seed)
        init_idx = rng.choice(n_docs, size=n_cells, replace=False)
        refill_pool = rng.integers(
            0, n_docs, size=(max_iterations, n_cells)
        ).astype(np.int32)

        centroids, assignments, centroid_scores = _lloyd(
            jnp.asarray(embeddings), jnp.asarray(embeddings[init_idx]),
            jnp.asarray(refill_pool), n_cells, max_iterations,
        )
        centroids = np.asarray(centroids)
        assignments = np.asarray(assignments, dtype=np.int32)
        centroid_scores = np.asarray(centroid_scores, dtype=np.float32)

        counts = np.bincount(assignments, minlength=n_cells).astype(np.int32)
        order = np.argsort(assignments, kind="stable")
        offsets = np.zeros(n_cells + 1, dtype=np.int64)
        offsets[1:] = np.cumsum(counts, dtype=np.int64)

        background = 1.0 - centroid_scores.astype(np.float64)
        g_mean = float(np.mean(background))
        g_q90 = float(np.percentile(background, 90))
        res_means = np.full(n_cells, g_mean)
        res_q90 = np.full(n_cells, g_q90)
        for cell in range(n_cells):
            mask = assignments == cell
            if mask.any():
                res = background[mask]
                res_means[cell] = float(np.mean(res))
                res_q90[cell] = float(np.percentile(res, 90))

        return cls(
            embeddings=embeddings, centroids=centroids,
            assignments=assignments,
            sorted_doc_ids=order.astype(np.int32), cell_offsets=offsets,
            default_nprobe=max(1, int(round(math.sqrt(n_cells)))),
            background_distances=background,
            cell_residual_means=res_means, cell_residual_q90=res_q90,
        )

    def _docs_for_cells(self, cell_ids) -> np.ndarray:
        groups = []
        for cell in cell_ids:
            start = int(self.cell_offsets[cell])
            end = int(self.cell_offsets[cell + 1])
            if end > start:
                groups.append(self.sorted_doc_ids[start:end])
        if not groups:
            return np.empty(0, dtype=np.int32)
        return np.concatenate(groups).astype(np.int32, copy=False)

    def score_documents(self, query, doc_indices) -> np.ndarray:
        """Exact cosine scores for selected docs (device matmul)."""
        q = np.asarray(query, dtype=np.float32)
        q = q / max(float(np.linalg.norm(q)), _EPSILON)
        doc_indices = np.asarray(doc_indices, dtype=np.int32)
        if len(doc_indices) == 0:
            return np.empty(0, dtype=np.float64)
        scores = np.asarray(self._emb_dev[jnp.asarray(doc_indices)] @ q)
        return scores.astype(np.float64)

    def search(self, query, k: int, *, nprobe: int | None = None
               ) -> IVFSearchResult:
        q = np.asarray(query, dtype=np.float32)
        q = q / max(float(np.linalg.norm(q)), _EPSILON)
        if nprobe is None:
            nprobe = self.default_nprobe
        nprobe = max(1, min(int(nprobe), self.n_cells))

        centroid_scores = self.centroids @ q
        if nprobe >= self.n_cells:
            probed = np.arange(self.n_cells, dtype=np.int32)
        else:
            part = np.argpartition(-centroid_scores, nprobe - 1)[:nprobe]
            probed = part[np.argsort(-centroid_scores[part])].astype(np.int32)
        probed_scores = centroid_scores[probed].astype(np.float64)

        cand = self._docs_for_cells(probed)
        cand_scores = self.score_documents(q, cand)
        cand_cells = self.assignments[cand]
        cand_pops = self.cell_populations[cand_cells]

        k_eff = min(max(int(k), 0), len(cand))
        if k_eff == 0:
            empty_i = np.empty(0, dtype=np.int32)
            empty_f = np.empty(0, dtype=np.float64)
            return IVFSearchResult(
                empty_i, empty_f, empty_i, empty_i, cand, cand_scores,
                cand_cells, cand_pops, probed, probed_scores,
                centroid_scores.astype(np.float64),
            )

        if k_eff == len(cand):
            top = np.argsort(-cand_scores)
        else:
            top = np.argpartition(-cand_scores, k_eff - 1)[:k_eff]
            top = top[np.argsort(-cand_scores[top])]

        return IVFSearchResult(
            indices=cand[top].astype(np.int32),
            scores=cand_scores[top],
            cell_ids=cand_cells[top].astype(np.int32),
            cell_populations=cand_pops[top].astype(np.int32),
            candidate_indices=cand,
            candidate_scores=cand_scores,
            candidate_cell_ids=cand_cells.astype(np.int32),
            candidate_cell_populations=cand_pops.astype(np.int32),
            probed_cell_ids=probed,
            probed_cell_scores=probed_scores,
            centroid_scores=centroid_scores.astype(np.float64),
        )

    def search_batch(self, queries, k: int, *, nprobe: int | None = None):
        """Batched exact-over-probed-cells device path: (nq, k) ids+scores.

        Extension: scores every query against the full corpus in
        one (nq, dim) @ (dim, n_docs) matmul, masks docs outside the
        probed cells, and lax.top_k's — fixed shapes, no ragged gathers.
        """
        qs = _l2_normalize_rows(np.asarray(queries, dtype=np.float32))
        if nprobe is None:
            nprobe = self.default_nprobe
        nprobe = max(1, min(int(nprobe), self.n_cells))
        ids, scores = _ivf_batch_search(
            self._emb_dev, jnp.asarray(self.centroids),
            jnp.asarray(self.assignments), jnp.asarray(qs), k, nprobe,
        )
        return np.asarray(ids), np.asarray(scores).astype(np.float64)


@partial(jax.jit, static_argnames=("k", "nprobe"))
def _ivf_batch_search(emb, centroids, assignments, queries, k: int,
                      nprobe: int):
    cscores = queries @ centroids.T                        # (nq, n_cells)
    _, probed = jax.lax.top_k(cscores, nprobe)             # (nq, nprobe)
    in_probe = (assignments[None, :, None] == probed[:, None, :]).any(-1)
    dscores = queries @ emb.T                              # (nq, n_docs)
    masked = jnp.where(in_probe, dscores, -jnp.inf)
    top_s, top_i = jax.lax.top_k(masked, k)
    return top_i, top_s
