"""ShardedBayesianBM25Scorer: the multi-chip scorer.

User-facing corpus sharding (SURVEY §5.8/§7.8): the same API as
``BayesianBM25Scorer``, with the document axis of every index array
sharded over a 1-D ``jax.sharding.Mesh`` and retrieval running as
per-shard scoring + local top-k + all_gather merge across devices. The
reference has no distributed layer at all (single-process NumPy); this
class makes the sharding plumbing of ``parallel/sharded.py`` a drop-in
scorer rather than raw functions.

Exactness: ids, ordering, tie-breaks and integer tf are identical to the
 single-chip scorer; float scores/probabilities agree to f32 last-ulp
 (shard-local matmul tiling). Every sharded kernel computes the same float
operations as the single-chip split kernels (shard-local matmul rows,
local tail compare, shard-major candidate order for the lowest-id
tie-break), so retrieve / get_scores_batch / get_probabilities_batch and
the auto-estimated (alpha, beta, base_rate) are identical to the
single-chip scorer — verified by tests/test_sharded_scorer.py running
the single-chip battery against an 8-way CPU mesh.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from bayesian_bm25_tpu.engine import index as eidx
from bayesian_bm25_tpu.models.scorer import BayesianBM25Scorer, RetrievalResult
from bayesian_bm25_tpu.parallel import sharded


def _lcm(a: int, b: int) -> int:
    import math

    return a * b // math.gcd(a, b)


class ShardedBayesianBM25Scorer(BayesianBM25Scorer):
    """Document-sharded scorer over a 1-D device mesh.

    Parameters are those of ``BayesianBM25Scorer`` plus:

    mesh: an existing ``Mesh`` — 1-D with axis ``'d'`` (document
        sharding) or 2-D with axes ``('q', 'd')`` (query x document); or
    n_devices: build a 1-D mesh over the first n devices (default: all);
    mesh_shape: build a 2-D (q, d) mesh, e.g. ``mesh_shape=(2, 4)``.

    Retrieval uses the distributed sparse-candidate kernel (matmul +
    doc-sharded rare-postings merge — the fastest single-chip kernel,
    sharded) on 1-D meshes, and the q x d split kernel on 2-D meshes.
    ``approx=True`` is honored on both: it swaps the per-shard
    matmul-side leader selection for lax.approx_max_k.
    """

    def __init__(self, *args, mesh=None, n_devices: int | None = None,
                 mesh_shape: tuple[int, int] | None = None,
                 **kwargs) -> None:
        super().__init__(*args, **kwargs)
        if mesh is None:
            if mesh_shape is not None:
                mesh = sharded.make_mesh_2d(*mesh_shape)
            else:
                mesh = sharded.make_mesh(n_devices)
        if mesh.axis_names == ("d",):
            self._is_2d = False
        elif mesh.axis_names == ("q", "d"):
            # 2-D (query x document) mesh: retrieval runs dp-style over
            # 'q' and corpus-sharded over 'd'
            # (sharded_retrieve_topk_split_2d); all other entry points
            # shard over 'd' and replicate across 'q'.
            self._is_2d = True
        else:
            raise ValueError(
                "mesh must be 1-D ('d',) or 2-D ('q', 'd'), got "
                f"{mesh.axis_names}")
        self._mesh = mesh
        self._n_shards = int(mesh.shape["d"])
        self._post_sh = None   # sharded rare postings (set by index())
        self._post2_sh = None  # sharded tier-2 rectangle (capped builds)

    @property
    def mesh(self):
        return self._mesh

    # -- construction hooks ---------------------------------------------------

    def _doc_pad_multiple(self) -> int:
        # Pad the doc axis so it divides the mesh evenly — applies to the
        # initial build AND add_documents appends (both route through the
        # base-class hook).
        return _lcm(2048, self._n_shards)

    def _finalize_index(self) -> None:
        """Re-place index/split arrays document-sharded over the mesh."""
        ds = NamedSharding(self._mesh, P("d", None))
        vs = NamedSharding(self._mesh, P("d"))
        idx = self._index
        idx.term_ids = jax.device_put(idx.term_ids, ds)
        idx.weights = jax.device_put(idx.weights, ds)
        idx.doc_lengths = jax.device_put(idx.doc_lengths, vs)
        s = self._split
        self._post_sh = None
        self._post2_sh = None
        if s is not None:
            from bayesian_bm25_tpu.engine import split_index as sidx

            # Overflow tables index docs globally — fold them away by
            # rebuilding without overflow when present.
            if s.over_term_ids is not None:
                storage = ("int8" if s.impact_scale is not None else
                           "hilo" if s.dense_impact_lo is not None else
                           "bf16" if s.dense_impact.dtype == jnp.bfloat16
                           else "f32")
                self._split = s = sidx.build_split_index(
                    idx, n_frequent=s.n_frequent, enable_overflow=False,
                    storage=storage)
            # Doc-shard the rare postings for the distributed
            # sparse-candidate retrieve (the fastest kernel); falls back
            # to the tail-compare kernel only when postings are over
            # budget entirely. Width-capped indexes (tier-2 rectangle
            # active — 1M-doc scale, where sharding matters most) shard
            # BOTH rectangles and run the same two-pass merge as the
            # single-chip kernel.
            if s.post_doc_ids is not None:
                pid_sh, pw_sh, df_sh = sidx.build_sharded_postings(
                    s, self._n_shards)
                ps = NamedSharding(self._mesh, P("d", None, None))
                self._post_sh = (
                    jax.device_put(jnp.asarray(pid_sh), ps),
                    jax.device_put(jnp.asarray(pw_sh), ps),
                    df_sh,
                )
                t2 = sidx.build_sharded_postings2(s, self._n_shards)
                if t2 is not None:
                    pid2_sh, pw2_sh, df2_sh = t2
                    self._post2_sh = (
                        jax.device_put(jnp.asarray(pid2_sh), ps),
                        jax.device_put(jnp.asarray(pw2_sh), ps),
                        df2_sh,
                    )
            s.dense_impact = jax.device_put(s.dense_impact, ds)
            s.dense_presence = jax.device_put(s.dense_presence, ds)
            s.tail_term_ids = jax.device_put(s.tail_term_ids, ds)
            s.tail_weights = jax.device_put(s.tail_weights, ds)
            if s.dense_impact_lo is not None:
                s.dense_impact_lo = jax.device_put(s.dense_impact_lo, ds)
            if s.impact_scale is not None:
                # (2, D_pad) per-doc scales shard along the doc axis,
                # matching the score-column layout inside the bodies.
                s.impact_scale = jax.device_put(
                    s.impact_scale,
                    NamedSharding(self._mesh, P(None, "d")))

    def index_texts(self, texts, *, lowercase: bool = True,
                    remove_stopwords: bool = True, stem: bool = True) -> None:
        # Route through index() so the doc-pad multiple honors the mesh
        # (the native text path pads to 2048, which only suits meshes
        # whose size divides 2048).
        from bayesian_bm25_tpu.engine.tokenize import tokenize_texts

        self.index(tokenize_texts(
            texts, lowercase=lowercase,
            remove_stopwords=remove_stopwords, stem=stem))

    # -- querying -------------------------------------------------------------

    def _encode_split(self, query_tokens_batch):
        from bayesian_bm25_tpu.engine import split_index as sidx

        nq = len(query_tokens_batch)
        nq_pad = sidx._pow2_bucket(max(nq, 1), 1)
        if self._is_2d:
            # the query axis of a 2-D mesh must divide the padded batch
            q = int(self._mesh.shape["q"])
            nq_pad = -(-nq_pad // q) * q
        padded = list(query_tokens_batch) + [[]] * (nq_pad - nq)
        return sidx.encode_queries_split(padded, self._split)

    def retrieve(self, query_tokens, k: int = 10, show_progress: bool = False,
                 explain: bool = False, approx: bool = False, doc_mask=None):
        del show_progress
        if self._transform is None:
            raise RuntimeError("Call index() before retrieve().")
        idx = self._index
        t = self._transform
        k_eff = min(k, idx.n_docs)
        nq = len(query_tokens)
        if doc_mask is not None:
            doc_mask = np.asarray(doc_mask, dtype=bool)
            if doc_mask.shape != (idx.n_docs,):
                raise ValueError(
                    f"doc_mask must have shape ({idx.n_docs},), got "
                    f"{doc_mask.shape}")
        doc_mask = self._combine_deleted(doc_mask)
        prior_free = t._training_mode == "prior_free"
        if self._is_2d:
            if self._split is None:
                raise RuntimeError(
                    "2-D mesh retrieval requires the split index (corpus "
                    "too small/vocab too narrow for a split build)")
            s = self._split
            enc = self._encode_split(query_tokens)
            top_ids, probs, top_scores = (
                sharded.sharded_retrieve_topk_split_2d(
                    self._mesh, s.dense_impact, s.dense_presence,
                    s.tail_term_ids, s.tail_weights, idx.doc_lengths,
                    idx.avgdl, *enc, k_eff, t.alpha, t.beta, t.base_rate,
                    n_docs=idx.n_docs, prior_free=prior_free,
                    precision=self._matmul_precision,
                    impact_lo=s.dense_impact_lo, approx=approx,
                    doc_mask=doc_mask, impact_scale=s.impact_scale,
                )
            )
            doc_ids = np.asarray(top_ids)[:nq]
            probabilities = np.asarray(probs)[:nq].astype(np.float64)
            if not explain:
                return doc_ids, probabilities
            # tf for explain: recompute host-side from the compare helper
            scores_np = np.asarray(top_scores)[:nq]
            tfs_np = np.zeros_like(scores_np)
            for qi, toks in enumerate(query_tokens):
                if self._corpus_tokens is None:
                    break
                tfs_np[qi] = self._compute_tf_batch(
                    np.maximum(doc_ids[qi], 0), toks)
            return self._explain_result(
                doc_ids, probabilities, scores_np, tfs_np)
        if self._split is not None and self._post_sh is not None:
            from bayesian_bm25_tpu.engine import split_index as sidx

            s = self._split
            fslots, fcnt, trows, tqids, tqcnt = self._encode_split(
                query_tokens)
            pid_sh, pw_sh, df_sh = self._post_sh
            R = pid_sh.shape[1] - 1
            # Same host-side pass structure as the single-chip launch:
            # tier partition (group B rows carry >=1 tier-2 term), then
            # the light/heavy cap split of the tier-1 group. Partition
            # decisions reuse the single-chip heuristics (global dfs —
            # per-shard widths scale ~1/n_shards uniformly, so the
            # ratio criterion carries over); CAPS come from the
            # per-shard df tables.
            (trows, tslots, tqcnt), grpB = sidx.split_tail_groups(
                trows, tqids, tqcnt, s)
            lh = (sidx.split_light_heavy(trows, tslots, tqcnt, s, k_eff)
                  if sidx.LIGHT_HEAVY else None)
            h_kw = {}
            if lh is not None:
                (trows, tslots, tqcnt), (hrows, hslots, hqcnt) = lh
                h_kw = dict(
                    tailH_rows=hrows, tailH_slots=hslots,
                    tailH_qcnt=hqcnt,
                    cand_capH=sidx.sharded_candidate_cap(
                        df_sh, hslots, k_eff, pid_sh.shape[2]),
                )
                if sidx.PACKED_BUILD:
                    packedH, r_maxH = sidx.compact_tail_postings(
                        hslots, hqcnt, R)
                    if r_maxH < hslots.shape[1]:
                        h_kw["compactH"] = packedH
                        h_kw["compactH_rmax"] = r_maxH
            b_kw = {}
            if grpB is not None:
                pid2_sh, pw2_sh, df2_sh = self._post2_sh
                trB, s1B, qcB, s2B, qc2B = grpB
                b_kw = dict(
                    post2_ids_sh=pid2_sh, post2_w_sh=pw2_sh,
                    tailB_rows=trB, tailB_slots=s1B, tailB_qcnt=qcB,
                    tailB_slots2=s2B, tailB_qcnt2=qc2B,
                    cand_cap2=sidx.sharded_candidate_cap2(
                        df_sh, df2_sh, s1B, s2B, k_eff,
                        pid_sh.shape[2], pid2_sh.shape[2]),
                )
            cap = sidx.sharded_candidate_cap(
                df_sh, tslots, k_eff, pid_sh.shape[2])
            comp, r_max = None, 0
            if sidx.PACKED_BUILD:
                packed, r_max = sidx.compact_tail_postings(
                    tslots, tqcnt, R)
                if r_max < tslots.shape[1]:
                    comp = packed
                else:
                    r_max = 0
            top_ids, probs, top_scores, top_tfs = (
                sharded.sharded_retrieve_topk_split_sparse(
                    self._mesh, s.dense_impact, s.dense_presence,
                    pid_sh, pw_sh, idx.doc_lengths, idx.avgdl,
                    fslots, fcnt, trows, tslots, tqcnt, k_eff, cap,
                    t.alpha, t.beta, t.base_rate,
                    n_docs=idx.n_docs, prior_free=prior_free,
                    approx=approx, precision=self._matmul_precision,
                    doc_mask=doc_mask, impact_lo=s.dense_impact_lo,
                    tf_from_sign=s.post_w_positive,
                    compact=comp, compact_rmax=r_max,
                    impact_scale=s.impact_scale, **h_kw, **b_kw,
                )
            )
        elif self._split is not None:
            del approx  # candidate-based merge; no approx analogue here
            s = self._split
            enc = self._encode_split(query_tokens)
            top_ids, probs, top_scores, top_tfs = (
                sharded.sharded_retrieve_topk_split(
                    self._mesh, s.dense_impact, s.dense_presence,
                    s.tail_term_ids, s.tail_weights, idx.doc_lengths,
                    idx.avgdl, *enc, k_eff, t.alpha, t.beta, t.base_rate,
                    n_docs=idx.n_docs, prior_free=prior_free,
                    return_tfs=True, precision=self._matmul_precision,
                    doc_mask=doc_mask, impact_lo=s.dense_impact_lo,
                    impact_scale=s.impact_scale,
                )
            )
        else:
            qids, qcnt = self._encode(query_tokens)
            top_ids, probs, top_scores, top_tfs = sharded.sharded_retrieve_topk(
                self._mesh, idx.term_ids, idx.weights, idx.doc_lengths,
                idx.avgdl, jnp.asarray(qids), jnp.asarray(qcnt), k_eff,
                t.alpha, t.beta, t.base_rate,
                n_docs=idx.n_docs, prior_free=prior_free, return_tfs=True,
                doc_mask=doc_mask,
            )
        doc_ids = np.asarray(top_ids)[:nq]
        probabilities = np.asarray(probs)[:nq].astype(np.float64)
        if not explain:
            return doc_ids, probabilities
        return self._explain_result(
            doc_ids, probabilities,
            np.asarray(top_scores)[:nq], np.asarray(top_tfs)[:nq])

    def _explain_result(self, doc_ids, probabilities, scores_np, tfs_np):
        from bayesian_bm25_tpu.utils.debug import FusionDebugger

        idx = self._index
        debugger = FusionDebugger(self._transform)
        dl = np.asarray(idx.doc_lengths)
        explanations = []
        for qi in range(doc_ids.shape[0]):
            row = []
            for r in range(doc_ids.shape[1]):
                sc = float(scores_np[qi, r])
                if sc > 0:
                    did = int(doc_ids[qi, r])
                    row.append(debugger.trace_bm25(
                        sc, float(tfs_np[qi, r]), float(dl[did] / idx.avgdl)))
                else:
                    row.append(None)
            explanations.append(row)
        return RetrievalResult(doc_ids, probabilities, explanations)

    def _dense_scores_device(self, query_tokens_batch):
        idx = self._index
        if self._split is not None:
            s = self._split
            enc = self._encode_split(query_tokens_batch)
            return sharded.sharded_scores_all_split(
                self._mesh, s.dense_impact, s.dense_presence,
                s.tail_term_ids, s.tail_weights, *enc,
                precision=self._matmul_precision,
                impact_lo=s.dense_impact_lo,
                impact_scale=s.impact_scale)
        qids, qcnt = self._encode(query_tokens_batch)
        return sharded.sharded_scores_all(
            self._mesh, idx.term_ids, idx.weights,
            jnp.asarray(qids), jnp.asarray(qcnt))

    def _scores_internal(self, query_tokens_batch) -> np.ndarray:
        # Overrides the base hook with the mesh-sharded kernels; the
        # base get_scores_batch adds the bm25l/bm25+ nonoccurrence
        # shift on top, so the public surface matches single-chip.
        if self._index is None:
            raise RuntimeError("Call index() before scoring.")
        nq = len(query_tokens_batch)
        scores, _ = self._dense_scores_device(query_tokens_batch)
        return self._apply_deleted(np.asarray(scores)[
            :nq, : self._index.n_docs].astype(np.float64))

    def _dense_probs_device(self, query_tokens_batch):
        if self._transform is None:
            raise RuntimeError("Call index() before get_probabilities().")
        idx = self._index
        t = self._transform
        scores, tfs = self._dense_scores_device(query_tokens_batch)
        probs = sharded.apply_transform_sharded(
            self._mesh, scores, tfs, idx.doc_lengths, idx.avgdl,
            t.alpha, t.beta, t.base_rate,
            prior_free=t._training_mode == "prior_free")
        return probs[:, : idx.n_docs]

    def retrieve_many(self, query_batches, k: int = 10,
                      approx: bool = False):
        # The sharded retrieve's all_gather merge already returns host
        # results per call; pipelined dispatch is a single-chip serving
        # concern. Loop for API parity.
        return [self.retrieve(qb, k=k, approx=approx)
                for qb in query_batches]

    def retrieve_stream(self, query_batches, k: int = 10,
                        approx: bool = False, lookahead: int = 4):
        # Same rationale as retrieve_many: yield per call, API parity.
        del lookahead
        for qb in query_batches:
            yield self.retrieve(qb, k=k, approx=approx)
