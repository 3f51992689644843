"""Document-sharded scoring, distributed top-k, and sharded training.

Design (SURVEY §7.8): mesh over the document axis ('d'); the term table
(D, T) is sharded PartitionSpec('d', None); query batches are replicated.
Scoring is embarrassingly parallel over docs. Retrieval does a per-shard
lax.top_k (k candidates per shard), converts local row ids to global doc
ids with the shard offset, then all_gathers the (n_shards * k) candidate
set and reduces to the global top-k — k*n_shards values cross the
interconnect instead of the full (nq, D) score matrix. Corpus statistics (N, sum doclen, df)
and fit() gradients aggregate with psum.
"""

from __future__ import annotations

import functools
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bayesian_bm25_tpu.engine.scoring import _score_one_query
from bayesian_bm25_tpu.ops import transform as T
from bayesian_bm25_tpu.ops.mathx import clamp_probability, sigmoid


def _leader_topk(scores, k: int):
    """Per-shard exact leader selection: blockwise on 256-aligned local
    widths, ``lax.top_k`` otherwise. Bit-identical to ``lax.top_k``
    including tie order, so single-chip/sharded equality is preserved;
    masked (-inf) scores pass through unchanged."""
    d_local = scores.shape[1]
    if d_local % 256 == 0 and k < d_local // 256:
        from bayesian_bm25_tpu.engine.split_index import (
            exact_topk_blockwise)
        return exact_topk_blockwise(scores, k, block=256,
                                    valid_upto=d_local)
    return jax.lax.top_k(scores, k)


def make_mesh(n_devices: int | None = None, axis: str = "d") -> Mesh:
    """1-D device mesh over the document axis.

    Raises if fewer than ``n_devices`` devices exist — silently truncating
    would make an "8-way" dryrun test nothing on a 1-device backend.
    """
    devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices for the mesh, have "
                f"{len(devices)} on platform {devices[0].platform!r}"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def make_mesh_2d(n_query: int, n_doc: int) -> Mesh:
    """2-D mesh: query axis ('q', data-parallel over the batch) x document
    axis ('d', the corpus shard axis) — the retrieval analogue of dp x tp."""
    devices = jax.devices()
    need = n_query * n_doc
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh(np.array(devices[:need]).reshape(n_query, n_doc), ("q", "d"))


def sharded_retrieve_topk_2d(mesh: Mesh, term_ids, weights, doc_lengths,
                             avgdl, qids, qcnt, k: int, alpha, beta,
                             base_rate=None):
    """Top-k retrieval on a (query x document) 2-D mesh.

    Queries shard over 'q' (each query-row of devices handles its slice of
    the batch); documents shard over 'd'. Per (q, d) tile: local scoring +
    local top-k; candidates all_gather over 'd' only — the merge rides the
    document axis, and the output stays sharded over 'q' (no cross-batch
    traffic at all).
    """

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("d", None), P("d", None), P("d"),
                  P("q", None), P("q", None)),
        out_specs=(P("q", None), P("q", None), P("q", None)),
        check_vma=False,
    )
    def body(tids, w, dl, qi, qc):
        scores, tfs = _local_score(tids, w, qi, qc)
        local_k = min(k, tids.shape[0])
        top_s, top_local = _leader_topk(scores, local_k)
        offset = jax.lax.axis_index("d") * tids.shape[0]
        top_global = top_local + offset
        top_tf = jnp.take_along_axis(tfs, top_local, axis=1)
        top_dl = dl[top_local]
        cand_s = jax.lax.all_gather(top_s, "d", axis=1, tiled=True)
        cand_id = jax.lax.all_gather(top_global, "d", axis=1, tiled=True)
        cand_tf = jax.lax.all_gather(top_tf, "d", axis=1, tiled=True)
        cand_dl = jax.lax.all_gather(top_dl, "d", axis=1, tiled=True)
        merge_s, merge_pos = jax.lax.top_k(cand_s, k)
        ids = jnp.take_along_axis(cand_id, merge_pos, axis=1)
        tfs_m = jnp.take_along_axis(cand_tf, merge_pos, axis=1)
        dl_m = jnp.take_along_axis(cand_dl, merge_pos, axis=1)
        probs = T.score_to_probability(
            merge_s, tfs_m, dl_m / avgdl, alpha, beta, base_rate
        )
        probs = jnp.where(merge_s > 0, probs.astype(merge_s.dtype), 0.0)
        return ids, probs, merge_s

    doc_sharded = NamedSharding(mesh, P("d", None))
    vec_sharded = NamedSharding(mesh, P("d"))
    q_sharded = NamedSharding(mesh, P("q", None))
    return body(
        jax.device_put(term_ids, doc_sharded),
        jax.device_put(weights, doc_sharded),
        jax.device_put(doc_lengths, vec_sharded),
        jax.device_put(jnp.asarray(qids), q_sharded),
        jax.device_put(jnp.asarray(qcnt), q_sharded),
    )


def shard_index_arrays(mesh: Mesh, term_ids, weights, doc_lengths):
    """Place index arrays with the doc axis sharded over the mesh."""
    doc_sharded = NamedSharding(mesh, P("d", None))
    vec_sharded = NamedSharding(mesh, P("d"))
    return (
        jax.device_put(term_ids, doc_sharded),
        jax.device_put(weights, doc_sharded),
        jax.device_put(doc_lengths, vec_sharded),
    )


def _local_score(term_ids, weights, qids, qcnt):
    """Per-shard scoring: same kernel as single-chip, on the local slab.

    Queries stream in chunks of 16 (lax.map batch_size) so the
    (chunk, D_local, T) comparison intermediates stay bounded for large
    query batches.
    """
    def one(args):
        q_row, c_row = args
        return _score_one_query(term_ids, weights, q_row, c_row)

    return jax.lax.map(one, (qids, qcnt),
                       batch_size=min(16, qids.shape[0]))


def sharded_retrieve_topk(mesh: Mesh, term_ids, weights, doc_lengths, avgdl,
                          qids, qcnt, k: int, alpha, beta, base_rate=None,
                          n_docs: int | None = None, prior_free: bool = False,
                          return_tfs: bool = False, doc_mask=None):
    """Distributed top-k retrieval with calibrated probabilities.

    shard_map body: local scoring -> local top-k (global ids via shard
    offset) -> all_gather candidates -> global top-k. Probabilities are
    computed on the merged winners only. ``n_docs`` masks index pad rows
    out of the merge (each shard still supplies min(k, D_local) real
    candidates, so coverage of the true top-k is preserved); the candidate
    gather order (shard-major, local-rank-minor over contiguously sharded
    docs) reproduces the single-chip lowest-id tie-break exactly.
    Compiled program cached per (mesh, static config); scalars travel as
    operands.
    """
    body = _compare_retrieve_body(mesh, k, n_docs, bool(prior_free),
                                  base_rate is not None)
    D_pad = term_ids.shape[0]
    if doc_mask is None:
        mask_pad = jnp.ones((D_pad,), bool)
    else:
        mask_pad = jnp.concatenate([
            jnp.asarray(doc_mask, bool)[:D_pad],
            jnp.ones((max(D_pad - jnp.asarray(doc_mask).shape[0], 0),),
                     bool)])
    mask_pad = jax.device_put(mask_pad, NamedSharding(mesh, P("d")))
    f32 = jnp.float32
    ids, probs, scores, tfs = body(
        term_ids, weights, doc_lengths, qids, qcnt, mask_pad,
        jnp.asarray(alpha, f32), jnp.asarray(beta, f32),
        jnp.asarray(0.0 if base_rate is None else base_rate, f32),
        jnp.asarray(avgdl, f32))
    if return_tfs:
        return ids, probs, scores, tfs
    return ids, probs, scores


@functools.lru_cache(maxsize=None)
def _compare_retrieve_body(mesh, k, n_docs, prior_free, has_base_rate):
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("d", None), P("d", None), P("d"), P(None, None),
                  P(None, None), P("d"), P(), P(), P(), P()),
        out_specs=(P(None, None), P(None, None), P(None, None), P(None, None)),
        # Outputs are replicated by construction (derived from all_gather +
        # replicated params) but the static vma check can't infer that.
        check_vma=False,
    )
    def body(tids, w, dl, qi, qc, mask, alpha, beta, br, avgdl):
        scores, tfs = _local_score(tids, w, qi, qc)
        # doc_mask rides the same 'd' sharding as the corpus: masked docs
        # drop to -inf before the local top-k, exactly as single-chip.
        scores = jnp.where(mask[None, :], scores, -jnp.inf)
        local_k = min(k, tids.shape[0])
        top_s, top_local = _leader_topk(scores, local_k)
        shard = jax.lax.axis_index("d")
        offset = shard * tids.shape[0]
        top_global = top_local + offset
        top_tf = jnp.take_along_axis(tfs, top_local, axis=1)
        top_dl = dl[top_local]
        # Gather candidates from every shard: (n_shards * local_k) per query
        cand_s = jax.lax.all_gather(top_s, "d", axis=1, tiled=True)
        cand_id = jax.lax.all_gather(top_global, "d", axis=1, tiled=True)
        cand_tf = jax.lax.all_gather(top_tf, "d", axis=1, tiled=True)
        cand_dl = jax.lax.all_gather(top_dl, "d", axis=1, tiled=True)
        if n_docs is not None:
            cand_s = jnp.where(cand_id < n_docs, cand_s, -jnp.inf)
        merge_s, merge_pos = jax.lax.top_k(cand_s, k)
        ids = jnp.take_along_axis(cand_id, merge_pos, axis=1)
        tfs_m = jnp.take_along_axis(cand_tf, merge_pos, axis=1)
        dl_m = jnp.take_along_axis(cand_dl, merge_pos, axis=1)
        dead = ~jnp.isfinite(merge_s)
        merge_s = jnp.where(dead, 0.0, merge_s)
        ids = jnp.where(dead, -1, ids)
        probs = T.score_to_probability(
            merge_s, tfs_m, dl_m / avgdl, alpha, beta,
            br if has_base_rate else None,
            prior_free=prior_free,
        )
        probs = jnp.where(merge_s > 0, probs.astype(merge_s.dtype), 0.0)
        return ids, probs, merge_s, tfs_m

    return jax.jit(body)


def corpus_stats_psum(mesh: Mesh, doc_lengths, term_ids, n_terms: int):
    """Global corpus statistics from sharded slabs: (N, avgdl, df).

    df is a per-shard bincount over term ids followed by a psum — the
    sharded equivalent of the reference's host-side counting.
    """

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("d"), P("d", None)),
        out_specs=(P(), P(), P()),
    )
    def body(dl, tids):
        n_local = jnp.asarray(dl.shape[0], jnp.float32)
        n = jax.lax.psum(n_local, "d")
        sum_dl = jax.lax.psum(jnp.sum(dl), "d")
        valid = (tids >= 0).astype(jnp.int32)
        local_df = jnp.zeros(n_terms, jnp.int32).at[
            jnp.clip(tids, 0, n_terms - 1)
        ].add(valid)
        df = jax.lax.psum(local_df, "d")
        return n, sum_dl / n, df

    return body(doc_lengths, term_ids)


def shard_split_index_arrays(mesh: Mesh, split):
    """Place a SplitBM25Index's device arrays doc-sharded over the mesh."""
    doc_sharded = NamedSharding(mesh, P("d", None))
    return (
        jax.device_put(split.dense_impact, doc_sharded),
        jax.device_put(split.dense_presence, doc_sharded),
        jax.device_put(split.tail_term_ids, doc_sharded),
        jax.device_put(split.tail_weights, doc_sharded),
    )


def _lo_operand(mesh: Mesh, dense_impact, impact_lo):
    """The hi/lo residual as a shard_map operand: the real (D_pad, K)
    matrix under hilo/int8 storage, or a zero-width (D_pad, 0) sentinel
    (sharding metadata only — _impact_matmul branches on the static
    width, so the sentinel is never touched)."""
    if impact_lo is not None:
        return impact_lo
    return jnp.zeros((dense_impact.shape[0], 0), jnp.bfloat16)


def _scale_operand(impact_scale):
    """Per-doc int8 dequantization scales as a shard_map operand: the
    real (2, D_pad) f32 array under int8 storage (doc axis sharded), or
    a zero-width (2, 0) sentinel — bodies branch on the static width."""
    if impact_scale is not None:
        return impact_scale
    return jnp.zeros((2, 0), jnp.float32)


def _int8_ok(impact_scale, fcnt) -> bool:
    """Host-side: batch query counts fit int8 (the near-universal case).
    Only consulted under int8 storage; False routes the shard bodies to
    the dequantizing f32 fallback."""
    if impact_scale is None:
        return True
    return float(np.asarray(fcnt).max(initial=0.0)) <= 127.0


def sharded_retrieve_topk_split(mesh: Mesh, dense_impact, dense_presence,
                                tail_ids, tail_w, doc_lengths, avgdl,
                                fslots, fcnt, tail_rows, tail_qids,
                                tail_qcnt, k: int,
                                alpha, beta, base_rate=None,
                                n_docs: int | None = None,
                                prior_free: bool = False,
                                return_tfs: bool = False,
                                precision=jax.lax.Precision.HIGHEST,
                                doc_mask=None, impact_lo=None,
                                impact_scale=None):
    """Distributed top-k over the frequency-split index.

    The frequent-term matmul shards trivially over the doc axis (each shard
    multiplies the replicated query matrix against its slab); the tail
    compare and top-k merge follow the same per-shard + all_gather pattern
    as sharded_retrieve_topk. Compiled program cached per (mesh, static
    config); scalars travel as operands.
    """
    body = _split_retrieve_body(mesh, k, n_docs, bool(prior_free),
                                precision, base_rate is not None,
                                _int8_ok(impact_scale, fcnt))
    D_pad = dense_impact.shape[0]
    if doc_mask is None:
        mask_pad = jnp.ones((D_pad,), bool)
    else:
        m = jnp.asarray(doc_mask, bool)
        mask_pad = jnp.concatenate(
            [m[:D_pad], jnp.ones((max(D_pad - m.shape[0], 0),), bool)])
    mask_pad = jax.device_put(mask_pad, NamedSharding(mesh, P("d")))
    f32 = jnp.float32
    out = body(dense_impact, _lo_operand(mesh, dense_impact, impact_lo),
               _scale_operand(impact_scale),
               dense_presence, tail_ids, tail_w, doc_lengths,
               jnp.asarray(fslots), jnp.asarray(fcnt),
               jnp.asarray(tail_rows), jnp.asarray(tail_qids),
               jnp.asarray(tail_qcnt), mask_pad,
               jnp.asarray(alpha, f32), jnp.asarray(beta, f32),
               jnp.asarray(0.0 if base_rate is None else base_rate, f32),
               jnp.asarray(avgdl, f32))
    if return_tfs:
        return out
    return out[:3]


@functools.lru_cache(maxsize=None)
def _split_retrieve_body(mesh, k, n_docs, prior_free, precision,
                         has_base_rate, q_int8_ok=True):
    from bayesian_bm25_tpu.engine.split_index import (
        _densify_queries, _impact_matmul)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("d", None), P("d", None), P(None, "d"), P("d", None),
                  P("d", None), P("d", None), P("d"), P(None, None),
                  P(None, None), P(None), P(None, None), P(None, None),
                  P("d"), P(), P(), P(), P()),
        out_specs=(P(None, None), P(None, None), P(None, None),
                   P(None, None)),
        check_vma=False,
    )
    def body(imp, lo, sc, pres, tids, tw, dl, fs, fc, trow, tqi, tqc,
             mask, alpha, beta, br, avgdl):
        nq = fs.shape[0]
        qvec, qpres = _densify_queries(fs, fc, imp.shape[1])
        scores = _impact_matmul(qvec, imp, lo, precision,
                                scale=sc if sc.shape[1] else None,
                                q_int8_ok=q_int8_ok)
        t_scores, _ = _local_score(tids, tw, tqi, tqc)
        scores = scores.at[trow].add(t_scores)
        scores = jnp.where(mask[None, :], scores, -jnp.inf)

        local_k = min(k, tids.shape[0])
        top_s, top_local = _leader_topk(scores, local_k)
        offset = jax.lax.axis_index("d") * tids.shape[0]
        top_global = top_local + offset
        # Winner-only tf (same lean reconstruction as the single-chip
        # kernel — no (nq, D_local) dense tf matrix per shard):
        # presence rows at the local winners (exact one-pass bf16) plus
        # the rare-term equality count against the winner's tail row.
        pres_rows = pres[top_local]                   # (nq, lk, K)
        tf_freq = jnp.einsum("nkc,nc->nk", pres_rows,
                             qpres.astype(pres.dtype),
                             precision=jax.lax.Precision.HIGHEST,
                             preferred_element_type=jnp.float32)
        Qt = tqi.shape[1]
        is_pad_row = tqi[:, 0] < 0
        safe_rows = jnp.where(is_pad_row, nq, trow)
        qt_full = jnp.full((nq + 1, Qt), -2, tqi.dtype).at[
            safe_rows].set(tqi)[:nq]
        w_tail = tids[top_local]                      # (nq, lk, T_A)
        tf_tail = jnp.sum(
            (w_tail[:, :, :, None] == qt_full[:, None, None, :])
            .astype(jnp.float32), axis=(2, 3))
        top_tf = tf_freq + tf_tail
        top_dl = dl[top_local]
        cand_s = jax.lax.all_gather(top_s, "d", axis=1, tiled=True)
        cand_id = jax.lax.all_gather(top_global, "d", axis=1, tiled=True)
        cand_tf = jax.lax.all_gather(top_tf, "d", axis=1, tiled=True)
        cand_dl = jax.lax.all_gather(top_dl, "d", axis=1, tiled=True)
        if n_docs is not None:
            cand_s = jnp.where(cand_id < n_docs, cand_s, -jnp.inf)
        merge_s, merge_pos = jax.lax.top_k(cand_s, k)
        ids = jnp.take_along_axis(cand_id, merge_pos, axis=1)
        tfs_m = jnp.take_along_axis(cand_tf, merge_pos, axis=1)
        dl_m = jnp.take_along_axis(cand_dl, merge_pos, axis=1)
        dead = ~jnp.isfinite(merge_s)
        merge_s = jnp.where(dead, 0.0, merge_s)
        ids = jnp.where(dead, -1, ids)
        probs = T.score_to_probability(
            merge_s, tfs_m, dl_m / avgdl, alpha, beta,
            br if has_base_rate else None,
            prior_free=prior_free,
        )
        probs = jnp.where(merge_s > 0, probs.astype(merge_s.dtype), 0.0)
        return ids, probs, merge_s, tfs_m

    return jax.jit(body)


def sharded_retrieve_topk_split_sparse(
        mesh: Mesh, dense_impact, dense_presence, post_ids_sh, post_w_sh,
        doc_lengths, avgdl, fslots, fcnt, tail_rows, tail_slots, tail_qcnt,
        k: int, cand_cap: int, alpha, beta, base_rate=None,
        n_docs: int | None = None, prior_free: bool = False,
        approx: bool = False, precision=jax.lax.Precision.HIGHEST,
        doc_mask=None, impact_lo=None, local_k: int | None = None,
        tf_from_sign: bool = False, compact=None, compact_rmax: int = 0,
        impact_scale=None,
        post2_ids_sh=None, post2_w_sh=None, tailB_rows=None,
        tailB_slots=None, tailB_qcnt=None, tailB_slots2=None,
        tailB_qcnt2=None, cand_cap2: int = 0,
        tailH_rows=None, tailH_slots=None, tailH_qcnt=None,
        cand_capH: int = 0, compactH=None, compactH_rmax: int = 0):
    """Distributed sparse-candidate exact top-k (the fastest single-chip
    kernel, doc-sharded): per shard, one matmul + local leader
    selection + rare-postings merge against the SHARD-LOCAL postings
    (engine/split_index.py:build_sharded_postings — postings shard
    naturally by doc range), then an all_gather of each shard's k
    winners and a k-way merge.

    Exact like the single-chip kernel: the global top-k is contained in
    the union of per-shard top-k sets, per-shard merges visit entries in
    the same ascending order as the single-chip merge restricted to the
    shard's range, and shard-major candidate order preserves the
    lowest-doc-id tie-break. ``approx=True`` swaps the per-shard
    matmul-side leader selection for lax.approx_max_k (the rare merge
    stays exact). Ref intent: scorer.py:525-529 retrieve parity.

    Merge-cost model: each query ships local_k candidates x 16 bytes
    (score, id, tf, dl) per shard between devices — k*n_shards*16
    B/query at the exact default, independent of corpus size. ``local_k`` < k is a
    recall trade for very large k protocols (e.g. the reference's
    R=1000 candidate unions, hybrid_beir.py:1747): per-shard candidate
    lists shrink to local_k and the merge reduces from k*n_shards to
    local_k*n_shards values; exactness then requires the true top-k to
    never concentrate more than local_k docs on one shard (guaranteed
    only at local_k = k, the default).

    The compiled program is cached per (mesh, static config): transform
    scalars travel as operands, so repeated serving calls re-dispatch
    the same executable instead of re-tracing (a per-call body closure
    recompiled EVERY retrieve).

    Width-capped indexes (tier-2 rectangle active) run the SAME
    two-pass merge as the single-chip kernel: group-B rows (those
    carrying over-cap rare terms) get a second shard-local merge pass
    against the doc-sharded tier-2 tables
    (``build_sharded_postings2``); the light/heavy cap split likewise
    adds a shard-local heavy pass. Pass ``cand_cap2 > 0`` with the
    tailB operands / ``cand_capH > 0`` with the tailH operands to
    engage them (both 0 = single-pass, the uncapped common case).
    """
    D_pad = dense_impact.shape[0]
    n_real = n_docs if n_docs is not None else D_pad
    lk = min(local_k or k, k)
    # The rank-packed candidate build is shard-invariant: per-shard
    # postings tables keep the global row indexing (a term's row may be
    # all-sentinel in a shard, which packs to the same sentinel content
    # the dense build gathers), so one host compaction serves every
    # shard as replicated operands.
    rmax = compact_rmax if compact is not None else 0
    rmaxH = compactH_rmax if compactH is not None else 0
    body = _sparse_retrieve_body(
        mesh, k, lk, cand_cap, n_real, bool(prior_free), bool(approx),
        precision, base_rate is not None, bool(tf_from_sign), rmax,
        _int8_ok(impact_scale, fcnt), cand_cap2, cand_capH, rmaxH)

    # Sharded validity mask: real docs pass their doc_mask bit; global
    # pad docs always drop.
    col = np.arange(D_pad)
    base_mask = col < n_real
    if doc_mask is not None:
        m = np.asarray(doc_mask, bool)
        base_mask = base_mask & np.concatenate(
            [m[:D_pad], np.ones(max(D_pad - m.shape[0], 0), bool)])
    mask_pad = jax.device_put(jnp.asarray(base_mask),
                              NamedSharding(mesh, P("d")))
    f32 = jnp.float32
    i32 = jnp.int32
    cpk = (jnp.asarray(compact) if rmax
           else jnp.zeros((3, 1), jnp.int32))
    cpkH = (jnp.asarray(compactH) if rmaxH
            else jnp.zeros((3, 1), jnp.int32))
    n_sh = int(mesh.shape["d"])

    def _opt(a, dtype, shape):
        return jnp.asarray(a) if a is not None else jnp.zeros(shape, dtype)

    pid2 = _opt(post2_ids_sh, i32, (n_sh, 1, 1))
    pw2 = _opt(post2_w_sh, f32, (n_sh, 1, 1))
    return body(dense_impact, _lo_operand(mesh, dense_impact, impact_lo),
                _scale_operand(impact_scale),
                dense_presence, post_ids_sh, post_w_sh, doc_lengths,
                jnp.asarray(fslots), jnp.asarray(fcnt),
                jnp.asarray(tail_rows), jnp.asarray(tail_slots),
                jnp.asarray(tail_qcnt), cpk, mask_pad,
                pid2, pw2,
                _opt(tailB_rows, i32, (1,)),
                _opt(tailB_slots, i32, (1, 1)),
                _opt(tailB_qcnt, f32, (1, 1)),
                _opt(tailB_slots2, i32, (1, 1)),
                _opt(tailB_qcnt2, f32, (1, 1)),
                _opt(tailH_rows, i32, (1,)),
                _opt(tailH_slots, i32, (1, 1)),
                _opt(tailH_qcnt, f32, (1, 1)), cpkH,
                jnp.asarray(alpha, f32), jnp.asarray(beta, f32),
                jnp.asarray(0.0 if base_rate is None else base_rate, f32),
                jnp.asarray(avgdl, f32))


@functools.lru_cache(maxsize=None)
def _sparse_retrieve_body(mesh, k, lk, cand_cap, n_real, prior_free,
                          approx, precision, has_base_rate,
                          tf_from_sign=False, compact_rmax=0,
                          q_int8_ok=True, cand_cap2=0, cand_capH=0,
                          compactH_rmax=0):
    """Compiled per-shard sparse retrieve, cached on the static config
    (mesh + shape/selection parameters). Scalars are operands;
    ``compact_rmax`` > 0 switches the merge to the rank-packed
    candidate build (flat compaction arrays travel replicated);
    ``cand_capH``/``cand_cap2`` > 0 compile the light/heavy and tier-2
    merge passes (same pass structure as the single-chip kernel,
    shard-local postings)."""
    from bayesian_bm25_tpu.engine.split_index import (
        _densify_queries, _impact_matmul, _sparse_merge)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("d", None), P("d", None), P(None, "d"), P("d", None),
                  P("d", None, None), P("d", None, None), P("d"),
                  P(None, None), P(None, None), P(None), P(None, None),
                  P(None, None), P(None, None), P("d"),
                  P("d", None, None), P("d", None, None),
                  P(None), P(None, None), P(None, None),
                  P(None, None), P(None, None),
                  P(None), P(None, None), P(None, None), P(None, None),
                  P(), P(), P(), P()),
        out_specs=(P(None, None), P(None, None), P(None, None),
                   P(None, None)),
        check_vma=False,
    )
    def body(imp, lo, sc, pres, pid3, pw3, dl, fs, fc, trow, tsl, tqc,
             cpk, mask, pid2_3, pw2_3, trowB, tslB, tqcB, tsl2B, tqc2B,
             trowH, tslH, tqcH, cpkH, alpha, beta, br, avgdl):
        pid = pid3[0]
        pw = pw3[0]
        qvec, qpres = _densify_queries(fs, fc, imp.shape[1])
        scores = _impact_matmul(qvec, imp, lo, precision,
                                scale=sc if sc.shape[1] else None,
                                q_int8_ok=q_int8_ok)
        D_local = imp.shape[0]
        off = jax.lax.axis_index("d") * D_local
        # Global pad docs and doc_mask both arrive via the sharded mask;
        # drop them before leader selection so they can neither lead nor
        # win through postings (postings contain only real docs).
        scores = jnp.where(mask[None, :], scores, -jnp.inf)
        if approx:
            topm_s, topm_i = jax.lax.approx_max_k(scores, lk)
        else:
            topm_s, topm_i = _leader_topk(scores, lk)
        out_ids, out_scores, out_tail_tf = _sparse_merge(
            scores, topm_s, topm_i, pid, pw, trow, tsl, tqc, lk,
            cand_cap, D_local, tf_from_sign=tf_from_sign,
            compact=(cpk, compact_rmax) if compact_rmax else None)
        if cand_capH:
            # Heavy pass (light/heavy cap split) — same composition as
            # the single-chip kernel: disjoint rows scatter over the
            # light pass's output at their own (wider) cap.
            out_ids, out_scores, out_tail_tf = _sparse_merge(
                scores, out_scores, out_ids, pid, pw, trowH, tslH, tqcH,
                lk, cand_capH, D_local, tf_from_sign=tf_from_sign,
                compact=(cpkH, compactH_rmax) if compactH_rmax else None,
                base_tail_tf=out_tail_tf)
        if cand_cap2:
            # Tier-2 pass (width-capped indexes): group-B rows merge
            # lk leaders ++ their shard-local tier-1 ++ tier-2 postings
            # in one candidate set, so a doc scored by terms from both
            # tiers sums exactly within the shard.
            pid2 = pid2_3[0]
            pw2 = pw2_3[0]
            R2 = pid2.shape[0] - 1
            out_ids, out_scores, out_tail_tf = _sparse_merge(
                scores, out_scores, out_ids, pid, pw, trowB, tslB, tqcB,
                lk, cand_cap2, D_local, tf_from_sign=tf_from_sign,
                postings2=(pid2, pw2, tsl2B, tqc2B),
                pad_row_mask=jnp.all(tsl2B >= R2, axis=1),
                base_tail_tf=out_tail_tf)

        safe = jnp.maximum(out_ids, 0)
        pres_rows = pres[safe]  # (nq, k, K)
        tf_freq = jnp.einsum("nkc,nc->nk", pres_rows,
                             qpres.astype(pres.dtype),
                             precision=jax.lax.Precision.HIGHEST,
                             preferred_element_type=jnp.float32)
        local_tf = tf_freq + out_tail_tf
        local_dl = dl[safe]
        gids = out_ids + off

        cand_s = jax.lax.all_gather(out_scores, "d", axis=1, tiled=True)
        cand_id = jax.lax.all_gather(gids, "d", axis=1, tiled=True)
        cand_tf = jax.lax.all_gather(local_tf, "d", axis=1, tiled=True)
        cand_dl = jax.lax.all_gather(local_dl, "d", axis=1, tiled=True)
        merge_s, merge_pos = jax.lax.top_k(cand_s, min(k, cand_s.shape[1]))
        ids = jnp.take_along_axis(cand_id, merge_pos, axis=1)
        tfs_m = jnp.take_along_axis(cand_tf, merge_pos, axis=1)
        dl_m = jnp.take_along_axis(cand_dl, merge_pos, axis=1)
        dead = ~jnp.isfinite(merge_s) | (ids >= n_real) | (ids < 0)
        merge_s = jnp.where(dead, 0.0, merge_s)
        ids = jnp.where(dead, -1, ids)
        probs = T.score_to_probability(
            merge_s, tfs_m, dl_m / avgdl, alpha, beta,
            br if has_base_rate else None,
            prior_free=prior_free,
        )
        probs = jnp.where(merge_s > 0, probs.astype(merge_s.dtype), 0.0)
        return ids, probs, merge_s, tfs_m

    return jax.jit(body)


def sharded_retrieve_topk_split_2d(mesh: Mesh, dense_impact, dense_presence,
                                   tail_ids, tail_w, doc_lengths, avgdl,
                                   fslots, fcnt, tail_rows, tail_qids,
                                   tail_qcnt, k: int,
                                   alpha, beta, base_rate=None,
                                   n_docs: int | None = None,
                                   prior_free: bool = False,
                                   precision=jax.lax.Precision.HIGHEST,
                                   impact_lo=None, approx: bool = False,
                                   doc_mask=None, impact_scale=None):
    """Frequency-split top-k on a (query x document) 2-D mesh.

    The dp x tp analogue on the production kernel: the query batch shards
    over 'q' (each device row serves its slice), the split tables over
    'd'. The tail group (rows of queries with rare terms) is replicated;
    each q-tile scatters only the rows that fall inside its local query
    slice — out-of-slice (and pad) rows target a trash row, contributing
    nothing, so every tail row lands exactly once across the 'q' axis.
    Candidates all_gather over 'd' only; outputs stay q-sharded.
    Compiled program cached per (mesh, static config).
    """
    body = _split_retrieve_2d_body(mesh, k, n_docs, bool(prior_free),
                                   precision, bool(approx),
                                   base_rate is not None,
                                   _int8_ok(impact_scale, fcnt))
    D_pad = dense_impact.shape[0]
    col = np.arange(D_pad)
    base_mask = col < (n_docs if n_docs is not None else D_pad)
    if doc_mask is not None:
        m = np.asarray(doc_mask, bool)
        base_mask = base_mask & np.concatenate(
            [m[:D_pad], np.ones(max(D_pad - m.shape[0], 0), bool)])
    mask_pad = jax.device_put(jnp.asarray(base_mask),
                              NamedSharding(mesh, P("d")))
    f32 = jnp.float32
    out = body(dense_impact, _lo_operand(mesh, dense_impact, impact_lo),
               _scale_operand(impact_scale),
               dense_presence, tail_ids, tail_w, doc_lengths,
               jnp.asarray(fslots), jnp.asarray(fcnt),
               jnp.asarray(tail_rows), jnp.asarray(tail_qids),
               jnp.asarray(tail_qcnt), mask_pad,
               jnp.asarray(alpha, f32), jnp.asarray(beta, f32),
               jnp.asarray(0.0 if base_rate is None else base_rate, f32),
               jnp.asarray(avgdl, f32))
    return out[:3]


@functools.lru_cache(maxsize=None)
def _split_retrieve_2d_body(mesh, k, n_docs, prior_free, precision, approx,
                            has_base_rate, q_int8_ok=True):
    from bayesian_bm25_tpu.engine.split_index import (
        _densify_queries, _impact_matmul)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("d", None), P("d", None), P(None, "d"), P("d", None),
                  P("d", None), P("d", None), P("d"), P("q", None),
                  P("q", None), P(None), P(None, None), P(None, None),
                  P("d"), P(), P(), P(), P()),
        out_specs=(P("q", None), P("q", None), P("q", None), P("q", None)),
        check_vma=False,
    )
    def body(imp, lo, sc, pres, tids, tw, dl, fs, fc, trow, tqi, tqc,
             mask, alpha, beta, br, avgdl):
        qvec, qpres = _densify_queries(fs, fc, imp.shape[1])
        scores = _impact_matmul(qvec, imp, lo, precision,
                                scale=sc if sc.shape[1] else None,
                                q_int8_ok=q_int8_ok)
        tfs = jnp.dot(qpres.astype(pres.dtype), pres.T,
                      preferred_element_type=jnp.float32)
        t_scores, t_tfs = _local_score(tids, tw, tqi, tqc)
        nq_local = fs.shape[0]
        q_off = jax.lax.axis_index("q") * nq_local
        local_row = trow - q_off
        in_slice = (local_row >= 0) & (local_row < nq_local)
        row_safe = jnp.where(in_slice, local_row, nq_local)  # trash row
        D_local = scores.shape[1]
        scores = jnp.concatenate(
            [scores, jnp.zeros((1, D_local), scores.dtype)]
        ).at[row_safe].add(t_scores)[:nq_local]
        tfs = jnp.concatenate(
            [tfs, jnp.zeros((1, D_local), tfs.dtype)]
        ).at[row_safe].add(t_tfs)[:nq_local]
        scores = jnp.where(mask[None, :], scores, -jnp.inf)

        local_k = min(k, tids.shape[0])
        if approx:
            top_s, top_local = jax.lax.approx_max_k(scores, local_k)
        else:
            top_s, top_local = _leader_topk(scores, local_k)
        offset = jax.lax.axis_index("d") * tids.shape[0]
        top_global = top_local + offset
        top_tf = jnp.take_along_axis(tfs, top_local, axis=1)
        top_dl = dl[top_local]
        cand_s = jax.lax.all_gather(top_s, "d", axis=1, tiled=True)
        cand_id = jax.lax.all_gather(top_global, "d", axis=1, tiled=True)
        cand_tf = jax.lax.all_gather(top_tf, "d", axis=1, tiled=True)
        cand_dl = jax.lax.all_gather(top_dl, "d", axis=1, tiled=True)
        if n_docs is not None:
            cand_s = jnp.where(cand_id < n_docs, cand_s, -jnp.inf)
        merge_s, merge_pos = jax.lax.top_k(cand_s, k)
        ids = jnp.take_along_axis(cand_id, merge_pos, axis=1)
        tfs_m = jnp.take_along_axis(cand_tf, merge_pos, axis=1)
        dl_m = jnp.take_along_axis(cand_dl, merge_pos, axis=1)
        dead = ~jnp.isfinite(merge_s)
        merge_s = jnp.where(dead, 0.0, merge_s)
        ids = jnp.where(dead, -1, ids)
        probs = T.score_to_probability(
            merge_s, tfs_m, dl_m / avgdl, alpha, beta,
            br if has_base_rate else None,
            prior_free=prior_free,
        )
        probs = jnp.where(merge_s > 0, probs.astype(merge_s.dtype), 0.0)
        return ids, probs, merge_s, tfs_m

    return jax.jit(body)


def sharded_scores_all(mesh: Mesh, term_ids, weights, qids, qcnt):
    """Dense (nq, D) BM25 scores + unique-overlap tf over the sharded
    corpus; outputs stay document-sharded along axis 1 (no gather — the
    host assembles on pull, or downstream sharded ops consume in place)."""

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("d", None), P("d", None), P(None, None), P(None, None)),
        out_specs=(P(None, "d"), P(None, "d")),
        check_vma=False,
    )
    def body(tids, w, qi, qc):
        return _local_score(tids, w, qi, qc)

    return body(term_ids, weights, qids, qcnt)


def sharded_probabilities_all(mesh: Mesh, term_ids, weights, doc_lengths,
                              avgdl, qids, qcnt, alpha, beta,
                              base_rate=None, prior_free: bool = False):
    """Dense calibrated probabilities (nq, D) over the sharded corpus,
    document-sharded along axis 1. Pad rows keep probability 0 (score 0)."""

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("d", None), P("d", None), P("d"),
                  P(None, None), P(None, None)),
        out_specs=P(None, "d"),
        check_vma=False,
    )
    def body(tids, w, dl, qi, qc):
        scores, tfs = _local_score(tids, w, qi, qc)
        dlr = (dl / avgdl)[None, :]
        probs = T.score_to_probability(
            scores, tfs, dlr, alpha, beta, base_rate, prior_free=prior_free
        )
        return jnp.where(scores > 0, probs.astype(scores.dtype), 0.0)

    return body(term_ids, weights, doc_lengths, qids, qcnt)


def sharded_scores_all_split(mesh: Mesh, dense_impact, dense_presence,
                             tail_ids, tail_w, fslots, fcnt, tail_rows,
                             tail_qids, tail_qcnt,
                             precision=jax.lax.Precision.HIGHEST,
                             impact_lo=None, impact_scale=None):
    """Dense (nq, D) scores + tf via the frequency-split kernel, sharded
    over the document axis (axis 1 of the outputs). Bit-identical per
    element to the single-chip split kernel: each shard's matmul computes
    the same row dot products, and the tail compare adds locally.
    Compiled program cached per (mesh, precision)."""
    body = _scores_all_split_body(mesh, precision,
                                  _int8_ok(impact_scale, fcnt))
    return body(dense_impact, _lo_operand(mesh, dense_impact, impact_lo),
                _scale_operand(impact_scale),
                dense_presence, tail_ids, tail_w,
                jnp.asarray(fslots), jnp.asarray(fcnt),
                jnp.asarray(tail_rows), jnp.asarray(tail_qids),
                jnp.asarray(tail_qcnt))


@functools.lru_cache(maxsize=None)
def _scores_all_split_body(mesh, precision, q_int8_ok=True):
    from bayesian_bm25_tpu.engine.split_index import (
        _densify_queries, _impact_matmul)

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("d", None), P("d", None), P(None, "d"), P("d", None),
                  P("d", None), P("d", None), P(None, None), P(None, None),
                  P(None), P(None, None), P(None, None)),
        out_specs=(P(None, "d"), P(None, "d")),
        check_vma=False,
    )
    def body(imp, lo, sc, pres, tids, tw, fs, fc, trow, tqi, tqc):
        qvec, qpres = _densify_queries(fs, fc, imp.shape[1])
        scores = _impact_matmul(qvec, imp, lo, precision,
                                scale=sc if sc.shape[1] else None,
                                q_int8_ok=q_int8_ok)
        tfs = jnp.dot(qpres.astype(pres.dtype), pres.T,
                      preferred_element_type=jnp.float32)
        t_scores, t_tfs = _local_score(tids, tw, tqi, tqc)
        scores = scores.at[trow].add(t_scores)
        tfs = tfs.at[trow].add(t_tfs)
        return scores, tfs

    return jax.jit(body)


def apply_transform_sharded(mesh: Mesh, scores, tfs, doc_lengths, avgdl,
                            alpha, beta, base_rate=None,
                            prior_free: bool = False):
    """Dense probabilities from (document-sharded) dense scores/tf."""

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(None, "d"), P(None, "d"), P("d")),
        out_specs=P(None, "d"),
        check_vma=False,
    )
    def body(s, tf, dl):
        dlr = (dl / avgdl)[None, :]
        probs = T.score_to_probability(
            s, tf, dlr, alpha, beta, base_rate, prior_free=prior_free
        )
        return jnp.where(s > 0, probs.astype(s.dtype), 0.0)

    return body(scores, tfs, doc_lengths)


def sharded_fit_transform(mesh: Mesh, scores, labels, *, alpha0=1.0,
                          beta0=0.0, prior_aware: bool = False, priors=None,
                          learning_rate: float = 0.01,
                          max_iterations: int = 1000,
                          tolerance: float = 1e-6):
    """Data-parallel transform fit: samples shard over the mesh, the GD
    while_loop runs with psum-averaged gradients — numerically identical to
    the single-device fit on the concatenated sample (tested).

    This is the multichip form of BayesianProbabilityTransform.fit: use it
    when the (score, label) training pool itself is too large for one chip
    or already lives sharded next to a sharded corpus.
    """
    from bayesian_bm25_tpu.ops.transform import _bce_grads

    n_total = scores.shape[0]

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("d"), P("d"), P("d")),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def body(s, y, p):
        dt = jnp.float32
        s = s.astype(dt)
        y = y.astype(dt)
        p = p.astype(dt)
        ones = jnp.ones_like(s)
        n_local = s.shape[0]

        def grads(a, b):
            # local mean grads scaled to local weight, then psum-average
            # (cast back: mathx promotes to f64 when x64 is on)
            g_a, g_b = _bce_grads(a, b, s, y, p, ones, prior_aware)
            g_a = jax.lax.psum(g_a.astype(dt) * n_local, "d") / n_total
            g_b = jax.lax.psum(g_b.astype(dt) * n_local, "d") / n_total
            return g_a, g_b

        lr = jnp.asarray(learning_rate, dt)
        tol = jnp.asarray(tolerance, dt)

        def cond(state):
            _, _, done, it = state
            return jnp.logical_and(~done, it < max_iterations)

        def step(state):
            a, b, _, it = state
            g_a, g_b = grads(a, b)
            na = a - lr * g_a
            nb = b - lr * g_b
            done = jnp.logical_and(jnp.abs(na - a) < tol,
                                   jnp.abs(nb - b) < tol)
            return na, nb, done, it + 1

        a, b, _, it = jax.lax.while_loop(
            cond, step,
            (jnp.asarray(alpha0, dt), jnp.asarray(beta0, dt),
             jnp.asarray(False), jnp.asarray(0)),
        )
        return a, b, it

    priors_arr = (jnp.zeros_like(jnp.asarray(scores)) if priors is None
                  else jnp.asarray(priors))
    return body(jnp.asarray(scores), jnp.asarray(labels), priors_arr)


def sharded_train_step(mesh: Mesh, term_ids, weights, doc_lengths, avgdl,
                       qids, qcnt, labels, alpha, beta,
                       learning_rate: float = 0.01):
    """One full training step over the sharded corpus.

    Scores the query batch against the local doc shard, evaluates the BCE
    loss of the transform's likelihood against (replicated) per-(query, doc)
    labels, psums the gradient contributions across shards, and applies one
    GD step to (alpha, beta) — the multi-chip analogue of
    BayesianProbabilityTransform.fit's inner iteration.
    """

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("d", None), P("d", None), P("d"),
                  P(None, None), P(None, None), P(None, "d")),
        out_specs=(P(), P(), P()),
    )
    def body(tids, w, dl, qi, qc, y):
        scores, _ = _local_score(tids, w, qi, qc)

        def loss_fn(params):
            a, b = params
            L = clamp_probability(sigmoid(a * (scores - b)))
            bce = -(y * jnp.log(L) + (1.0 - y) * jnp.log1p(-L))
            total = jax.lax.psum(jnp.sum(bce), "d")
            count = jax.lax.psum(jnp.asarray(bce.size, bce.dtype), "d")
            return total / count

        loss, grads = jax.value_and_grad(loss_fn)((alpha, beta))
        g_a, g_b = grads
        return alpha - learning_rate * g_a, beta - learning_rate * g_b, loss

    return body(term_ids, weights, doc_lengths, qids, qcnt, labels)


def sharded_train_step_split(mesh: Mesh, dense_impact, dense_presence,
                             tail_ids, tail_w, fslots, fcnt, tail_rows,
                             tail_qids, tail_qcnt, labels, alpha, beta,
                             learning_rate: float = 0.01,
                             precision=jax.lax.Precision.HIGHEST,
                             impact_lo=None, impact_scale=None):
    """sharded_train_step on the frequency-split scoring path.

    Same psum'd-BCE GD step, but the per-shard scores come from the
    production split kernel (matmul + tail compare) instead of the
    doc-major compare sweep — the training step then exercises exactly
    the kernels that serve. ``labels`` is (nq, D_pad) sharded over 'd'
    along axis 1, matching the score layout.
    """
    from bayesian_bm25_tpu.engine.split_index import (
        _densify_queries, _impact_matmul)

    q_int8_ok = _int8_ok(impact_scale, fcnt)

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("d", None), P("d", None), P(None, "d"), P("d", None),
                  P("d", None), P("d", None), P(None, None), P(None, None),
                  P(None), P(None, None), P(None, None), P(None, "d")),
        out_specs=(P(), P(), P()),
    )
    def body(imp, lo, sc, pres, tids, tw, fs, fc, trow, tqi, tqc, y):
        qvec, qpres = _densify_queries(fs, fc, imp.shape[1])
        scores = _impact_matmul(qvec, imp, lo, precision,
                                scale=sc if sc.shape[1] else None,
                                q_int8_ok=q_int8_ok)
        t_scores, _ = _local_score(tids, tw, tqi, tqc)
        scores = scores.at[trow].add(t_scores)

        def loss_fn(params):
            a, b = params
            L = clamp_probability(sigmoid(a * (scores - b)))
            bce = -(y * jnp.log(L) + (1.0 - y) * jnp.log1p(-L))
            total = jax.lax.psum(jnp.sum(bce), "d")
            count = jax.lax.psum(jnp.asarray(bce.size, bce.dtype), "d")
            return total / count

        loss, grads = jax.value_and_grad(loss_fn)((alpha, beta))
        g_a, g_b = grads
        return alpha - learning_rate * g_a, beta - learning_rate * g_b, loss

    return body(dense_impact, _lo_operand(mesh, dense_impact, impact_lo),
                _scale_operand(impact_scale),
                dense_presence, tail_ids, tail_w,
                jnp.asarray(fslots), jnp.asarray(fcnt),
                jnp.asarray(tail_rows), jnp.asarray(tail_qids),
                jnp.asarray(tail_qcnt), labels)
