"""Frequency-split BM25 index: a matmul for frequent terms + compare
kernel for the rare tail.

The doc-major compare kernel (engine/scoring.py) does O(D * T * Q)
elementwise work per batch regardless of term frequency. On real corpora term frequencies
are Zipf: the top-K vocabulary terms cover almost all per-doc unique terms
(~88% at K=1024 on a Zipf(1.3) corpus), and almost all query terms. This
index exploits that split:

  * frequent terms -> a dense (D, K) *impact matrix* (BM25 contribution of
    frequent-term k in doc d, 0 when absent). Scoring a query batch is
    one (nq, K) @ (K, D) matmul — tensor-core work (cuBLAS GEMMs) — where
    the query side is a scattered count vector over the frequent slots.
  * rare terms -> the doc-major compare table, narrowed to each doc's
    rare terms only (~3-8x narrower than the full table), evaluated only
    for the subset of queries that contain a rare term.

Unique-overlap tf for the transform's prior is computed the same way: a
presence matrix matmul for frequent terms + the tail compare's count.
Scores and tf are exactly equal to the single-table path (tested); the
split is a pure performance transform, like the sharding layer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from bayesian_bm25_tpu.engine import index as eidx
from bayesian_bm25_tpu.engine.index import BM25Index


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Rank-packed candidate build for the sparse merge (see
# compact_tail_postings). Module flag so benchmarks can A/B the scorer
# path; packed engages only when it actually narrows the layout. Its
# speed on the H100 is not yet measured; ids are bit-identical either
# way.
PACKED_BUILD = True

# Light/heavy cap split of the tier-1 tail group (split_light_heavy):
# the candidate cap is set by the HEAVIEST row in the batch, so one
# query carrying a high-df rare term forces every tail row through a
# wide sbase gather + sort. Splitting the group into a narrow-cap
# light pass and a wide-cap heavy pass cuts total gathered elements
# ~3x at 1M docs. Engages only when the element savings clear the
# second merge dispatch's fixed cost (the 50k headline regime never
# splits: its whole gather is ~1M elements).
LIGHT_HEAVY = True
_LH_MIN_SAVE = 1_000_000   # min gathered-element savings to engage
_LH_MIN_RATIO = 2.0        # min (no-split / split) element ratio
# Tier-2 (group B) cap split: B groups are small (hundreds of rows) but
# run at the widest caps in the kernel, so the savings floor is lower.
_LHB_MIN_SAVE = 250_000
_LHB_MIN_RATIO = 1.3

# Unique-key candidate sort: XLA implements a STABLE sort by appending
# an iota tiebreak operand, so the shipped stable (id, v) sort moves
# three arrays through the bitonic network. Packing (id, column) into
# one uint32 key — id * W + col, W = next pow2 >= C — makes every key
# unique, and unique keys reproduce the stable order exactly (equal
# ids order by column = original concat position), so an UNSTABLE
# 2-operand sort returns bit-identical (sid, sv). Engages only when
# (D_pad + 1) * W fits uint32 (50k serving: 26 bits; 1M tier-1: ~32;
# the 1M tier-2 merge at cap2 ~8k overflows and keeps the stable
# path). Its gain over the stable sort on the H100 is not yet measured.
UNIQUE_KEY_SORT = True


@dataclass
class SplitBM25Index:
    """Frequency-split device index built from a BM25Index."""

    base: BM25Index
    n_frequent: int
    # host: term id -> frequent slot (or n_frequent if rare)
    freq_slot_of_term: np.ndarray = field(repr=False)
    # device: (D_pad, K) impact + presence matrices for frequent terms.
    # Under "hilo" storage dense_impact holds the bf16 high halves and
    # dense_impact_lo the bf16 residuals (impact ~= hi + lo to ~8e-6
    # relative); scoring is then two exact-operand bf16 matmul passes.
    dense_impact: jnp.ndarray = field(repr=False)
    dense_presence: jnp.ndarray = field(repr=False)
    # device: narrow doc-major table for rare terms (first T_A per doc)
    tail_term_ids: jnp.ndarray = field(repr=False)
    tail_weights: jnp.ndarray = field(repr=False)
    # device: bf16 residuals of the impact matrix under "hilo" storage
    # (None for f32/bf16 storage)
    dense_impact_lo: jnp.ndarray | None = field(repr=False, default=None)
    # device: overflow rows for the few docs with more rare terms:
    # (n_over, T_B) tables + their global doc ids
    over_term_ids: jnp.ndarray = field(repr=False, default=None)
    over_weights: jnp.ndarray = field(repr=False, default=None)
    over_doc_ids: jnp.ndarray = field(repr=False, default=None)
    # term-major rare postings for the sparse-candidate retrieve path:
    # (R+1, P) doc ids (sentinel D_pad) + weights; row R is the empty row
    # that QUERY_PAD tail slots map to. None when over budget.
    rare_slot_of_term: np.ndarray = field(repr=False, default=None)
    post_doc_ids: jnp.ndarray = field(repr=False, default=None)
    post_weights: jnp.ndarray = field(repr=False, default=None)
    # host: true postings length (df) per rare slot, for candidate sizing
    rare_df: np.ndarray = field(repr=False, default=None)
    # host: True when every real rare-postings weight is > 0 (always for
    # lucene/atire IDF; robertson can go negative on tiny corpora where
    # df > N/2). Lets the sparse merge derive tf counts from the sign of
    # the sorted contributions instead of co-sorting a third operand.
    post_w_positive: bool = False
    # Tier-2 postings: when the tier-1 rectangle is width-capped by the
    # entries budget (huge corpora), the few rare terms whose df exceeds
    # the cap move to a SECOND term-major rectangle (R2+1 rows, width
    # P2 = max over-cap df) — narrow-but-tall instead of wide-but-short,
    # so its footprint stays tiny (1M-doc reference regime: ~1.8k terms
    # x 3.8k width = 54 MB). Queries carrying tier-2 terms are merged in
    # a second _sparse_merge pass over only those rows. None when every
    # rare term fits the tier-1 budget.
    rare2_slot_of_term: np.ndarray | None = field(repr=False, default=None)
    post2_doc_ids: jnp.ndarray | None = field(repr=False, default=None)
    post2_weights: jnp.ndarray | None = field(repr=False, default=None)
    rare2_df: np.ndarray | None = field(repr=False, default=None)
    # device: (2, D_pad) per-doc dequantization scales under "int8"
    # storage (impact ~= scale[0]*hi + scale[1]*lo, elementwise per doc
    # row); None otherwise. The scales multiply the SCORE columns
    # (score_d = s_d*hidot_d + s2_d*lodot_d), so both matmul passes run
    # as integer GEMMs with exact int32 accumulation.
    impact_scale: jnp.ndarray | None = field(repr=False, default=None)

    @property
    def n_docs(self) -> int:
        return self.base.n_docs

    @property
    def vocab(self) -> dict:
        return self.base.vocab


def build_split_index(
    base: BM25Index,
    n_frequent: int = 1024,
    *,
    dtype=jnp.float32,
    storage: str | None = None,
    tail_pad_multiple: int = 8,
    enable_overflow: bool | str = "auto",
) -> SplitBM25Index:
    """Split the doc-major table by document frequency rank.

    ``storage`` selects the impact-matrix representation:
      * "f32"  — float32 matrix; the matmul precision at score time
        picks the algorithm (one TF32 pass / three bf16 passes / full
        f32 for default/high/highest).
      * "hilo" — bf16 (hi, lo) pair with lo = bf16(impact - f32(hi)).
        Scoring is TWO exact-operand bf16 passes: query count vectors
        are small integers (exact in bf16), so the only error is the
        ~8e-6-relative hi+lo representation — the f32 HIGH class at
        two passes instead of three.
      * "bf16" — single bf16 matrix, one pass, ~4e-3 relative; halves
        device memory so K stays large on huge corpora.
      * "int8" — (hi, lo) int8 pair with a per-doc f32 scale
        (impact ~= scale * (hi + lo/128), ~3e-5 of the doc's max
        weight). Query count vectors are small integers (exact in
        int8), so scoring is two int8 x int8 -> int32 GEMMs with exact
        integer accumulation, and the matrix pair is the same 2
        bytes/element as one bf16 copy.
    ``None`` infers from ``dtype`` (float32 -> "f32", bfloat16 ->
    "bf16") for backward compatibility.

    ``enable_overflow="auto"`` spills outlier docs' rare terms into a
    second table only when it is likely to win: the scatter-add of
    overflow scores back into the (nq, D) matrix costs more than a
    moderately wider single table, so the spill engages only when the
    p90 width is at least 2x narrower than the max AND outliers are
    <= D/256.
    """
    if storage is None:
        storage = "bf16" if dtype == jnp.bfloat16 else "f32"
    if storage not in ("f32", "hilo", "bf16", "int8"):
        raise ValueError(
            f"storage must be f32/hilo/bf16/int8, got {storage!r}")
    # Host mirrors avoid a device->host pull of the full table
    tids = (base.term_ids_host if base.term_ids_host is not None
            else np.asarray(base.term_ids))
    w = (base.weights_host if base.weights_host is not None
         else np.asarray(base.weights))
    D_pad, T = tids.shape
    V = base.n_terms

    K = min(_round_up(n_frequent, 128), _round_up(max(V, 1), 128))
    order = np.argsort(-base.doc_frequencies, kind="stable")
    freq_slot = np.full(V, K, dtype=np.int32)
    top = order[: min(n_frequent, V)]
    freq_slot[top] = np.arange(len(top), dtype=np.int32)

    valid = tids >= 0
    slots = np.where(valid, freq_slot[np.maximum(tids, 0)], K)
    is_freq = slots < K

    # Dense tables, built blockwise in the FINAL storage dtype. The
    # straightforward route (scatter a (D_pad, K) f32 staging matrix,
    # then quantize it whole) allocates 8 GB per table at 1M docs and
    # touches >100 GB of host memory across its temporaries — ~7.5 min
    # of single-core numpy and the entire 1M-doc load_scorer cost.
    # 128k-doc blocks keep the f32 staging footprint at ~1 GB, scatter
    # only the real frequent entries (int32 block-local indices), and
    # write int8/bf16/uint8 results directly. The per-doc quantization
    # math is row-local, so blockwise results are bit-identical.
    # Presence is built from term membership, not weight > 0: a frequent
    # term with idf 0 (robertson floor) still counts toward |q ∩ doc|.
    fsel = valid & is_freq
    presence_u8 = np.zeros((D_pad, K), dtype=np.uint8)
    bf16 = jnp.bfloat16.dtype  # ml_dtypes bfloat16 as a numpy dtype
    hi_out = lo_out = s_arr = s2_arr = imp_f32 = None
    if storage == "int8":
        hi_out = np.empty((D_pad, K), dtype=np.int8)
        lo_out = np.empty((D_pad, K), dtype=np.int8)
        s_arr = np.empty(D_pad, dtype=np.float32)
        s2_arr = np.empty(D_pad, dtype=np.float32)
    elif storage in ("hilo", "bf16"):
        hi_out = np.empty((D_pad, K), dtype=bf16)
        if storage == "hilo":
            lo_out = np.empty((D_pad, K), dtype=bf16)
    else:
        imp_f32 = np.zeros((D_pad, K), dtype=np.float32)

    _B = 1 << 17
    blk = (np.zeros((min(_B, D_pad), K), dtype=np.float32)
           if storage != "f32" else None)
    for d0 in range(0, D_pad, _B):
        d1 = min(d0 + _B, D_pad)
        bsel = fsel[d0:d1]
        br, _ = np.nonzero(bsel)
        bslot = slots[d0:d1][bsel]
        bw = w[d0:d1][bsel].astype(np.float32, copy=False)
        presence_u8[d0:d1][br, bslot] = 1
        if storage == "f32":
            imp_f32[d0:d1][br, bslot] = bw
            continue
        bv = blk[: d1 - d0]
        bv[:] = 0.0
        bv[br, bslot] = bw
        if storage == "int8":
            # Per-DOC scales so they factor out of the K-sum: the
            # epilogue multiplies score column d by s_d, keeping both
            # dot passes in pure int8/int32. (A per-term scale would
            # have to multiply inside the sum and break the integer
            # dot.) The residual gets its OWN per-doc scale (row 1), so
            # the representable range tracks the actual rounding error
            # instead of a fixed 1/128 — element error <= s2_d/2 ~=
            # amax_d / 64500.
            amax = np.abs(bv).max(axis=1)
            s = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
            q = bv / s[:, None]
            hi = np.clip(np.rint(q), -127, 127)
            resid = (q - hi) * s[:, None]            # true value units
            rmax = np.abs(resid).max(axis=1)
            s2 = np.where(rmax > 0, rmax / 127.0, 1.0).astype(np.float32)
            hi_out[d0:d1] = hi
            lo_out[d0:d1] = np.clip(np.rint(resid / s2[:, None]),
                                    -127, 127)
            s_arr[d0:d1] = s
            s2_arr[d0:d1] = s2
        elif storage == "hilo":
            # Round to bf16, pull the rounded value back to f32 to form
            # the residual exactly, round the residual to bf16 (both
            # casts round-to-nearest-even, matching the device convert).
            hi = bv.astype(bf16)
            hi_out[d0:d1] = hi
            lo_out[d0:d1] = (bv - hi.astype(np.float32)).astype(bf16)
        else:  # bf16
            hi_out[d0:d1] = bv.astype(bf16)

    # Two-level tail: the primary table is sized by the 90th-percentile
    # rare-term count (docs are heavy-tailed here too); the few docs with
    # more rare terms spill into a small overflow table with doc ids.
    tail_counts = (valid & ~is_freq).sum(axis=1)
    # Percentile/outlier stats over REAL doc rows only: padded all-zero
    # rows (up to doc_pad_multiple-1 of them) would bias the p90 low and
    # distort the overflow auto-gate.
    real_counts = tail_counts[: base.n_docs]
    max_tail = max(int(tail_counts.max()), 1)
    T_A = max(
        _round_up(max(int(np.percentile(real_counts, 90)), 1),
                  tail_pad_multiple),
        tail_pad_multiple,
    )
    if enable_overflow == "auto":
        n_outliers = int((real_counts > T_A).sum())
        enable_overflow = (
            2 * T_A <= max_tail and n_outliers <= max(D_pad // 256, 1)
        )
    if not enable_overflow or T_A >= max_tail:
        T_A = _round_up(max_tail, tail_pad_multiple)

    sel = valid & ~is_freq
    row_idx, _ = np.nonzero(sel)
    # int32 accumulator: the default int64 promotion doubles the memory
    # traffic of this (D_pad, T) pass for no range benefit (T < 2^31).
    col_idx = (np.cumsum(sel, axis=1, dtype=np.int32) - 1)[sel]
    flat_tids = tids[sel]
    flat_w = w[sel]

    in_primary = col_idx < T_A
    tail_ids = np.full((D_pad, T_A), eidx.DOC_PAD, dtype=np.int32)
    tail_w = np.zeros((D_pad, T_A), dtype=np.float32)
    tail_ids[row_idx[in_primary], col_idx[in_primary]] = flat_tids[in_primary]
    tail_w[row_idx[in_primary], col_idx[in_primary]] = flat_w[in_primary]

    over_ids = over_w = over_docs = None
    if not in_primary.all():
        o_rows = row_idx[~in_primary]
        o_cols = col_idx[~in_primary] - T_A
        over_docs_u = np.unique(o_rows)
        n_over = _pow2_bucket(len(over_docs_u), 8)
        T_B = _round_up(max_tail - T_A, tail_pad_multiple)
        over_ids = np.full((n_over, T_B), eidx.DOC_PAD, dtype=np.int32)
        over_w = np.zeros((n_over, T_B), dtype=np.float32)
        over_docs = np.zeros(n_over, dtype=np.int32)
        over_docs[: len(over_docs_u)] = over_docs_u
        row_map = np.searchsorted(over_docs_u, o_rows)
        over_ids[row_map, o_cols] = flat_tids[~in_primary]
        over_w[row_map, o_cols] = flat_w[~in_primary]

    (rare_slot, post_ids, post_w, rare_df,
     tier2) = _build_rare_postings(
        freq_slot, K, V, D_pad, row_idx, flat_tids, flat_w
    )
    rare2_slot, post2_ids, post2_w, rare2_df = (
        tier2 if tier2 is not None else (None, None, None, None))

    impact_scale = None
    if storage == "int8":
        impact_primary = jnp.asarray(hi_out)
        impact_lo = jnp.asarray(lo_out)
        impact_scale = jnp.asarray(np.stack([s_arr, s2_arr]))
    else:
        impact_primary = jnp.asarray(hi_out if imp_f32 is None else imp_f32)
        impact_lo = None if lo_out is None else jnp.asarray(lo_out)

    return SplitBM25Index(
        base=base,
        n_frequent=K,
        freq_slot_of_term=freq_slot,
        dense_impact=impact_primary,
        dense_impact_lo=impact_lo,
        # Presence entries are 0/1 — exact in bf16; halves the matrix's
        # HBM footprint and gather/matmul traffic (accumulation stays
        # f32). Transferred as uint8 (1 B/element over the host link)
        # and widened on device.
        dense_presence=jnp.asarray(presence_u8).astype(jnp.bfloat16),
        tail_term_ids=jnp.asarray(tail_ids),
        tail_weights=jnp.asarray(tail_w),
        over_term_ids=None if over_ids is None else jnp.asarray(over_ids),
        over_weights=None if over_w is None else jnp.asarray(over_w),
        over_doc_ids=None if over_docs is None else jnp.asarray(over_docs),
        rare_slot_of_term=rare_slot,
        post_doc_ids=None if post_ids is None else jnp.asarray(post_ids),
        post_weights=None if post_w is None else jnp.asarray(post_w),
        rare_df=rare_df,
        post_w_positive=bool((flat_w > 0).all()) if len(flat_w) else True,
        impact_scale=impact_scale,
        rare2_slot_of_term=rare2_slot,
        post2_doc_ids=None if post2_ids is None else jnp.asarray(post2_ids),
        post2_weights=None if post2_w is None else jnp.asarray(post2_w),
        rare2_df=rare2_df,
    )


# Rare postings stop paying off past this table size (entries, 8 B per
# entry -> 1 GB cap): a corpus whose rare terms still have huge document
# frequencies is better served by the doc-major compare tail.
_POSTINGS_MAX_ENTRIES = 128_000_000


def _build_rare_postings(freq_slot, K, V, D_pad, row_idx, flat_tids, flat_w):
    """Term-major postings over the rare vocabulary.

    Every (doc, rare-term) pair of the corpus becomes one entry of a
    padded (R+1, P) table keyed by *rare slot* (dense renumbering of the
    rare terms); docs within a row ascend. P = max rare document
    frequency, rounded up — bounded by construction: a rare term's df is
    at most the df of the K-th most frequent term.

    When the full-width rectangle blows the entries budget (1M-doc
    corpora: a 3.7k max rare df -> 446M entries), P is capped at the
    widest multiple of 8 the budget allows and the few over-cap terms
    (1.5% of the rare vocabulary in the 1M reference regime) move to a
    TIER-2 rectangle — narrow-but-tall (R2+1 rows at width P2 = their
    max df), so its footprint is tiny while staying term-major. The
    kernel folds tier-2 postings in a second merge pass over only the
    query rows that carry such terms.

    Returns (rare_slot, post_ids, post_w, rare_df, tier2): ``tier2`` is
    None when no cap engaged, else (rare2_slot (V,), post2_ids
    (R2+1, P2), post2_w, rare2_df (R2+1,)); over-cap terms map to the
    tier-1 sentinel R AND to their tier-2 slot.
    """
    rare_terms = np.where(freq_slot[:V] >= K)[0] if V else np.empty(0, int)
    R = len(rare_terms)
    rare_slot = np.full(max(V, 1), R, dtype=np.int32)
    rare_slot[rare_terms] = np.arange(R, dtype=np.int32)

    if R == 0 or len(flat_tids) == 0:
        post_ids = np.full((R + 1, 8), D_pad, dtype=np.int32)
        post_w = np.zeros((R + 1, 8), dtype=np.float32)
        return (rare_slot, post_ids, post_w,
                np.zeros(R + 1, dtype=np.int64), None)

    def rect(slots, rows, w, n_rows, width):
        """Left-compacted (n_rows+1, width) term-major rectangle."""
        c = (np.bincount(slots, minlength=n_rows) if len(slots)
             else np.zeros(n_rows, dtype=np.int64))
        df = np.append(c, 0).astype(np.int64)  # sentinel row: df 0
        order = np.lexsort((rows, slots))
        st = slots[order]
        starts = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(c, out=starts[1:])
        col = np.arange(len(st)) - starts[st]
        ids = np.full((n_rows + 1, width), D_pad, dtype=np.int32)
        ws = np.zeros((n_rows + 1, width), dtype=np.float32)
        ids[st, col] = rows[order]
        ws[st, col] = w[order]
        return ids, ws, df

    tslot = rare_slot[flat_tids]
    cnt = np.bincount(tslot, minlength=R)
    P = _round_up(max(int(cnt.max()), 1), 8)
    tier2 = None
    keep_slot, keep_rows, keep_w = tslot, row_idx, flat_w
    if (R + 1) * P > _POSTINGS_MAX_ENTRIES:
        width_cap = (_POSTINGS_MAX_ENTRIES // (R + 1)) // 8 * 8
        if width_cap < 16:
            # Budget can't hold a useful rectangle (pathological: huge
            # rare vocab AND huge dfs) — doc-major compare tail instead.
            return rare_slot, None, None, None, None
        t2_terms = rare_terms[np.where(cnt > width_cap)[0]]
        R2 = len(t2_terms)
        rare2_slot = np.full(max(V, 1), R2, dtype=np.int32)
        rare2_slot[t2_terms] = np.arange(R2, dtype=np.int32)
        rare_slot[t2_terms] = R           # tier-1 sentinel
        tslot = rare_slot[flat_tids]
        is2 = tslot == R
        t2slot = rare2_slot[flat_tids[is2]]
        P2 = _round_up(max(int(np.bincount(
            t2slot, minlength=max(R2, 1)).max()), 1), 8)
        if (R2 + 1) * P2 > _POSTINGS_MAX_ENTRIES:
            return rare_slot, None, None, None, None
        post2 = rect(t2slot, row_idx[is2], flat_w[is2], R2, P2)
        tier2 = (rare2_slot, *post2)
        keep = ~is2
        keep_slot, keep_rows, keep_w = (
            tslot[keep], row_idx[keep], flat_w[keep])
        cnt = np.bincount(keep_slot, minlength=R) if keep.any() else (
            np.zeros(R, dtype=np.int64))
        P = _round_up(max(int(cnt.max()), 1), 8)

    post_ids, post_w, rare_df = rect(keep_slot, keep_rows, keep_w, R, P)
    return rare_slot, post_ids, post_w, rare_df, tier2


def build_sharded_postings(split: SplitBM25Index, n_shards: int):
    """Doc-shard the rare postings for the distributed sparse-candidate
    path: entries of the (R+1, P) term-major table fall naturally into
    doc ranges, so shard s keeps its range's entries left-compacted with
    SHARD-LOCAL doc ids (sentinel D_local).

    Returns (post_ids (n_shards, R+1, P_max) int32,
             post_w   (n_shards, R+1, P_max) f32,
             rare_df  (n_shards, R+1) int64  — per-shard df for
             candidate-cap sizing). Within each row the original
    ascending-id order is preserved, so the per-shard merge sums in the
    same order as the single-chip merge restricted to that range.
    """
    return _shard_postings_rect(
        np.asarray(split.post_doc_ids), np.asarray(split.post_weights),
        split.dense_impact.shape[0], n_shards)


def build_sharded_postings2(split: SplitBM25Index, n_shards: int):
    """Doc-shard the TIER-2 rectangle (width-capped indexes) the same
    way as :func:`build_sharded_postings`, so the distributed kernel can
    run the second merge pass shard-locally. Returns None when no cap
    engaged, else (post2_ids, post2_w, rare2_df) per-shard tables."""
    if split.post2_doc_ids is None:
        return None
    return _shard_postings_rect(
        np.asarray(split.post2_doc_ids), np.asarray(split.post2_weights),
        split.dense_impact.shape[0], n_shards)


def _shard_postings_rect(pid: np.ndarray, pw: np.ndarray, D_pad: int,
                         n_shards: int):
    if D_pad % n_shards:
        raise ValueError(
            f"D_pad {D_pad} must divide the {n_shards}-shard mesh")
    D_local = D_pad // n_shards
    R1, _ = pid.shape
    per_shard_sel = []
    dfs = np.zeros((n_shards, R1), dtype=np.int64)
    p_max = 1
    for s in range(n_shards):
        lo, hi = s * D_local, (s + 1) * D_local
        sel = (pid >= lo) & (pid < hi)
        cnt = sel.sum(axis=1)
        dfs[s] = cnt
        p_max = max(p_max, int(cnt.max()) if cnt.size else 0)
        per_shard_sel.append((sel, lo))
    P_max = _round_up(max(p_max, 1), 8)
    out_ids = np.full((n_shards, R1, P_max), D_local, dtype=np.int32)
    out_w = np.zeros((n_shards, R1, P_max), dtype=np.float32)
    rows = np.arange(R1)
    for s, (sel, lo) in enumerate(per_shard_sel):
        col = np.cumsum(sel, axis=1) - 1
        r_idx = np.broadcast_to(rows[:, None], sel.shape)[sel]
        c_idx = col[sel]
        out_ids[s, r_idx, c_idx] = pid[sel] - lo
        out_w[s, r_idx, c_idx] = pw[sel]
    return out_ids, out_w, dfs


def sharded_candidate_cap(rare_df_sh: np.ndarray, tail_slots: np.ndarray,
                          k: int, P_shard: int) -> int:
    """Host-side candidate cap for the sharded sparse merge: the worst
    per-shard, per-tail-row postings total (sentinel slots carry df 0),
    power-of-2 bucketed like the single-chip cap."""
    ts = np.asarray(tail_slots)
    per_row = rare_df_sh[:, ts].sum(axis=2)  # (n_shards, nt, Qt) -> sum Qt
    cap = k + _pow2_bucket(max(int(per_row.max()), 1), 16)
    return min(cap, k + ts.shape[1] * P_shard)


def sharded_candidate_cap2(rare_df_sh: np.ndarray, rare2_df_sh: np.ndarray,
                           tail_slots1: np.ndarray, tail_slots2: np.ndarray,
                           k: int, P_shard: int, P2_shard: int) -> int:
    """Sharded analogue of :func:`candidate_cap2`: per-group-B-row
    candidate width for the tier-2 merge pass = k leaders + the worst
    per-shard postings total across BOTH tiers."""
    d1 = rare_df_sh[:, np.asarray(tail_slots1)].sum(axis=2)
    d2 = rare2_df_sh[:, np.asarray(tail_slots2)].sum(axis=2)
    cap = k + _pow2_bucket(max(int((d1 + d2).max()), 1), 16)
    Qt, Q2 = tail_slots1.shape[1], tail_slots2.shape[1]
    return min(cap, k + Qt * P_shard + Q2 * P2_shard)


def map_tail_slots(tail_qids: np.ndarray, split: SplitBM25Index) -> np.ndarray:
    """Tail query TERM ids -> rare postings row indices (host-side).

    QUERY_PAD (and any non-rare id, which the encoder never emits) maps to
    the empty sentinel row R."""
    rare_slot = split.rare_slot_of_term
    R = split.post_doc_ids.shape[0] - 1
    tq = np.asarray(tail_qids)
    safe = np.clip(tq, 0, len(rare_slot) - 1)
    return np.where(tq >= 0, np.minimum(rare_slot[safe], R), R).astype(np.int32)


def split_tail_groups(tail_rows, tail_qids, tail_qcnt,
                      split: SplitBM25Index):
    """Partition the (nt, Qt) tail group by postings tier (host-side).

    Rows whose rare terms all live in the tier-1 rectangle form group A
    (the common case — merged exactly as before); rows carrying at
    least one tier-2 (over-cap df) term form group B, which additionally
    gets a (ntB, Q2) tier-2 slot/count grid for the kernel's second
    merge pass. All dims are power-of-2 bucketed to bound compile
    count. Pad rows carry all-sentinel slots in every grid (tier-1
    sentinel R / tier-2 sentinel R2) with zero counts, so pass A keeps
    its all-R pad-row detection and pass B detects pads by all-R2.

    Returns (A, B): A = (rows, slots1, qcnt); B = None when the batch
    has no tier-2 terms, else (rows, slots1, qcnt, slots2, qcnt2).
    """
    tq = np.asarray(tail_qids)
    tc = np.asarray(tail_qcnt)
    tr = np.asarray(tail_rows)
    s1 = map_tail_slots(tail_qids, split)
    if split.post2_doc_ids is None:
        return (tr, s1, tc), None
    rs2 = split.rare2_slot_of_term
    R = split.post_doc_ids.shape[0] - 1
    R2 = split.post2_doc_ids.shape[0] - 1
    safe = np.clip(tq, 0, len(rs2) - 1)
    s2 = np.where(tq >= 0, np.minimum(rs2[safe], R2), R2).astype(np.int32)
    has2 = (s2 < R2).any(axis=1)
    if not has2.any():
        return (tr, s1, tc), None
    ai = np.nonzero(~has2)[0]
    bi = np.nonzero(has2)[0]
    Qt = s1.shape[1]

    def take(idx, n_pad, grid, fill):
        out = np.full((n_pad, grid.shape[1]), fill, grid.dtype)
        out[: len(idx)] = grid[idx]
        return out

    ntA = _pow2_bucket(max(len(ai), 1), 16)
    rowsA = np.zeros(ntA, dtype=np.int32)
    rowsA[: len(ai)] = tr[ai]
    A = (rowsA, take(ai, ntA, s1, R),
         take(ai, ntA, tc, 0.0))
    ntB = _pow2_bucket(len(bi), 8)
    rowsB = np.zeros(ntB, dtype=np.int32)
    rowsB[: len(bi)] = tr[bi]
    # Compact group B's tier-2 grid to its real width (most rows carry
    # 1-2 tier-2 terms even when Qt is larger).
    isb2 = s2[bi] < R2
    Q2 = _pow2_bucket(int(isb2.sum(axis=1).max()), 1)
    s2B = np.full((ntB, Q2), R2, dtype=np.int32)
    c2B = np.zeros((ntB, Q2), dtype=np.float32)
    rr, jj = np.nonzero(isb2)              # row-major: j ascending per row
    first = np.zeros(len(bi) + 1, dtype=np.int64)
    np.cumsum(isb2.sum(axis=1), out=first[1:])
    rank = np.arange(len(rr)) - first[rr]
    s2B[rr, rank] = s2[bi][rr, jj]
    c2B[rr, rank] = tc[bi][rr, jj]
    B = (rowsB, take(bi, ntB, s1, R), take(bi, ntB, tc, 0.0), s2B, c2B)
    return A, B


def split_light_heavy(tail_rows, tail_slots, tail_qcnt,
                      split: SplitBM25Index, k: int):
    """Partition a tier-1 tail group by per-row postings total
    (host-side) so the sparse merge can run two passes with per-group
    candidate caps instead of one pass at the batch-max cap.

    The merge's sbase gather, id-sort, segment sums, and candidate
    top-k all run at width ``cand_cap = k + pow2(max per-row postings
    total)`` — one heavy row (a query whose rare terms have large df)
    widens every row in the batch. This picks the power-of-2 light cap
    minimizing total gathered elements ``ntL*(k+c) + ntH*cap_full``
    (group sizes pow2-bucketed, as compiled) and returns the split only
    when it saves >= _LH_MIN_SAVE elements AND >= _LH_MIN_RATIO x —
    below that the second merge pass's fixed dispatch cost wins.

    The cost model deliberately counts only the cand_cap-width stages
    (sbase gather, segment sums, candidate top-k); the candidate
    id-sort still runs at the full concat width (k + Qt*P, or the
    packed r_max*P), which the split does not narrow — so the estimate
    overstates savings in sort-dominated regimes. The conservative
    _LH_MIN_SAVE/_LH_MIN_RATIO thresholds compensate: the split only
    engages when the gather-width savings alone are large. Engagement
    is also a compile-cache dimension (tailH args, cand_capH, heavy
    group size — all pow2-bucketed like the existing grpB split); a
    batch stream oscillating around the threshold alternates between
    two warm compiled variants, which is benign.

    Returns None (keep the single pass) or (light, heavy) where each is
    (rows, slots, qcnt) padded to a pow2 row count; pad rows carry
    all-sentinel slots / zero counts in both groups. Per-group caps come
    from :func:`candidate_cap` on the returned slot grids.
    """
    ts = np.asarray(tail_slots)
    tc = np.asarray(tail_qcnt)
    tr = np.asarray(tail_rows)
    nt = ts.shape[0]
    R = split.post_doc_ids.shape[0] - 1
    tot = split.rare_df[ts].sum(axis=1)
    cap_full = k + _pow2_bucket(max(int(tot.max()), 1), 16)
    base_cost = nt * cap_full
    best = None
    c = 16
    while k + 2 * c < cap_full:
        light = tot <= c
        n_light = int(light.sum())
        n_heavy = nt - n_light
        if n_heavy == 0:
            break
        if n_light:
            cost = (_pow2_bucket(n_light, 16) * (k + c)
                    + _pow2_bucket(n_heavy, 16) * cap_full)
            if best is None or cost < best[0]:
                best = (cost, light)
        c *= 2
    if (best is None or base_cost - best[0] < _LH_MIN_SAVE
            or base_cost < _LH_MIN_RATIO * best[0]):
        return None
    light = best[1]
    li = np.nonzero(light)[0]
    hi = np.nonzero(~light)[0]

    def group(idx, minimum):
        n_pad = _pow2_bucket(max(len(idx), 1), minimum)
        rows = np.zeros(n_pad, dtype=np.int32)
        rows[: len(idx)] = tr[idx]
        slots = np.full((n_pad, ts.shape[1]), R, ts.dtype)
        slots[: len(idx)] = ts[idx]
        qcnt = np.zeros((n_pad, tc.shape[1]), tc.dtype)
        qcnt[: len(idx)] = tc[idx]
        return rows, slots, qcnt

    return group(li, 16), group(hi, 16)


def split_light_heavy_b(tailB_rows, tailB_slots, tailB_qcnt,
                        tailB_slots2, tailB_qcnt2,
                        split: SplitBM25Index, k: int):
    """Light/heavy cap split of the TIER-2 group (group B), by combined
    tier-1 + tier-2 postings totals.

    The tier-2 merge's sbase gather runs at ``cand_cap2`` = k +
    pow2(max combined df total), and one row carrying two heavy tier-2
    terms widens every B row. Same cost model as
    :func:`split_light_heavy` (gathered elements = rows x cap,
    pow2-bucketed as compiled); engages at a lower absolute-savings
    floor because B groups are small (hundreds of rows) while the
    per-element gather cost is the same. The floors were set on
    another accelerator; their best values on the H100 are not yet
    measured.

    Returns None, or (light, heavy) where each is (rows, slots1,
    qcnt1, slots2, qcnt2) padded to a pow2 row count (min 8, like the
    grpB bucketing). Per-group caps come from :func:`candidate_cap2`
    on the returned slot grids.
    """
    s1 = np.asarray(tailB_slots)
    s2 = np.asarray(tailB_slots2)
    c1 = np.asarray(tailB_qcnt)
    c2 = np.asarray(tailB_qcnt2)
    tr = np.asarray(tailB_rows)
    nt = s1.shape[0]
    tot = (split.rare_df[s1].sum(axis=1)
           + split.rare2_df[s2].sum(axis=1))
    cap_full = k + _pow2_bucket(max(int(tot.max()), 1), 16)
    base_cost = nt * cap_full
    best = None
    c = 16
    while k + 2 * c < cap_full:
        light = tot <= c
        n_light = int(light.sum())
        n_heavy = nt - n_light
        if n_heavy == 0:
            break
        if n_light:
            cost = (_pow2_bucket(n_light, 8) * (k + c)
                    + _pow2_bucket(n_heavy, 8) * cap_full)
            if best is None or cost < best[0]:
                best = (cost, light)
        c *= 2
    if (best is None or base_cost - best[0] < _LHB_MIN_SAVE
            or base_cost < _LHB_MIN_RATIO * best[0]):
        return None
    light = best[1]
    li = np.nonzero(light)[0]
    hi = np.nonzero(~light)[0]
    R1 = split.post_doc_ids.shape[0] - 1
    R2 = split.post2_doc_ids.shape[0] - 1

    def group(idx):
        n_pad = _pow2_bucket(max(len(idx), 1), 8)

        def take(grid, fill):
            out = np.full((n_pad, grid.shape[1]), fill, grid.dtype)
            out[: len(idx)] = grid[idx]
            return out

        rows = np.zeros(n_pad, dtype=np.int32)
        rows[: len(idx)] = tr[idx]
        return (rows, take(s1, R1), take(c1, 0.0),
                take(s2, R2), take(c2, 0.0))

    return group(li), group(hi)


def candidate_cap2(split: SplitBM25Index, tail_slots1: np.ndarray,
                   tail_slots2: np.ndarray, k: int) -> int:
    """Candidate-set width for the tier-2 merge pass: k leaders + the
    batch's max per-row postings total across BOTH tiers."""
    d1 = split.rare_df[np.asarray(tail_slots1)].sum(axis=1)
    d2 = split.rare2_df[np.asarray(tail_slots2)].sum(axis=1)
    cap = k + _pow2_bucket(max(int((d1 + d2).max()), 1), 16)
    Qt, P = tail_slots1.shape[1], split.post_doc_ids.shape[1]
    Q2, P2 = tail_slots2.shape[1], split.post2_doc_ids.shape[1]
    return min(cap, k + Qt * P + Q2 * P2)


def _pow2_bucket(n: int, minimum: int) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def compact_tail_postings(tail_slots: np.ndarray, tail_qcnt: np.ndarray,
                          R: int):
    """Host-side rank-packing of the (nt, Qt) tail-slot grid for the
    gather+scatter candidate build.

    Only ~1/6 of grid cells hold a real rare term in the reference
    regime (Qt is the batch-max rare-term count; most tail queries have
    1-2), so the dense ``post_ids[tail_slots]`` gather fetches the
    sentinel postings row for most cells AND every downstream merge
    stage (id sort, shifted-add segment sums, candidate top-k) runs at
    the padded k + Qt*P width. The packed build instead gathers only
    the ``nr`` real postings rows and scatters them into a
    (nt, r_max, P) layout, where r_max is the batch-max number of real
    rare terms per row — the merge then runs at k + r_max*P width and
    r_max+1 segment shifts. Each row's real terms keep their query-slot
    order, so the stable id-sort sees the same per-doc payload sequence
    and every sum stays bit-equal to the dense build.

    Returns (packed (3, nr) int32, r_max): rows are flat_slots,
    flat_dest, and flat_qcnt as plain integer counts (widened to f32 on
    device — exact, and keeps every value small so :func:`ship_arrays`
    can pack the whole batch into an int16 buffer) — one stacked array
    means one host->device transfer per batch (a small transfer costs
    its fixed latency, not its bytes).
    ``flat_dest`` indexes the flattened (nt*r_max,) row space. nr and
    r_max are power-of-2 bucketed (pads: slot R -> sentinel row, dest
    nt*r_max -> trash row, qcnt 0) so compile shapes stay bounded."""
    ts = np.asarray(tail_slots)
    qc = np.asarray(tail_qcnt)
    nt, Qt = ts.shape
    real = ts < R
    rows, js = np.nonzero(real)            # row-major: j ascending per row
    counts = real.sum(axis=1)
    r_max = _pow2_bucket(max(int(counts.max()) if nt else 1, 1), 1)
    r_max = min(r_max, Qt)
    # rank of each real entry within its row (0..count-1, in j order)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(rows)) - first[rows]
    nr = _pow2_bucket(max(len(rows), 1), 64)
    packed = np.empty((3, nr), np.int32)
    packed[0] = R
    packed[1] = nt * r_max
    packed[2] = 0
    packed[0, :len(rows)] = ts[rows, js]
    packed[1, :len(rows)] = (rows * r_max + rank).astype(np.int32)
    packed[2, :len(rows)] = qc[rows, js].astype(np.int32)
    return packed, int(r_max)


_SHIP_CACHE: dict = {}


def ship_arrays(arrays):
    """Transfer small integer-valued host arrays as ONE packed buffer.

    A small host->device transfer costs its fixed latency rather than
    its bytes, so this packs every operand into
    one 1-D buffer — int16 when all values fit, else int32 — ships it,
    and splits/casts back on device in a tiny jitted program (cached
    per shape/dtype signature; pow2 bucketing upstream bounds the
    variant count). float32 inputs must be integer-valued (the query
    count grids are); their round-trip through the int buffer is
    exact.

    Returns a tuple of device arrays with the original shapes/dtypes.
    """
    parts = [np.asarray(a) for a in arrays]
    if not parts:
        return ()
    lo = min(float(p.min()) if p.size else 0.0 for p in parts)
    hi = max(float(p.max()) if p.size else 0.0 for p in parts)
    pack_dt = np.int16 if -32768 <= lo and hi <= 32767 else np.int32
    flat = np.concatenate([p.astype(pack_dt).ravel() for p in parts])
    sig = (tuple((p.shape, p.dtype.name) for p in parts),
           pack_dt().dtype.name)
    fn = _SHIP_CACHE.get(sig)
    if fn is None:
        shapes = [p.shape for p in parts]
        dtypes = [p.dtype.name for p in parts]
        offs = np.cumsum([0] + [int(np.prod(s)) for s in shapes])

        @jax.jit
        def unpack(buf):
            outs = []
            for i, (shape, dt) in enumerate(zip(shapes, dtypes)):
                seg = buf[offs[i]:offs[i + 1]].reshape(shape)
                outs.append(seg.astype(dt))
            return tuple(outs)

        fn = _SHIP_CACHE[sig] = unpack
    return fn(flat)


def encode_queries_split(
    query_tokens: list, split: SplitBM25Index,
    tail_pad_multiple: int = 4,
    freq_pad_multiple: int = 8,
):
    """Queries -> (freq slot ids (nq, Qf), freq counts (nq, Qf),
    tail row indices (nt,), tail qids (nt, Qt), tail qcnt (nt, Qt)).

    The frequent side ships as compact slot/count lists (padded with the
    overflow slot K) and is scattered into the dense (nq, K) query matrix
    on device — the dense matrix never crosses the host<->device link.
    The tail side covers ONLY queries that actually have rare terms
    (typically ~half the batch with ~1 term each); the kernel scatters
    their compare scores back into the matmul scores by row index. Both
    tail dims are power-of-two bucketed to bound compile counts.
    """
    vocab = split.vocab
    K = split.n_frequent
    slot_of = split.freq_slot_of_term
    nq = len(query_tokens)

    # Fastest path: ONE C++ pass straight to the padded arrays (lookup,
    # dedup, frequency partition, group-by — engine/native.py:
    # encode_tokens_split). The numpy group-by below is the semantics
    # contract and the fallback (no toolchain / non-ASCII tokens).
    nenc = eidx.get_native_encoder(split.base)
    if nenc is not None:
        cached = getattr(split, "_slot_of_i32", None)
        if cached is None:
            cached = np.ascontiguousarray(slot_of, dtype=np.int32)
            try:
                object.__setattr__(split, "_slot_of_i32", cached)
            except AttributeError:
                pass
        out = nenc.encode_tokens_split(
            query_tokens, cached, K, eidx.QUERY_PAD,
            freq_pad_multiple, tail_pad_multiple, 16)
        if out is not None:
            return out

    # One C++ pass when the native encoder is built (engine/native.py:
    # VocabEncoder); otherwise one dict lookup per token + np.unique dedup.
    pairs = eidx.query_term_pairs(query_tokens, vocab, nenc)
    if pairs is None:
        Qf = _round_up(1, freq_pad_multiple)
        Qt = _round_up(1, tail_pad_multiple)
        nt = _pow2_bucket(1, 16)
        return (np.full((nq, Qf), K, np.int32), np.zeros((nq, Qf), np.float32),
                np.zeros(nt, np.int32),
                np.full((nt, Qt), eidx.QUERY_PAD, np.int32),
                np.zeros((nt, Qt), np.float32))

    pq, pt, counts = pairs
    slots = slot_of[pt]
    is_freq = slots < K

    # Frequent side: rows are ALL queries (absent ones stay empty).
    fq = pq[is_freq]
    fs = slots[is_freq]
    fc = counts[is_freq]
    if len(fq):
        uniq_q, start = np.unique(fq, return_index=True)
        per = np.diff(np.append(start, len(fq)))
        Qf = _round_up(int(per.max()), freq_pad_multiple)
        col = np.arange(len(fq)) - start[np.searchsorted(uniq_q, fq)]
        fslots = np.full((nq, Qf), K, dtype=np.int32)
        fcnt = np.zeros((nq, Qf), dtype=np.float32)
        fslots[fq, col] = fs
        fcnt[fq, col] = fc
    else:
        Qf = _round_up(1, freq_pad_multiple)
        fslots = np.full((nq, Qf), K, dtype=np.int32)
        fcnt = np.zeros((nq, Qf), dtype=np.float32)

    # Tail side: rows only for queries that have rare terms; bucketed pads
    # point at query 0 with QUERY_PAD ids (zero contribution).
    tq = pq[~is_freq]
    tt = pt[~is_freq]
    tc = counts[~is_freq]
    if len(tq):
        uniq_q, start = np.unique(tq, return_index=True)
        per = np.diff(np.append(start, len(tq)))
        Qt = _round_up(int(per.max()), tail_pad_multiple)
        nt = _pow2_bucket(len(uniq_q), 16)
        row_of = np.searchsorted(uniq_q, tq)
        col = np.arange(len(tq)) - start[row_of]
        trows = np.zeros(nt, dtype=np.int32)
        trows[: len(uniq_q)] = uniq_q
        qids = np.full((nt, Qt), eidx.QUERY_PAD, dtype=np.int32)
        qcnt = np.zeros((nt, Qt), dtype=np.float32)
        qids[row_of, col] = tt
        qcnt[row_of, col] = tc
    else:
        Qt = _round_up(1, tail_pad_multiple)
        nt = _pow2_bucket(1, 16)
        trows = np.zeros(nt, dtype=np.int32)
        qids = np.full((nt, Qt), eidx.QUERY_PAD, dtype=np.int32)
        qcnt = np.zeros((nt, Qt), dtype=np.float32)
    return fslots, fcnt, trows, qids, qcnt


def _densify_queries(fslots, fcnt, K: int):
    """Scatter compact (slot, count) lists into dense (nq, K) matrices on
    device; pads target the dropped overflow column K."""
    nq = fslots.shape[0]
    rows = jnp.arange(nq)[:, None]
    qvec = jnp.zeros((nq, K + 1), jnp.float32).at[rows, fslots].set(fcnt)
    qpres = jnp.zeros((nq, K + 1), jnp.float32).at[rows, fslots].set(
        (fcnt > 0).astype(jnp.float32))
    return qvec[:, :K], qpres[:, :K]


def _impact_matmul(qvec, impact, impact_lo, precision, scale=None,
                   q_int8_ok: bool = True, coarse: bool = False):
    """The frequent-term scoring matmul under any storage mode.

    hilo storage (impact_lo is not None): two 1-pass matmuls on the bf16
    hi/lo matrices with the query counts cast to bf16 — exact, because
    counts are small integers — accumulated in f32. f32/bf16 storage:
    one dot at the requested precision. With f32 inputs, HIGHEST is a
    full f32 GEMM, HIGH the three-pass bf16 algorithm (~1e-5 relative;
    requested explicitly, because ``Precision.HIGH`` alone lowers to
    one TF32 pass on the GPU) and DEFAULT one TF32 pass (~5e-4); bf16
    inputs are always one pass.

    int8 storage (``scale`` is not None): two int8xint8->int32 dots
    (integer tensor-core GEMMs) combined as ``scale_d * (hi + lo/128)``
    in the epilogue — exact integer accumulation, so the only error is
    the ~3e-5 representation.
    ``q_int8_ok`` must be False when any query count exceeds 127 (the
    caller checks host-side); the fallback dequantizes the matrix pair
    in-kernel and runs one f32 dot — correct at any count, ~2 extra
    HBM passes over the (D, K) pair.

    ``coarse=True`` (int8 storage only) is the RANK-ONLY fast tier: it
    drops the lo-residual dot, halving the matmul work, at ~1/128 (~0.8%)
    relative score error — rankings are approximately preserved and
    recall-tolerant callers trade that error for throughput (the
    opt-in analogue of ``approx=True`` on the selection side). No-op
    under the exact storage modes.
    """
    if impact.dtype == jnp.int8 and scale is None:
        raise ValueError(
            "int8 impact matrices require their per-doc impact_scale — "
            "a caller forgot to thread it (scores would be silently "
            "unscaled)")
    if scale is not None:
        if q_int8_ok:
            qi = qvec.astype(jnp.int8)
            hi = jnp.dot(qi, impact.T, preferred_element_type=jnp.int32)
            if coarse:
                return hi.astype(jnp.float32) * scale[0][None, :]
            lo = jnp.dot(qi, impact_lo.T,
                         preferred_element_type=jnp.int32)
            return (hi.astype(jnp.float32) * scale[0][None, :]
                    + lo.astype(jnp.float32) * scale[1][None, :])
        w = (impact.astype(jnp.float32) * scale[0][:, None]
             + impact_lo.astype(jnp.float32) * scale[1][:, None])
        return jnp.dot(qvec, w.T, precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)
    if impact_lo is not None and impact_lo.shape[1] > 0:
        # (a zero-width impact_lo is the sharded layer's "no residual"
        # sentinel — fall through to the single-matrix path)
        qb = qvec.astype(impact.dtype)
        return (jnp.dot(qb, impact.T, preferred_element_type=jnp.float32)
                + jnp.dot(qb, impact_lo.T,
                          preferred_element_type=jnp.float32))
    dt = impact.dtype
    if dt == jnp.float32 and precision == jax.lax.Precision.HIGH:
        precision = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    return jnp.dot(qvec.astype(dt), impact.T, precision=precision,
                   preferred_element_type=jnp.float32)


def _compare_table(table_ids, table_w, tail_qids, tail_qcnt):
    """Compare a (rows, T) table against the tail query group ->
    (nt, rows) partial scores + tf counts."""
    Q = tail_qids.shape[1]

    def one(qrow, crow):
        def body(j, carry):
            acc, tf = carry
            m = (table_ids == qrow[j]).astype(jnp.float32)
            acc = acc + crow[j] * jnp.sum(table_w * m, axis=1)
            tf = tf + jnp.sum(m, axis=1)
            return acc, tf

        zeros = jnp.sum(table_w, axis=1) * 0.0
        return jax.lax.fori_loop(0, Q, body, (zeros, zeros))

    return jax.lax.map(
        lambda args: one(*args), (tail_qids, tail_qcnt),
        batch_size=min(16, tail_qids.shape[0]),
    )


@partial(jax.jit, static_argnames=("precision", "q_int8_ok"))
def _split_score_kernel(dense_impact, dense_presence, tail_ids, tail_w,
                        fslots, fcnt, tail_rows, tail_qids, tail_qcnt,
                        overflow=None,
                        precision=jax.lax.Precision.HIGHEST,
                        impact_lo=None, impact_scale=None,
                        q_int8_ok: bool = True):
    """scores = scatter(fslots) @ impact.T, plus the tail compare for the
    (small) subset of queries with rare terms, scattered back by row.
    ``overflow`` = (ids, weights, doc_ids) for the few docs whose rare
    terms exceed the primary tail width."""
    qvec, qpres = _densify_queries(fslots, fcnt, dense_impact.shape[1])
    # Default HIGHEST: a lower f32 precision perturbs scores against the
    # compare path. The knob (scorer matmul_precision) trades exactness
    # for speed: highest = full f32, high = three bf16 passes (~1e-5
    # rel), default = one TF32 pass (~5e-4 rel); hilo storage
    # (impact_lo set) is two bf16 passes at ~8e-6.
    scores = _impact_matmul(qvec, dense_impact, impact_lo, precision,
                            scale=impact_scale, q_int8_ok=q_int8_ok)
    # The presence matmul is EXACT in one bf16 pass: 0/1 operands are
    # representable, products are 0/1, and the dot accumulates in f32
    # (tf counts are far below 2^24). Never burn multi-pass here.
    tfs = jnp.dot(qpres.astype(dense_presence.dtype), dense_presence.T,
                  preferred_element_type=jnp.float32)

    t_scores, t_tfs = _compare_table(tail_ids, tail_w, tail_qids, tail_qcnt)
    # Pad rows target query 0 with zero contributions (QUERY_PAD ids).
    scores = scores.at[tail_rows].add(t_scores)
    tfs = tfs.at[tail_rows].add(t_tfs)

    if overflow is not None:
        o_ids, o_w, o_docs = overflow
        o_scores, o_tfs = _compare_table(o_ids, o_w, tail_qids, tail_qcnt)
        rows2d = tail_rows[:, None]
        cols2d = o_docs[None, :]
        scores = scores.at[rows2d, cols2d].add(o_scores)
        tfs = tfs.at[rows2d, cols2d].add(o_tfs)
    return scores, tfs


def _overflow_of(split: SplitBM25Index):
    if split.over_term_ids is None:
        return None
    return (split.over_term_ids, split.over_weights, split.over_doc_ids)


def score_all_split(split: SplitBM25Index, fslots, fcnt, tail_rows,
                    tail_qids, tail_qcnt,
                    precision=jax.lax.Precision.HIGHEST):
    """(nq, D_pad) scores and unique-overlap tf counts."""
    return _split_score_kernel(
        split.dense_impact, split.dense_presence,
        split.tail_term_ids, split.tail_weights,
        jnp.asarray(fslots), jnp.asarray(fcnt), jnp.asarray(tail_rows),
        jnp.asarray(tail_qids), jnp.asarray(tail_qcnt),
        overflow=_overflow_of(split), precision=precision,
        impact_lo=split.dense_impact_lo,
        impact_scale=split.impact_scale,
        q_int8_ok=_q_int8_ok(split, fcnt),
    )


def _q_int8_ok(split: SplitBM25Index, fcnt) -> bool:
    """True when the batch's query counts are exact in int8 (the near-
    universal case). Host-side check; only consulted under int8
    storage, where a False routes to the dequantizing f32 fallback."""
    if split.impact_scale is None:
        return True
    return float(np.asarray(fcnt).max(initial=0.0)) <= 127.0


@partial(jax.jit, static_argnames=("n_docs", "prior_free", "precision",
                                   "q_int8_ok"))
def probabilities_all_split(
    dense_impact, dense_presence, tail_ids, tail_w, doc_lengths, avgdl,
    fslots, fcnt, tail_rows, tail_qids, tail_qcnt,
    alpha, beta, base_rate=None, *, n_docs: int, prior_free: bool = False,
    overflow=None, precision=jax.lax.Precision.HIGHEST, impact_lo=None,
    impact_scale=None, q_int8_ok: bool = True,
):
    """Dense calibrated probabilities (nq, n_docs) via the split path."""
    from bayesian_bm25_tpu.ops import transform as T

    scores, tfs = _split_score_kernel(
        dense_impact, dense_presence, tail_ids, tail_w,
        fslots, fcnt, tail_rows, tail_qids, tail_qcnt, overflow=overflow,
        precision=precision, impact_lo=impact_lo,
        impact_scale=impact_scale, q_int8_ok=q_int8_ok,
    )
    scores = scores[:, :n_docs]
    tfs = tfs[:, :n_docs]
    dlr = (doc_lengths[:n_docs] / avgdl)[None, :]
    probs = T.score_to_probability(
        scores, tfs, dlr, alpha, beta, base_rate, prior_free=prior_free
    )
    return jnp.where(scores > 0, probs.astype(scores.dtype), 0.0)


@partial(jax.jit,
         static_argnames=("k", "n_docs", "prior_free", "approx",
                          "precision", "q_int8_ok"))
def retrieve_topk_split(
    dense_impact, dense_presence, tail_ids, tail_w, doc_lengths, avgdl,
    fslots, fcnt, tail_rows, tail_qids, tail_qcnt, k: int,
    alpha, beta, base_rate=None, *, n_docs: int, prior_free: bool = False,
    approx: bool = False, overflow=None,
    precision=jax.lax.Precision.HIGHEST, doc_mask=None, impact_lo=None,
    impact_scale=None, q_int8_ok: bool = True,
):
    """Fused split scoring -> top-k -> Bayesian transform (hot path).

    ``approx=True`` uses ``lax.approx_max_k`` instead of the blockwise
    exact top-k. On the GPU, XLA lowers it to its exact top-k custom call
    (recall 1.0), which is slower than the blockwise selection; it stays
    for API parity. ``doc_mask`` excludes docs from selection; unfilled
    slots return id -1 / probability 0.

    Without an overflow table, tf counts are reconstructed ONLY at the
    k winners (presence-row matmul + tail-table equality count) instead
    of materializing the dense (nq, D_pad) tf matrix — at 1M docs that
    matrix plus the compare-path tf intermediate are ~6 GB of device memory the
    kernel no longer touches. The reconstruction is exact: integer
    equality counts, order-free f32 sums, bit-equal to the dense path.
    """
    from bayesian_bm25_tpu.ops import transform as T

    nq = fslots.shape[0]
    lean = overflow is None
    if lean:
        qvec, qpres = _densify_queries(fslots, fcnt,
                                       dense_impact.shape[1])
        scores = _impact_matmul(qvec, dense_impact, impact_lo, precision,
                                scale=impact_scale, q_int8_ok=q_int8_ok)
        t_scores, _ = _compare_table(tail_ids, tail_w, tail_qids,
                                     tail_qcnt)
        scores = scores.at[tail_rows].add(t_scores)
    else:
        scores, tfs = _split_score_kernel(
            dense_impact, dense_presence, tail_ids, tail_w,
            fslots, fcnt, tail_rows, tail_qids, tail_qcnt,
            overflow=overflow, precision=precision, impact_lo=impact_lo,
            impact_scale=impact_scale, q_int8_ok=q_int8_ok,
        )
    D_pad = scores.shape[1]
    if doc_mask is not None:
        mask_pad = jnp.concatenate(
            [doc_mask[:n_docs], jnp.ones((D_pad - n_docs,), bool)])
        scores = jnp.where(mask_pad[None, :], scores, -jnp.inf)
    if approx:
        top_scores, top_ids = jax.lax.approx_max_k(scores[:, :n_docs], k)
    else:
        # Full-width blockwise selection: pad docs are iota-masked, so
        # the (nq, D) slice copies of scores/tfs disappear.
        top_scores, top_ids = exact_topk_blockwise(
            scores, k, block=256, valid_upto=n_docs)
    dead = ~jnp.isfinite(top_scores)
    top_scores = jnp.where(dead, 0.0, top_scores)
    top_ids = jnp.where(dead, -1, top_ids)
    safe_ids = jnp.maximum(top_ids, 0)
    if lean:
        # Frequent-side tf: presence rows only at the winners.
        pres_rows = dense_presence[safe_ids]           # (nq, k, K)
        tf_freq = jnp.einsum("nkc,nc->nk", pres_rows,
                             qpres.astype(dense_presence.dtype),
                             precision=jax.lax.Precision.HIGHEST,
                             preferred_element_type=jnp.float32)
        # Tail-side tf: |winner's rare terms ∩ query's rare terms|.
        # Rare ids are unique on both sides and the pad sentinels differ
        # (DOC_PAD -1 vs QUERY_PAD -2), so an equality-count over the
        # (T_A, Qt) grid reproduces _compare_table's tf contribution
        # exactly. Pad tail rows (QUERY_PAD in column 0) route to a
        # trash row so they cannot clobber query 0's rare ids.
        Qt = tail_qids.shape[1]
        is_pad_row = tail_qids[:, 0] < 0
        safe_rows = jnp.where(is_pad_row, nq, tail_rows)
        qt_full = jnp.full((nq + 1, Qt), eidx.QUERY_PAD,
                           tail_qids.dtype).at[safe_rows].set(
            tail_qids)[:nq]
        w_tail = tail_ids[safe_ids]                    # (nq, k, T_A)
        tf_tail = jnp.sum(
            (w_tail[:, :, :, None] == qt_full[:, None, None, :])
            .astype(jnp.float32), axis=(2, 3))
        top_tfs = tf_freq + tf_tail
    else:
        top_tfs = jnp.take_along_axis(tfs, safe_ids, axis=1)
    top_dlr = doc_lengths[safe_ids] / avgdl
    probs = T.score_to_probability(
        top_scores, top_tfs, top_dlr, alpha, beta, base_rate,
        prior_free=prior_free,
    )
    probs = jnp.where(top_scores > 0, probs.astype(top_scores.dtype), 0.0)
    return top_ids, probs, top_scores, top_tfs


@partial(jax.jit, static_argnames=("k", "block", "valid_upto"))
def exact_topk_blockwise(scores, k: int, block: int = 128,
                         valid_upto: int | None = None):
    """Exact top-k over the document axis, tie-order-identical to
    ``lax.top_k``, at a fraction of its cost for large D.

    lax.top_k's cost grows with both D and k; this computes per-block
    maxima (one memory pass), selects the top-k BLOCKS, and runs the
    full top-k only on those blocks' k*block values.

    ``valid_upto`` restricts selection to columns < valid_upto via an
    iota mask instead of a slice, so a padded score matrix needs no
    (nq, D) slice copy; requires D % block == 0.

    Exactness: every top-k document lies in a top-k block. If doc d's
    block b ranked below k by (max desc, id asc), then >= k blocks sort
    above b, each containing a doc with value >= max_b >= v(d) (equal
    maxes sort above b only for lower block ids, whose docs all have
    lower ids) — so at least k docs either exceed v(d) or tie it with a
    lower id, and the dense top_k would not have selected d either.
    Tie parity: blocks are contiguous id ranges and the selected blocks
    are re-sorted ascending, so candidates are id-ascending and the
    final stable top_k breaks value ties to the lowest doc id, exactly
    like the dense scan.
    """
    nq, D = scores.shape
    G = -(-D // block)
    if k >= G:  # few blocks: the prefilter would keep everything
        if valid_upto is not None and valid_upto < D:
            return jax.lax.top_k(scores[:, :valid_upto], k)
        return jax.lax.top_k(scores, k)
    if valid_upto is not None:
        if D % block:
            raise ValueError("valid_upto requires D % block == 0")
        tiles = scores.reshape(nq, G, block)
    else:
        pad = G * block - D
        padded = jnp.pad(scores, ((0, 0), (0, pad)),
                         constant_values=-jnp.inf) if pad else scores
        tiles = padded.reshape(nq, G, block)
    bmax = _block_max(tiles, valid_upto)
    _, bids = jax.lax.top_k(bmax, k)            # ties -> lower block id
    bids = jnp.sort(bids, axis=1)               # id-ascending candidates
    rows = jnp.arange(nq)[:, None]
    cand = tiles[rows, bids].reshape(nq, k * block)
    cand_ids = (bids[:, :, None] * block
                + jnp.arange(block)[None, None, :]).reshape(nq, k * block)
    if valid_upto is not None:
        # tiles stay raw; candidates re-mask pad columns here
        cand = jnp.where(cand_ids < valid_upto, cand, -jnp.inf)
    v, p = jax.lax.top_k(cand, k)
    return v, jnp.take_along_axis(cand_ids, p, axis=1)


def _block_max(tiles, valid_upto: int | None):
    """(nq, G) maxima of the (nq, G, block) tiles over columns <
    ``valid_upto``. The masked view feeds only the reduce, so XLA fuses
    the mask into it: no (nq, D) masked copy is written."""
    _, G, block = tiles.shape
    if valid_upto is None:
        return tiles.max(axis=2)
    col = (jax.lax.broadcasted_iota(jnp.int32, (G, block), 0) * block
           + jax.lax.broadcasted_iota(jnp.int32, (G, block), 1))
    return jnp.where((col < valid_upto)[None], tiles, -jnp.inf).max(axis=2)


def candidate_cap(split: SplitBM25Index, tail_slots: np.ndarray, k: int) -> int:
    """Host-side candidate-set width: k leaders + the batch's max per-row
    postings total, power-of-2 bucketed (bounded compile count). Sentinel
    slots carry df 0, so the cap covers every valid candidate."""
    per_row = split.rare_df[np.asarray(tail_slots)].sum(axis=1)
    cap = k + _pow2_bucket(max(int(per_row.max()), 1), 16)
    Qt, P = tail_slots.shape[1], split.post_doc_ids.shape[1]
    return min(cap, k + Qt * P)


def _sparse_merge(scores, topm_scores, topm_ids, post_ids, post_w,
                  tail_rows, tail_slots, tail_qcnt, k: int, cand_cap: int,
                  n_docs: int, tf_from_sign: bool = False, compact=None,
                  postings2=None, pad_row_mask=None,
                  base_tail_tf=None):
    """Rare-postings candidate merge shared by the single-chip and
    per-shard sparse kernels: fold each tail query's rare-term postings
    into the k matmul leaders and return the merged
    (ids, scores, tail_tf) per query row. ``scores``/``post_ids`` use
    LOCAL doc ids when called inside a shard (n_docs = local real-doc
    count); the caller adds the shard offset afterwards.

    ``compact`` (the :func:`compact_tail_postings` result, with r_max
    static in the caller) switches the candidate build to
    gather-real-rows + scatter into a rank-packed (nt, r_max, P)
    layout: empty cells reconstruct the sentinel row's id-D_pad /
    weight-0 content and real terms keep their query-slot order, so the
    stable id-sort sees per-doc payload sequences identical to the
    dense build — while the gather, sort, segment sums, and candidate
    top-k all run at the (usually much narrower) packed width.

    ``postings2`` = (post2_ids, post2_w, tail_slots2, tail_qcnt2)
    appends a SECOND term-major rectangle's gathered rows to every tail
    row's candidate set (the tier-2 pass for width-capped indexes);
    the id-sort groups duplicates across tiers, so per-doc sums stay
    exact. ``pad_row_mask`` overrides the all-sentinel pad-row
    inference (needed for the tier-2 group, whose real rows may carry
    all-sentinel TIER-1 slots). ``base_tail_tf`` carries a previous
    pass's (nq, k) tail-tf so sequential merge passes compose."""
    nq = topm_ids.shape[0]
    nt, Qt = tail_slots.shape
    D_pad = scores.shape[1]
    R = post_ids.shape[0] - 1

    # Postings of each tail query's rare terms: (nt, width, P).
    if compact is not None:
        packed, r_max = compact
        flat_slots = packed[0]
        flat_dest = packed[1]
        flat_qcnt = packed[2].astype(jnp.float32)
        P = post_ids.shape[1]
        g_ids = post_ids[flat_slots]                      # (nr, P)
        g_v = flat_qcnt[:, None] * post_w[flat_slots]
        pid = jnp.full((nt * r_max + 1, P), D_pad, post_ids.dtype).at[
            flat_dest].set(g_ids, mode="drop")[:nt * r_max].reshape(
            nt, r_max, P)
        v = jnp.zeros((nt * r_max + 1, P), jnp.float32).at[
            flat_dest].set(g_v, mode="drop")[:nt * r_max].reshape(
            nt, r_max, P)
    else:
        pid = post_ids[tail_slots]
        pw = post_w[tail_slots]
        # Per-entry contribution c_j * w — identical product to the
        # compare kernel's qcnt[j] * weight, so downstream sums can be
        # bit-equal.
        v = tail_qcnt[:, :, None] * pw
    pvalid = pid < n_docs  # sentinel rows/slots carry id D_pad, weight 0
    width = pid.shape[1]   # Qt (dense) or r_max (packed)

    pid2 = None
    if postings2 is not None:
        post2_ids, post2_w, tail_slots2, tail_qcnt2 = postings2
        pid2 = post2_ids[tail_slots2]                     # (nt, Q2, P2)
        v2 = tail_qcnt2[:, :, None] * post2_w[tail_slots2]
        width = width + pid2.shape[1]

    # Candidate set per tail row: k matmul leaders ++ all postings docs.
    C = k + width * pid.shape[2] if pid2 is None else (
        k + pid.shape[1] * pid.shape[2] + pid2.shape[1] * pid2.shape[2])
    cand_cap = min(max(cand_cap, k), C)
    parts_i = [topm_ids[tail_rows], pid.reshape(nt, -1)]
    parts_v = [jnp.zeros((nt, k), jnp.float32), v.reshape(nt, -1)]
    if pid2 is not None:
        parts_i.append(pid2.reshape(nt, -1))
        parts_v.append(v2.reshape(nt, -1))
    cand_ids = jnp.concatenate(parts_i, axis=1)
    cand_v = jnp.concatenate(parts_v, axis=1)

    # Stable id-sort groups duplicate docs (leaders already < n_docs and
    # invalid postings slots carry the D_pad sentinel, so the id itself is
    # the sort key); leaders sort before postings entries of the same doc,
    # and j-ascending postings order is kept, so summation order matches
    # the dense kernel's fori_loop exactly. One multi-operand lax.sort
    # co-sorts the payloads (argsort + take_along_axis would re-gather).
    # When every real posting weight is positive (tf_from_sign), the tf
    # payload is sign-derivable (v = qcnt * w > 0 iff a valid posting;
    # leaders and pad slots carry v = 0), and the third sort operand is
    # dropped.
    #
    # Key choice (UNIQUE_KEY_SORT): a stable XLA sort appends an iota
    # tiebreak operand to the bitonic network, so when id * W + col
    # fits uint32 the UNSTABLE unique-key sort moves one fewer array
    # for the identical order (equal ids order by col = concat
    # position, exactly the stable order over ids).
    Ctot = cand_ids.shape[1]
    Wkey = 1 << max(Ctot - 1, 1).bit_length()
    ukey = UNIQUE_KEY_SORT and (D_pad + 1) * Wkey <= (1 << 32)
    if ukey:
        shift = Wkey.bit_length() - 1
        col = jnp.arange(Ctot, dtype=jnp.uint32)[None, :]
        sort_key = cand_ids.astype(jnp.uint32) * jnp.uint32(Wkey) + col
    else:
        sort_key = cand_ids
    if tf_from_sign:
        skey, sv = jax.lax.sort(
            (sort_key, cand_v), dimension=1, is_stable=not ukey,
            num_keys=1)
        sid = ((skey >> shift).astype(cand_ids.dtype)
               if ukey else skey)[:, :cand_cap]
        sv = sv[:, :cand_cap]
        stf = (sv > 0).astype(jnp.float32)
    else:
        parts_tf = [jnp.zeros((nt, k), jnp.float32),
                    pvalid.astype(jnp.float32).reshape(nt, -1)]
        if pid2 is not None:
            parts_tf.append(
                (pid2 < n_docs).astype(jnp.float32).reshape(nt, -1))
        cand_tf = jnp.concatenate(parts_tf, axis=1)
        skey, sv, stf = jax.lax.sort(
            (sort_key, cand_v, cand_tf), dimension=1, is_stable=not ukey,
            num_keys=1)
        # Valid candidates sort to the front; slice to the host-computed
        # cap (k + max postings in this batch) before the later stages.
        sid = ((skey >> shift).astype(cand_ids.dtype)
               if ukey else skey)[:, :cand_cap]
        sv = sv[:, :cand_cap]
        stf = stf[:, :cand_cap]

    # Base scores of the candidates: one XLA gather. The D_pad sentinel
    # clamps to the last column; such slots are masked by ``is_last``.
    sbase = scores[tail_rows[:, None], jnp.minimum(sid, D_pad - 1)]

    # Segment totals via shifted adds: a doc appears at most once per rare
    # query term plus once as a leader -> segment length <= width + 1.
    # The d-descending loop accumulates positions in ascending order
    # (exact order parity with the sequential tail loop); masked adds
    # contribute literal 0.0 so float results are unchanged.
    neg = jnp.full((nt, 1), -1, sid.dtype)
    tail_tot = jnp.zeros_like(sv)
    tf_tot = jnp.zeros_like(stf)
    for d in range(min(width, cand_cap - 1), -1, -1):
        if d == 0:
            same = jnp.ones(sid.shape, bool)
            sv_d, stf_d = sv, stf
        else:
            shift_id = jnp.concatenate(
                [jnp.broadcast_to(neg, (nt, d)), sid[:, :-d]], axis=1)
            same = shift_id == sid
            zpad = jnp.zeros((nt, d), jnp.float32)
            sv_d = jnp.concatenate([zpad, sv[:, :-d]], axis=1)
            stf_d = jnp.concatenate([zpad, stf[:, :-d]], axis=1)
        tail_tot = tail_tot + jnp.where(same, sv_d, 0.0)
        tf_tot = tf_tot + jnp.where(same, stf_d, 0.0)

    # Each doc's full score lives at its LAST occurrence; everything else
    # (earlier duplicates, invalid slots) drops to -inf.
    nxt = jnp.concatenate([sid[:, 1:], neg], axis=1)
    is_last = (sid != nxt) & (sid < n_docs)
    total = sbase + tail_tot
    cand_score = jnp.where(is_last, total, -jnp.inf)

    m_scores, m_pos = jax.lax.top_k(cand_score, k)
    m_ids = jnp.take_along_axis(sid, m_pos, axis=1)
    m_tf_tail = jnp.take_along_axis(tf_tot, m_pos, axis=1)

    # Scatter merged rows back; pad tail rows (all slots sentinel)
    # target a trash row so they cannot clobber query 0.
    if pad_row_mask is None:
        pad_row_mask = jnp.all(tail_slots >= R, axis=1)
    trow_safe = jnp.where(pad_row_mask, nq, tail_rows)
    zrow_i = jnp.zeros((1, k), topm_ids.dtype)
    zrow_f = jnp.zeros((1, k), jnp.float32)
    out_ids = jnp.concatenate([topm_ids, zrow_i]).at[trow_safe].set(
        m_ids.astype(topm_ids.dtype))[:nq]
    out_scores = jnp.concatenate([topm_scores, zrow_f]).at[trow_safe].set(
        m_scores)[:nq]
    if base_tail_tf is None:
        base_tail_tf = jnp.zeros((nq, k), jnp.float32)
    out_tail_tf = jnp.concatenate(
        [base_tail_tf, zrow_f]).at[trow_safe].set(m_tf_tail)[:nq]
    return out_ids, out_scores, out_tail_tf


@partial(jax.jit,
         static_argnames=("k", "cand_cap", "n_docs", "prior_free", "approx",
                          "precision", "tf_from_sign",
                          "compact_rmax", "q_int8_ok",
                          "cand_cap2", "cand_capH", "compactH_rmax",
                          "coarse", "cand_cap2H"))
def retrieve_topk_split_sparse(
    dense_impact, dense_presence, post_ids, post_w, doc_lengths, avgdl,
    fslots, fcnt, tail_rows, tail_slots, tail_qcnt, k: int, cand_cap: int,
    alpha, beta, base_rate=None, *, n_docs: int, prior_free: bool = False,
    approx: bool = False, precision=jax.lax.Precision.HIGHEST,
    doc_mask=None, impact_lo=None,
    tf_from_sign: bool = False, compact=None, compact_rmax: int = 0,
    impact_scale=None, q_int8_ok: bool = True,
    post2_ids=None, post2_w=None, tailB_rows=None, tailB_slots=None,
    tailB_qcnt=None, tailB_slots2=None, tailB_qcnt2=None,
    cand_cap2: int = 0, tailH_rows=None, tailH_slots=None, tailH_qcnt=None,
    cand_capH: int = 0, compactH=None, compactH_rmax: int = 0,
    coarse: bool = False,
    tailB2_rows=None, tailB2_slots=None, tailB2_qcnt=None,
    tailB2_slots2=None, tailB2_qcnt2=None, cand_cap2H: int = 0,
):
    """Sparse-candidate exact top-k: one matmul + rare postings merge.

    The frequent-term matmul scores every doc; rare-term contributions are
    merged per query from term-major postings instead of a doc-major
    compare sweep. The candidate SET is exact — no approximation in which
    docs can win — and tf counts are bit-equal (integer-valued f32 sums).
    Scores agree with the dense path to the last ulp: the per-doc tail
    accumulation visits query slots in the same ascending order as the
    compare kernel's fori_loop, but the merge's shifted-add scheduling is
    a different XLA program, so isolated 1-ulp rounding differences (and,
    in principle, a flipped exact-tie ranking) are possible. Exactness of
    the candidate set follows from non-negativity: with M = k matmul-side
    leaders in the candidate set, any
    non-candidate doc d has matmul score <= each leader's, hence full
    score <= each leader's full score, and ties resolve to the leaders'
    smaller ids — so the true top-k is always inside

        candidates(q) = topk_matmul(q)  ∪  postings(rare terms of q).

    This replaces both the (nq, D) tail compare AND the dense presence
    matmul (tf is gathered only at the k winners).
    ``approx=True`` swaps the matmul-side top-k for lax.approx_max_k
    (the rare merge stays exact). On the GPU it lowers to an exact
    top-k, slower than the blockwise selection.
    """
    from bayesian_bm25_tpu.ops import transform as T

    K = dense_impact.shape[1]
    qvec, qpres = _densify_queries(fslots, fcnt, K)
    scores = _impact_matmul(qvec, dense_impact, impact_lo, precision,
                            scale=impact_scale, q_int8_ok=q_int8_ok,
                            coarse=coarse)  # (nq, D_pad)
    if doc_mask is not None:
        # Masked docs drop to -inf BEFORE leader selection and before the
        # sbase gather, so they can neither lead nor win via postings;
        # the exactness argument then holds over the unmasked set (pad
        # rows keep score 0 — they never outrank a positive candidate).
        mask_pad = jnp.concatenate(
            [doc_mask[:n_docs],
             jnp.ones((dense_impact.shape[0] - n_docs,), bool)])
        scores = jnp.where(mask_pad[None, :], scores, -jnp.inf)
    if approx:
        topm_scores, topm_ids = jax.lax.approx_max_k(scores[:, :n_docs], k)
    else:
        # Blockwise leader selection on the full padded width: no slice
        # copy, exact incl. tie order (iota mask handles pad docs).
        topm_scores, topm_ids = exact_topk_blockwise(
            scores, k, block=256, valid_upto=n_docs)

    out_ids, out_scores, out_tail_tf = _sparse_merge(
        scores, topm_scores, topm_ids, post_ids, post_w,
        tail_rows, tail_slots, tail_qcnt, k, cand_cap, n_docs,
        tf_from_sign=tf_from_sign,
        compact=None if compact is None else (compact, compact_rmax))

    if tailH_rows is not None:
        # Heavy pass (light/heavy cap split): the few rows whose rare
        # terms have large postings totals merge at their own wide cap,
        # so the light pass above ran at a ~narrow one. Rows are
        # disjoint from the light group; scatter composition is exact.
        out_ids, out_scores, out_tail_tf = _sparse_merge(
            scores, out_scores, out_ids, post_ids, post_w,
            tailH_rows, tailH_slots, tailH_qcnt, k, cand_capH, n_docs,
            tf_from_sign=tf_from_sign,
            compact=None if compactH is None else (compactH, compactH_rmax),
            base_tail_tf=out_tail_tf)

    if tailB_rows is not None:
        # Tier-2 pass (width-capped indexes): the few query rows that
        # carry over-cap rare terms merge k leaders ++ their TIER-1
        # postings ++ their TIER-2 postings in one candidate set, so a
        # doc scored by terms from both tiers sums exactly. Disjoint
        # from pass-A rows; pads (all tier-2 slots sentinel) route to
        # the trash row.
        R2 = post2_ids.shape[0] - 1
        out_ids, out_scores, out_tail_tf = _sparse_merge(
            scores, out_scores, out_ids, post_ids, post_w,
            tailB_rows, tailB_slots, tailB_qcnt, k, cand_cap2, n_docs,
            tf_from_sign=tf_from_sign,
            postings2=(post2_ids, post2_w, tailB_slots2, tailB_qcnt2),
            pad_row_mask=jnp.all(tailB_slots2 >= R2, axis=1),
            base_tail_tf=out_tail_tf)

    if tailB2_rows is not None:
        # Heavy tier-2 pass (group-B cap split): the few B rows whose
        # combined tier-1+2 postings totals dominate the batch merge at
        # their own wide cap, so the light B pass above ran narrow.
        R2 = post2_ids.shape[0] - 1
        out_ids, out_scores, out_tail_tf = _sparse_merge(
            scores, out_scores, out_ids, post_ids, post_w,
            tailB2_rows, tailB2_slots, tailB2_qcnt, k, cand_cap2H,
            n_docs, tf_from_sign=tf_from_sign,
            postings2=(post2_ids, post2_w, tailB2_slots2, tailB2_qcnt2),
            pad_row_mask=jnp.all(tailB2_slots2 >= R2, axis=1),
            base_tail_tf=out_tail_tf)

    dead = ~jnp.isfinite(out_scores)
    out_scores = jnp.where(dead, 0.0, out_scores)
    out_ids = jnp.where(dead, -1, out_ids)

    # tf only at the k winners: presence-row gather + per-row dot replaces
    # the full (nq, D) presence matmul. Integer-valued f32 sums are exact,
    # so tf matches the dense kernel bit-for-bit.
    pres_rows = dense_presence[jnp.maximum(out_ids, 0)]  # (nq, k, K)
    tf_freq = jnp.einsum("nkc,nc->nk", pres_rows,
                         qpres.astype(dense_presence.dtype),
                         precision=jax.lax.Precision.HIGHEST,
                         preferred_element_type=jnp.float32)
    top_tfs = tf_freq + out_tail_tf

    top_dlr = doc_lengths[jnp.maximum(out_ids, 0)] / avgdl
    probs = T.score_to_probability(
        out_scores, top_tfs, top_dlr, alpha, beta, base_rate,
        prior_free=prior_free,
    )
    probs = jnp.where(out_scores > 0, probs.astype(out_scores.dtype), 0.0)
    return out_ids, probs, out_scores, top_tfs
