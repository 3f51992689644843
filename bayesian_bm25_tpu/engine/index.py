"""Host-side index build -> device-resident doc-major BM25 index.

Design (accelerator-first, not a port of bm25s): instead of a term-major CSR whose
ragged postings force gathers/scatters, the device index is a *doc-major
padded term table*:

    term_ids : (n_docs, T) int32, each row the doc's unique term ids,
               padded with -1
    weights  : (n_docs, T) f32, the fully precomputed BM25 contribution of
               that (doc, term) pair — idf(t) * tf_saturation(tf, dl)

Scoring a query is then a dense, static-shape comparison-accumulate over
(n_docs, T) — elementwise work with zero dynamic indexing — and the same pass
counts |query_set ∩ doc_set| (the reference's "tf" prior feature,
scorer.py:592-601). Block-max metadata for WAND/BMW pruning is a segment-max
over doc blocks of the same table.

BM25 variants match the reference's backend selection (scorer.py:213 —
the reference passes ``method`` straight to ``bm25s.BM25`` with no
validation, so every bm25s method is reference surface):
  robertson: idf = ln((N - df + 0.5) / (df + 0.5)), floored at 0
  lucene:    idf = ln(1 + (N - df + 0.5) / (df + 0.5))
  atire:     idf = ln(N / df)
  with tf-part = s * tf / (tf + K), K = k1 * (1 - b + b * dl / avgdl);
  bm25l:     idf = ln((N + 1) / (df + 0.5));
             tf-part = (k1+1)(c + delta) / (k1 + c + delta),
             c = tf / (1 - b + b * dl / avgdl)        (Lv & Zhai 2011)
  bm25+:     idf = ln((N + 1) / df);
             tf-part = (k1+1) tf / (K + tf) + delta   (Lv & Zhai 2011)

bm25l/bm25+ have a NONZERO tf=0 contribution (``nonoccurrence_score``:
(k1+1)d/(k1+d) resp. d) — a per-query constant shift
``sat0 * sum_t c_t * idf_t`` that never changes rankings. The weight
table stores the doc-dependent part idf*(sat - sat0) (non-negative, so
the sparse-candidate completeness proof and WAND bounds carry over);
the scorer adds the shift on the public raw-score surface
(query_score_shift) for bm25s score parity.

The scale factor ``s`` depends on ``score_scale``:
  "classic" (default): s = k1+1 for robertson/atire (the textbook
             Robertson/ATIRE formulations), s = 1 for lucene (Lucene's
             BM25Similarity drops the constant factor).
  "bm25s":   score-level parity with the bm25s package the reference
             delegates to (scorer.py:213,525-529): bm25s's robertson tfc
             ALSO omits the k1+1 factor (only its atire variant keeps
             it), so s = k1+1 for atire only.
The two scales are rank-identical for every method (a per-corpus
constant factor); they differ numerically only for robertson, by
exactly (k1+1).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

import jax.numpy as jnp

VALID_METHODS = ("robertson", "lucene", "atire", "bm25l", "bm25+")
VALID_SCORE_SCALES = ("classic", "bm25s")
DEFAULT_DELTA = 0.5  # bm25s's default delta for bm25l / bm25+


def nonoccurrence_score(method: str, k1: float, delta: float) -> float:
    """tf=0 saturation value (module docstring); 0 for the classic
    variants, nonzero for bm25l / bm25+."""
    if method == "bm25l":
        return (k1 + 1.0) * delta / (k1 + delta)
    if method == "bm25+":
        return delta
    return 0.0


def tf_scale_factor(method: str, k1: float, score_scale: str = "classic") -> float:
    """Constant multiplier on the tf-saturation term (module docstring)."""
    if score_scale not in VALID_SCORE_SCALES:
        raise ValueError(
            f"score_scale must be one of {VALID_SCORE_SCALES}, "
            f"got {score_scale!r}"
        )
    if method == "atire" or (method == "robertson" and score_scale == "classic"):
        return k1 + 1.0
    return 1.0

# Padding sentinels. Doc-side and query-side pads differ so a padded query
# slot never matches a padded doc slot.
DOC_PAD = -1
QUERY_PAD = -2


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class BM25Index:
    """Device-resident BM25 index + host-side vocabulary.

    Arrays live on the default device (its HBM on a GPU). ``vocab`` maps token ->
    term id; term ids are dense [0, n_terms).
    """

    k1: float
    b: float
    method: str
    vocab: dict = field(repr=False)
    term_ids: jnp.ndarray = field(repr=False)   # (n_docs, T) int32
    weights: jnp.ndarray = field(repr=False)    # (n_docs, T) f32
    doc_lengths: jnp.ndarray = field(repr=False)  # (n_docs,) f32
    doc_frequencies: np.ndarray = field(repr=False)  # (n_terms,) host
    idf: np.ndarray = field(repr=False)         # (n_terms,) host
    n_docs: int = 0
    n_terms: int = 0
    avgdl: float = 0.0
    max_doc_terms: int = 0
    # Score-level compatibility scale (module docstring); "classic" for
    # indexes built before the flag existed.
    score_scale: str = "classic"
    # bm25l/bm25+ lower-bound parameter (bm25s default 0.5); unused by
    # the classic variants.
    delta: float = DEFAULT_DELTA
    # Host mirrors (set by build_index): avoid device->host pulls when
    # building the split accelerator, and make incremental append possible
    # (weights must be recomputed from raw counts when N/df/avgdl change).
    term_ids_host: np.ndarray = field(repr=False, default=None)
    term_counts_host: np.ndarray = field(repr=False, default=None)
    weights_host: np.ndarray = field(repr=False, default=None)
    doc_lengths_host: np.ndarray = field(repr=False, default=None)

    @property
    def num_docs(self) -> int:
        return self.n_docs

    def __getstate__(self):
        # The native-encoder cache holds ctypes handles (unpicklable and
        # process-local); it rebuilds lazily on first encode after load.
        state = dict(self.__dict__)
        state.pop("_native_encoder_cache", None)
        return state


def compute_idf(df: np.ndarray, n_docs: int, method: str) -> np.ndarray:
    """Per-term inverse document frequency for a BM25 variant."""
    df = df.astype(np.float64)
    if method == "robertson":
        return np.maximum(np.log((n_docs - df + 0.5) / (df + 0.5)), 0.0)
    if method == "lucene":
        return np.log1p((n_docs - df + 0.5) / (df + 0.5))
    if method == "atire":
        return np.log(n_docs / df)
    if method == "bm25l":
        return np.log((n_docs + 1.0) / (df + 0.5))
    if method == "bm25+":
        return np.log((n_docs + 1.0) / df)
    raise ValueError(f"method must be one of {VALID_METHODS}, got {method!r}")


def tf_saturation(tf, doc_len, avgdl, k1: float, b: float, method: str,
                  score_scale: str = "classic",
                  delta: float = DEFAULT_DELTA):
    """BM25 term-frequency saturation for tf > 0 (see module docstring).

    For bm25l/bm25+ this is the FULL saturation (including delta); the
    weight table subtracts ``nonoccurrence_score`` so the stored weight
    is the doc-dependent part."""
    norm = 1.0 - b + b * doc_len / max(avgdl, 1e-12)
    if method == "bm25l":
        c = tf / norm
        return (k1 + 1.0) * (c + delta) / (k1 + c + delta)
    if method == "bm25+":
        return (k1 + 1.0) * tf / (k1 * norm + tf) + delta
    sat = tf / (tf + k1 * norm)
    return tf_scale_factor(method, k1, score_scale) * sat


def _corpus_to_csr(corpus_tokens: list[list[str]], vocab: dict):
    """Python fallback for the native corpus builder: per-doc unique
    (term_id, count) CSR arrays in first-occurrence order."""
    n_docs = len(corpus_tokens)
    indptr = np.zeros(n_docs + 1, dtype=np.int64)
    term_ids: list[int] = []
    term_counts: list[int] = []
    doc_lengths = np.zeros(n_docs, dtype=np.int64)
    for i, tokens in enumerate(corpus_tokens):
        doc_lengths[i] = len(tokens)
        counts: dict[int, int] = {}
        for tok in tokens:
            tid = vocab.get(tok)
            if tid is None:
                tid = len(vocab)
                vocab[tok] = tid
            counts[tid] = counts.get(tid, 0) + 1
        term_ids.extend(counts.keys())
        term_counts.extend(counts.values())
        indptr[i + 1] = len(term_ids)
    return (
        indptr,
        np.asarray(term_ids, dtype=np.int64),
        np.asarray(term_counts, dtype=np.int64),
        doc_lengths,
    )


def build_index(
    corpus_tokens: list[list[str]],
    k1: float = 1.2,
    b: float = 0.75,
    method: str = "robertson",
    vocab: dict | None = None,
    pad_multiple: int = 128,
    doc_pad_multiple: int = 2048,
    csr=None,
    score_scale: str = "classic",
    delta: float = DEFAULT_DELTA,
) -> BM25Index:
    """Tokenized corpus -> device index.

    The host pass builds the vocabulary and per-doc (term, count) CSR (in
    C++ via ``csr=`` from engine/native.py when available); the
    per-(doc, term) BM25 contributions are then computed fully vectorized
    and scattered into the padded doc-major table. ``vocab`` can be
    supplied to share a term-id space across indexes (multi-field search).
    """
    if method not in VALID_METHODS:
        raise ValueError(f"method must be one of {VALID_METHODS}, got {method!r}")
    if score_scale not in VALID_SCORE_SCALES:
        raise ValueError(
            f"score_scale must be one of {VALID_SCORE_SCALES}, "
            f"got {score_scale!r}"
        )

    n_docs = len(corpus_tokens)
    if n_docs == 0:
        raise ValueError("corpus must contain at least one document")

    if vocab is None:
        vocab = {}
    if csr is None:
        built = None
        if not vocab:
            # Fresh build: one C++ pass over a token blob replaces the
            # per-token Python dict loop (~7x at 200k docs). Appends and
            # shared-vocab (multi-field) builds keep the Python path,
            # which seeds from an existing vocab.
            try:
                from bayesian_bm25_tpu.engine.native import (
                    build_corpus_tokens_native,
                )

                built = build_corpus_tokens_native(corpus_tokens)
            except (ImportError, OSError):
                built = None
        if built is not None:
            nvocab, indptr, tids_flat, counts_flat, doc_len_i = built
            vocab.update(nvocab)
        else:
            indptr, tids_flat, counts_flat, doc_len_i = _corpus_to_csr(
                corpus_tokens, vocab
            )
    else:
        indptr, tids_flat, counts_flat, doc_len_i = csr
    doc_lengths = doc_len_i.astype(np.float64)

    n_terms = len(vocab)
    avgdl = float(np.mean(doc_lengths)) if n_docs else 0.0

    # Document frequencies: CSR rows hold unique terms, so one bincount.
    df = np.bincount(tids_flat, minlength=n_terms).astype(np.int64)
    idf = compute_idf(np.maximum(df, 1), n_docs, method)

    per_doc_terms = np.diff(indptr)
    max_terms = int(per_doc_terms.max()) if n_docs else 1
    T = max(_round_up(max(max_terms, 1), pad_multiple), pad_multiple)

    # Pad the doc axis to the doc-block multiple; pad rows have no
    # terms (never match) and doc_length = avgdl (harmless: their score is 0
    # so downstream probability is 0 and they can't enter top-k above a real
    # match).
    D_pad = _round_up(n_docs, doc_pad_multiple)
    term_ids = np.full((D_pad, T), DOC_PAD, dtype=np.int32)
    counts = np.zeros((D_pad, T), dtype=np.int32)

    if len(tids_flat):
        row = np.repeat(np.arange(n_docs), per_doc_terms)
        col = np.arange(len(tids_flat)) - indptr[row]
        term_ids[row, col] = tids_flat
        counts[row, col] = counts_flat

    doc_lengths_pad = np.full(D_pad, max(avgdl, 1.0), dtype=np.float64)
    doc_lengths_pad[:n_docs] = doc_lengths

    weights = _compute_weight_table(
        term_ids, counts, doc_lengths_pad, avgdl, idf, k1, b, method,
        score_scale, delta)

    return BM25Index(
        k1=k1,
        b=b,
        method=method,
        score_scale=score_scale,
        delta=delta,
        vocab=vocab,
        term_ids=jnp.asarray(term_ids),
        weights=jnp.asarray(weights),
        doc_lengths=jnp.asarray(doc_lengths_pad, dtype=jnp.float32),
        doc_frequencies=df,
        idf=idf,
        n_docs=n_docs,
        n_terms=n_terms,
        avgdl=avgdl,
        max_doc_terms=T,
        term_ids_host=term_ids,
        term_counts_host=counts,
        weights_host=weights,
        doc_lengths_host=doc_lengths_pad,
    )


def _compute_weight_table(term_ids, counts, doc_lengths_pad, avgdl, idf,
                          k1: float, b: float, method: str,
                          score_scale: str = "classic",
                          delta: float = DEFAULT_DELTA) -> np.ndarray:
    """(D_pad, T) float32 BM25 contributions from the counts table.

    Float64 throughout (matching the flat-array build path bit-for-bit);
    pad slots (count 0) produce weight 0 exactly. For bm25l/bm25+ the
    stored weight is idf * (sat(tf) - sat(0)) — non-negative, with the
    per-query constant idf * sat(0) shift added by the scorer on the
    raw-score surface only (module docstring)."""
    cf = counts.astype(np.float64)
    norm = 1.0 - b + b * doc_lengths_pad / max(avgdl, 1e-12)
    if method == "bm25l":
        c = cf / norm[:, None]
        sat = (k1 + 1.0) * (c + delta) / (k1 + c + delta)
        sat -= nonoccurrence_score(method, k1, delta)
    elif method == "bm25+":
        sat = (k1 + 1.0) * cf / (k1 * norm[:, None] + cf)
        # the +delta and the -sat0 = -delta cancel exactly
    else:
        K = k1 * norm
        sat = tf_scale_factor(method, k1, score_scale) * (cf / (cf + K[:, None]))
    w = np.where(term_ids >= 0, idf[np.maximum(term_ids, 0)] * sat, 0.0)
    return w.astype(np.float32)


def append_to_index(
    idx: BM25Index,
    new_corpus_tokens: list[list[str]],
    *,
    pad_multiple: int = 128,
    doc_pad_multiple: int = 2048,
) -> BM25Index:
    """Append documents to an existing index without re-tokenizing the
    old corpus.

    The reference re-indexes everything on add_documents (scorer.py:
    469-492) because IDF/avgdl are global; here only the NEW docs are
    tokenized and counted — the (doc, term) count table is append-only —
    and the per-(doc, term) weights are recomputed vectorized from the
    counts with the updated df/N/avgdl. The result is bit-identical to a
    full rebuild of old+new (same vocab id assignment by first-occurrence
    order, same float64 weight formula; verified by the reindex-
    equivalence fuzz in tests/test_engine_fuzz.py).
    """
    if idx.term_counts_host is None:
        raise ValueError("index lacks host count mirrors (old checkpoint?); "
                         "rebuild with build_index()")
    n_old = idx.n_docs
    n_new = len(new_corpus_tokens)
    if n_new == 0:
        return idx
    vocab = idx.vocab  # mutated in place: new terms appended in
    # first-occurrence order, exactly like a full rebuild would assign ids
    indptr, tids_flat, counts_flat, new_len_i = _corpus_to_csr(
        new_corpus_tokens, vocab
    )
    n_terms = len(vocab)
    n_docs = n_old + n_new

    df = np.bincount(tids_flat, minlength=n_terms).astype(np.int64)
    df[: idx.n_terms] += idx.doc_frequencies
    idf = compute_idf(np.maximum(df, 1), n_docs, idx.method)

    old_dl = idx.doc_lengths_host[:n_old]
    dl_all = np.concatenate([old_dl, new_len_i.astype(np.float64)])
    # np.mean over the concatenated array — same pairwise-summation order
    # as a full rebuild, so avgdl (and every weight derived from it) is
    # bit-identical.
    avgdl = float(np.mean(dl_all))

    per_doc_terms = np.diff(indptr)
    T = max(idx.max_doc_terms,
            _round_up(max(int(per_doc_terms.max(initial=1)), 1), pad_multiple))
    D_pad = _round_up(n_docs, doc_pad_multiple)

    term_ids = np.full((D_pad, T), DOC_PAD, dtype=np.int32)
    counts = np.zeros((D_pad, T), dtype=np.int32)
    T_old = idx.max_doc_terms
    term_ids[:n_old, :T_old] = idx.term_ids_host[:n_old]
    counts[:n_old, :T_old] = idx.term_counts_host[:n_old]
    if len(tids_flat):
        row = n_old + np.repeat(np.arange(n_new), per_doc_terms)
        col = np.arange(len(tids_flat)) - indptr[row - n_old]
        term_ids[row, col] = tids_flat
        counts[row, col] = counts_flat

    doc_lengths_pad = np.full(D_pad, max(avgdl, 1.0), dtype=np.float64)
    doc_lengths_pad[:n_old] = old_dl
    doc_lengths_pad[n_old:n_docs] = new_len_i

    scale = getattr(idx, "score_scale", "classic")
    delta = getattr(idx, "delta", DEFAULT_DELTA)
    weights = _compute_weight_table(
        term_ids, counts, doc_lengths_pad, avgdl, idf,
        idx.k1, idx.b, idx.method, scale, delta)

    return BM25Index(
        k1=idx.k1, b=idx.b, method=idx.method, score_scale=scale,
        delta=delta, vocab=vocab,
        term_ids=jnp.asarray(term_ids),
        weights=jnp.asarray(weights),
        doc_lengths=jnp.asarray(doc_lengths_pad, dtype=jnp.float32),
        doc_frequencies=df, idf=idf,
        n_docs=n_docs, n_terms=n_terms, avgdl=avgdl, max_doc_terms=T,
        term_ids_host=term_ids, term_counts_host=counts,
        weights_host=weights, doc_lengths_host=doc_lengths_pad,
    )


def build_index_from_texts(
    texts: list[str],
    k1: float = 1.2,
    b: float = 0.75,
    method: str = "robertson",
    *,
    lowercase: bool = True,
    remove_stopwords: bool = True,
    stem: bool | str = True,
    use_native: bool | str = "auto",
    return_tokens: bool = True,
    score_scale: str = "classic",
    delta: float = DEFAULT_DELTA,
):
    """Raw texts -> (BM25Index, corpus_tokens) using the C++ tokenizer +
    corpus builder when available (one native pass for tokenize + vocab +
    counting), falling back to the Python pipeline. With
    ``return_tokens=False`` the per-doc token lists are not materialized
    (skips a full decode pass; corpus_tokens comes back None)."""
    if use_native in ("auto", True):
        try:
            from bayesian_bm25_tpu.engine.native import (
                build_corpus_native,
                tokenize_texts_native,
            )

            vocab, indptr, tids, counts, dlens = build_corpus_native(
                texts, lowercase=lowercase,
                remove_stopwords=remove_stopwords, stem=stem,
            )
            corpus_tokens = None
            if return_tokens:
                corpus_tokens = tokenize_texts_native(
                    texts, lowercase=lowercase,
                    remove_stopwords=remove_stopwords, stem=stem,
                )
            idx = build_index(
                [None] * len(texts), k1=k1, b=b, method=method, vocab=vocab,
                csr=(indptr, tids.astype(np.int64),
                     counts.astype(np.int64), dlens.astype(np.int64)),
                score_scale=score_scale, delta=delta,
            )
            return idx, corpus_tokens
        except (ImportError, OSError):
            if use_native is True:
                raise
    from bayesian_bm25_tpu.engine.tokenize import tokenize_py

    corpus_tokens = [
        tokenize_py(t, lowercase=lowercase,
                    remove_stopwords=remove_stopwords, stem=stem)
        for t in texts
    ]
    return build_index(corpus_tokens, k1=k1, b=b, method=method,
                       score_scale=score_scale, delta=delta), corpus_tokens


def query_score_shift(idx: BM25Index,
                      query_tokens_batch: list[list[str]]) -> np.ndarray:
    """Per-query bm25l/bm25+ nonoccurrence shift (module docstring):
    ``sat0 * sum_t c_t * idf_t`` over the query's in-vocab token
    occurrences. Zeros for the classic variants. Rank-neutral (constant
    across docs within a query); the scorer adds it to the public raw
    scores so bm25l/bm25+ score-level parity with bm25s holds."""
    sat0 = nonoccurrence_score(idx.method, idx.k1,
                               getattr(idx, "delta", DEFAULT_DELTA))
    nq = len(query_tokens_batch)
    shift = np.zeros(nq, dtype=np.float64)
    if sat0 == 0.0:
        return shift
    vocab = idx.vocab
    idf = idx.idf
    for qi, toks in enumerate(query_tokens_batch):
        s = 0.0
        for tok in toks:
            tid = vocab.get(tok)
            if tid is not None and tid < len(idf):
                s += idf[tid]
        shift[qi] = sat0 * s
    return shift


def get_native_encoder(index):
    """Cached native ``VocabEncoder`` for this index's vocabulary.

    Returns None when the C++ toolchain is unavailable. The cache lives on
    the index instance and is invalidated when the vocabulary grows
    (``append_documents`` extends the shared vocab dict in place but
    returns a new index, so staleness can only arise through aliasing —
    the length guard covers it).
    """
    cached = getattr(index, "_native_encoder_cache", None)
    if cached is not None and cached[1] == len(index.vocab):
        return cached[0]
    try:
        from bayesian_bm25_tpu.engine.native import VocabEncoder

        enc = VocabEncoder(index.vocab)
    except (ImportError, OSError):
        enc = None
    object.__setattr__(index, "_native_encoder_cache", (enc, len(index.vocab)))
    return enc


def query_term_pairs(query_tokens: list, vocab: dict, native_encoder=None):
    """Queries -> deduplicated (query, term, count) triples.

    Returns (pq, pt, counts) int64/int64/int arrays grouped by query
    (ascending) with term ids ascending within each query, or None when no
    query token is in vocabulary. The native encoder (one C++ pass over a
    token blob) and the Python dict-loop fallback produce bit-identical
    output.
    """
    if native_encoder is not None:
        out = native_encoder.encode_tokens(query_tokens)
        if out is not None:
            pq32, pt32, pc32 = out
            if len(pq32) == 0:
                return None
            return (pq32.astype(np.int64), pt32.astype(np.int64), pc32)

    get = vocab.get
    flat_q: list = []
    flat_t: list = []
    for qi, tokens in enumerate(query_tokens):
        for tok in tokens:
            tid = get(tok)
            if tid is not None:
                flat_q.append(qi)
                flat_t.append(tid)
    if not flat_t:
        return None
    qarr = np.asarray(flat_q, dtype=np.int64)
    tarr = np.asarray(flat_t, dtype=np.int64)
    V = max(len(vocab), 1)
    pair, counts = np.unique(qarr * V + tarr, return_counts=True)
    return pair // V, pair % V, counts


def encode_queries(
    query_tokens: list[list[str]],
    vocab: dict,
    max_query_terms: int | None = None,
    pad_multiple: int = 8,
    native_encoder=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Tokenized queries -> (qids, qcounts) padded arrays.

    Each row holds the query's *unique* in-vocabulary term ids plus their
    multiplicities, padded with QUERY_PAD / 0. Scoring then sums
    count * weight per matched term — identical to summing per query token —
    while the same comparison counts unique-term overlap for the tf prior.
    OOV terms are dropped (they contribute 0 score and cannot be in any
    doc's token set). Queries with more unique terms than the padded width
    keep the first ``max_query_terms`` unique terms in ascending-term-id
    order.
    """
    nq = len(query_tokens)
    min_Q = _round_up(1, pad_multiple)
    pairs = query_term_pairs(query_tokens, vocab, native_encoder)
    if pairs is None:
        return (np.full((nq, min_Q), QUERY_PAD, np.int32),
                np.zeros((nq, min_Q), np.float32))
    pq, pt, counts = pairs
    uniq_q, start = np.unique(pq, return_index=True)
    per = np.diff(np.append(start, len(pq)))
    Q = _round_up(int(per.max()), pad_multiple)
    if max_query_terms is not None:
        Q = min(Q, _round_up(max_query_terms, pad_multiple))
    col = np.arange(len(pq)) - start[np.searchsorted(uniq_q, pq)]
    keep = col < Q  # first-Q unique terms when a query overflows
    qids = np.full((nq, Q), QUERY_PAD, dtype=np.int32)
    qcnt = np.zeros((nq, Q), dtype=np.float32)
    qids[pq[keep], col[keep]] = pt[keep]
    qcnt[pq[keep], col[keep]] = counts[keep]
    return qids, qcnt
