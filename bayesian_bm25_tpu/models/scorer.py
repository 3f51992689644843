"""BayesianBM25Scorer: the owned-engine scorer returning calibrated
probabilities.

API parity with the reference scorer (bayesian_bm25/scorer.py:166-640),
but the backend is this package's own device engine instead of ``bm25s``:
``index()`` builds the device-resident doc-major table and auto-estimates
(alpha, beta, base_rate) from one *batched* pseudo-query scoring call
(the reference loops 50 full-corpus scans, scorer.py:287-311); ``retrieve``
and ``get_probabilities`` run the fused scoring->transform kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax.numpy as jnp

from bayesian_bm25_tpu.engine import index as eidx
from bayesian_bm25_tpu.engine import scoring
from bayesian_bm25_tpu.models.probability import BayesianProbabilityTransform

_VALID_BASE_RATE_METHODS = ("percentile", "mixture", "elbow")


def _lax_precisions():
    import jax.lax as lax

    return {
        "highest": lax.Precision.HIGHEST,
        "high": lax.Precision.HIGH,
        "default": lax.Precision.DEFAULT,
    }


_MATMUL_PRECISIONS = _lax_precisions()


@dataclass
class RetrievalResult:
    """Result of ``retrieve(explain=True)``: ids, probabilities, and
    per-(query, rank) BM25SignalTrace explanations (None when a score is 0).
    """

    doc_ids: np.ndarray
    probabilities: np.ndarray
    explanations: list | None


class _LazyTokens:
    """Sequence view over raw texts that tokenizes per-doc on demand.

    Lets ``index_texts`` skip materializing millions of token lists: only
    docs actually inspected (pseudo-query sampling, explain traces,
    add_documents) are tokenized, and the seeded pseudo-query sample is
    pre-populated in ``known``.
    """

    def __init__(self, texts, *, lowercase, remove_stopwords, stem,
                 known=None):
        self._texts = texts
        self._opts = dict(lowercase=lowercase,
                          remove_stopwords=remove_stopwords, stem=stem)
        self._cache = dict(known or {})

    def __len__(self):
        return len(self._texts)

    def __getitem__(self, i):
        i = int(i)
        if i not in self._cache:
            from bayesian_bm25_tpu.engine.tokenize import tokenize_py

            self._cache[i] = tokenize_py(self._texts[i], **self._opts)
        return self._cache[i]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __add__(self, other):
        # Chain instead of materializing: tokenizing the whole corpus on
        # append would be a host-side cliff at large scale.
        return _ChainedTokens([self, list(other)])


class _ChainedTokens:
    """Concatenated view over token sequences (lists or _LazyTokens)
    with per-doc random access and no materialization."""

    def __init__(self, parts):
        self._parts = []
        for p in parts:
            if isinstance(p, _ChainedTokens):
                self._parts.extend(p._parts)
            else:
                self._parts.append(p)
        self._offsets = np.cumsum([0] + [len(p) for p in self._parts])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, i):
        i = int(i)
        if i < 0:
            i += len(self)
        part = int(np.searchsorted(self._offsets, i, side="right")) - 1
        return self._parts[part][i - int(self._offsets[part])]

    def __iter__(self):
        for p in self._parts:
            yield from p

    def __add__(self, other):
        return _ChainedTokens(self._parts + [list(other)])


def _pow2_bucket_int(n: int, minimum: int) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class BayesianBM25Scorer:
    """BM25 scorer that returns Bayesian-calibrated probabilities.

    Parameters mirror the reference (scorer.py:198-222): BM25 (k1, b,
    method in {robertson, lucene, atire, bm25l, bm25+} — the reference
    forwards method to bm25s unvalidated, so all five bm25s variants
    are its surface; ``delta`` is the bm25l/bm25+ lower bound, bm25s
    default 0.5); alpha/beta auto-estimated from
    pseudo-query score statistics when None; base_rate None | "auto" |
    float, with "auto" dispatching to percentile / mixture / elbow
    estimation. ``matmul_precision`` ("high" default | "highest" |
    "default") is an extension: the algorithm of the f32 frequent-term
    matmul — see the ctor comment for the speed/exactness trade.
    ``impact_storage`` (None | "f32" | "hilo" | "bf16" | "int8")
    overrides the impact-matrix representation: "int8" runs the scoring
    matmul as two int8 x int8 -> int32 GEMMs at an absolute
    ~amax/64500 per-doc error class — same bytes/element as "bf16" with
    ~20x lower error; exact cross-doc score ties may re-order (per-doc
    scales quantize tied scores apart). It is also the automatic
    storage past 2^18 padded docs.
    """

    def __init__(
        self,
        k1: float = 1.2,
        b: float = 0.75,
        method: str = "robertson",
        alpha: float | None = None,
        beta: float | None = None,
        base_rate: float | str | None = None,
        base_rate_method: str = "percentile",
        matmul_precision: str = "high",
        impact_storage: str | None = None,
        score_scale: str = "classic",
        delta: float = eidx.DEFAULT_DELTA,
    ) -> None:
        if base_rate_method not in _VALID_BASE_RATE_METHODS:
            raise ValueError(
                f"base_rate_method must be one of {_VALID_BASE_RATE_METHODS}, "
                f"got {base_rate_method!r}"
            )
        if method not in eidx.VALID_METHODS:
            raise ValueError(
                f"method must be one of {eidx.VALID_METHODS}, got {method!r}"
            )
        if score_scale not in eidx.VALID_SCORE_SCALES:
            raise ValueError(
                f"score_scale must be one of {eidx.VALID_SCORE_SCALES}, "
                f"got {score_scale!r}"
            )
        if not delta > 0:
            raise ValueError(f"delta must be positive, got {delta!r}")
        if matmul_precision not in _MATMUL_PRECISIONS:
            raise ValueError(
                f"matmul_precision must be one of "
                f"{tuple(_MATMUL_PRECISIONS)}, got {matmul_precision!r}"
            )
        if impact_storage not in (None, "f32", "hilo", "bf16", "int8"):
            raise ValueError(
                "impact_storage must be one of (None, 'f32', 'hilo', "
                f"'bf16', 'int8'), got {impact_storage!r}"
            )
        # Explicit impact-matrix representation override; None maps it
        # from matmul_precision (and to int8 on huge corpora). "int8"
        # stores a (hi, lo) int8 pair + per-doc scale: two integer GEMMs
        # at ~3e-5 relative — same bytes as one bf16 copy, so it is also
        # the sharpest storage that fits huge-corpus budgets. Its speed
        # against the other tiers on the H100 is not yet measured.
        self._impact_storage = impact_storage
        # Serving knob: the algorithm of the f32 frequent-term matmul.
        # "high" (the default) maps to hilo storage (~8e-6 relative) and,
        # under explicit f32 storage, to three bf16 passes (~1e-5);
        # "highest" is a full f32 GEMM, bit-equal to the doc-major
        # compare path; "default" is one TF32 pass on the GPU (~5e-4).
        # The automatic >=256k-doc tier is the int8 pair (~2e-4
        # worst-case, ~3e-5 typical). tf/presence math is exact under
        # every setting.
        self._matmul_precision = _MATMUL_PRECISIONS[matmul_precision]
        self._matmul_precision_name = matmul_precision
        self._k1 = k1
        self._b = b
        self._method = method
        # "classic" = textbook Robertson/ATIRE (k1+1) scaling; "bm25s" =
        # score-level equality with the bm25s package the reference
        # delegates to (its robertson tfc omits k1+1 too). Rank-identical
        # either way; robertson scores differ by exactly (k1+1).
        self._score_scale = score_scale
        # bm25l/bm25+ lower-bound parameter (bm25s default 0.5).
        self._delta = delta
        self._user_alpha = alpha
        self._user_beta = beta
        self._user_base_rate = base_rate
        self._base_rate_method = base_rate_method
        self._index: eidx.BM25Index | None = None
        self._split = None  # frequency-split accelerator (engine/split_index)
        self._transform: BayesianProbabilityTransform | None = None
        self._corpus_tokens: list[list[str]] | None = None
        # Tokenizer options from index_texts; retrieve_texts must tokenize
        # queries identically or vocab lookups silently miss.
        self._tok_opts = dict(lowercase=True, remove_stopwords=True,
                              stem=True)
        # Tombstone mask (host bool, length num_docs, True = deleted):
        # delete_documents excludes docs from every query path without
        # rebuilding the index; None until a first delete.
        self._deleted: np.ndarray | None = None

    # Split index is built when its dense matrices stay under this
    # budget (impact storage + presence bf16, K columns x D_pad rows);
    # beyond it the doc-major compare path alone is the memory-sane
    # choice. Past _SPLIT_INT8_MIN_DOCS the impact matrix is stored as
    # an (hi, lo) int8 pair with per-doc scales: the same 2 bytes/element
    # as single-bf16 but ~20x lower score error (2e-4 vs 3e-3 max
    # relative); its speed against bf16 and hilo on the H100 is not yet
    # measured. The halved footprint (vs the
    # hilo pair) keeps K large — which the sparse-candidate retrieve
    # path needs, because rare-term postings lengths are bounded by the
    # K-th most frequent term's df.
    _SPLIT_BUDGET_BYTES = 4 << 30
    _SPLIT_INT8_MIN_DOCS = 1 << 18
    # Serving-batch auto-chunking: the retrieval kernel's dominant
    # intermediate is the (nq, D_pad) f32 score matrix; keep it under
    # this budget by splitting oversized caller batches into pipelined
    # chunks (8192-query chunks at 50k docs, 1024 at 1M). The budget
    # was sized for a 16 GB device; its best value on the H100 is not
    # yet measured.
    _SCORES_BUDGET_BYTES = 4 << 30

    def _maybe_build_split(self) -> None:
        from bayesian_bm25_tpu.engine import split_index as sidx

        idx = self._index
        D_pad = idx.term_ids.shape[0]
        use_int8 = D_pad >= self._SPLIT_INT8_MIN_DOCS
        if self._impact_storage is not None:
            storage = self._impact_storage
        else:
            storage = "int8" if use_int8 else self._split_storage()
        # Bytes per K column: impact pair (int8 hi+lo = 2, hilo bf16
        # pair = 4, single bf16 = 2, f32 = 4) + bf16 presence (2).
        impact_bytes = {"int8": 2, "hilo": 4, "bf16": 2}.get(storage, 4)
        bytes_per_col = D_pad * (impact_bytes + 2)
        k_budget = self._SPLIT_BUDGET_BYTES // max(bytes_per_col, 1)
        # K=2048 trades the matmul's width against the rare postings'
        # length (a smaller K widens the postings, a larger one grows
        # the matmul); its best value on the H100 is not yet measured.
        # The budget clamp keeps huge corpora within device memory
        # (e.g. K=1024 at 1M docs).
        K = min(2048, (k_budget // 128) * 128,
                ((max(idx.n_terms, 1) + 127) // 128) * 128)
        if K >= 128 and idx.n_terms > 256:
            self._split = sidx.build_split_index(
                idx, n_frequent=int(K), storage=storage)
        else:
            self._split = None

    def _split_storage(self) -> str:
        """Impact-matrix storage for sub-bf16-threshold corpora, mapped
        from the matmul_precision knob: "high" (the default) means
        hi/lo-bf16 pair storage — two exact-operand bf16 passes at ~8e-6
        relative error; "highest"/"default" keep f32 storage with a full
        f32 / one TF32 pass (highest stays bit-equal to the doc-major
        compare path)."""
        import jax.lax as lax

        if self._matmul_precision == lax.Precision.HIGH:
            return "hilo"
        return "f32"

    def _doc_pad_multiple(self) -> int:
        """Doc-axis padding multiple, used by BOTH the initial build and
        incremental appends (ShardedBayesianBM25Scorer overrides with
        lcm(2048, n_shards) so the doc axis always divides its mesh)."""
        return 2048

    def _build_index(self, corpus_tokens) -> eidx.BM25Index:
        """Index-construction hook."""
        return eidx.build_index(
            corpus_tokens, k1=self._k1, b=self._b, method=self._method,
            doc_pad_multiple=self._doc_pad_multiple(),
            score_scale=self._score_scale, delta=self._delta,
        )

    def _finalize_index(self) -> None:
        """Placement hook, called whenever the index/split is (re)built
        (sharded scorer re-places arrays over its mesh here)."""

    # -- properties ----------------------------------------------------------

    @property
    def num_docs(self) -> int:
        if self._index is None:
            raise RuntimeError("Call index() before accessing num_docs.")
        return self._index.n_docs

    @property
    def doc_lengths(self) -> np.ndarray:
        if self._index is None:
            raise RuntimeError("Call index() before accessing doc_lengths.")
        return np.asarray(self._index.doc_lengths)[: self._index.n_docs].astype(
            np.float64
        )

    @property
    def avgdl(self) -> float:
        if self._index is None:
            raise RuntimeError("Call index() before accessing avgdl.")
        return self._index.avgdl

    @property
    def base_rate(self) -> float | None:
        if self._transform is None:
            return None
        return self._transform.base_rate

    @property
    def transform(self) -> BayesianProbabilityTransform | None:
        """The fitted probability transform (None before index())."""
        return self._transform

    @property
    def bm25_index(self) -> eidx.BM25Index | None:
        """The underlying device index (None before index())."""
        return self._index

    # -- indexing ------------------------------------------------------------

    def index(self, corpus_tokens: list[list[str]], show_progress: bool = True
              ) -> None:
        """Build the device index and auto-calibrate the transform.

        Pseudo-query sampling matches the reference protocol (seed 42,
        <= 50 docs, first 5 tokens each, keep nonzero scores,
        scorer.py:287-311) but scores all pseudo-queries in one batched
        device call.
        """
        del show_progress  # device build has no incremental progress
        self._deleted = None  # fresh index, fresh lifecycle
        self._corpus_tokens = corpus_tokens
        self._index = self._build_index(corpus_tokens)
        self._maybe_build_split()
        self._finalize_index()

        per_query_scores = self._sample_pseudo_query_scores(corpus_tokens)
        alpha, beta = self._estimate_parameters(per_query_scores)

        base_rate: float | None = None
        if self._user_base_rate == "auto":
            base_rate = self._estimate_base_rate(per_query_scores, len(corpus_tokens))
        elif isinstance(self._user_base_rate, (int, float)):
            base_rate = float(self._user_base_rate)

        self._transform = BayesianProbabilityTransform(
            alpha=alpha, beta=beta, base_rate=base_rate
        )

    def index_texts(self, texts: list[str], *, lowercase: bool = True,
                    remove_stopwords: bool = True, stem: bool | str = True) -> None:
        """Index raw texts via the native tokenize+build pipeline.

        Extension over the reference's tokens-only ``index()``:
        one C++ pass for tokenization/vocab/counting, token lists
        materialized lazily (only add_documents needs them).
        """
        from bayesian_bm25_tpu.engine.tokenize import tokenize_texts

        self._deleted = None  # fresh index, fresh lifecycle
        self._tok_opts = dict(lowercase=lowercase,
                              remove_stopwords=remove_stopwords, stem=stem)
        idx, corpus_tokens = eidx.build_index_from_texts(
            texts, k1=self._k1, b=self._b, method=self._method,
            lowercase=lowercase, remove_stopwords=remove_stopwords,
            stem=stem, return_tokens=False,
            score_scale=self._score_scale, delta=self._delta,
        )
        self._index = idx
        if corpus_tokens is None:
            # Native path: only the <=50 sampled pseudo-query docs need
            # token lists; tokenize just those.
            rng = np.random.default_rng(42)
            sample = rng.choice(len(texts), size=min(len(texts), 50),
                                replace=False)
            sampled_tokens = tokenize_texts(
                [texts[i] for i in sample], lowercase=lowercase,
                remove_stopwords=remove_stopwords, stem=stem,
            )
            corpus_tokens = _LazyTokens(
                texts, lowercase=lowercase,
                remove_stopwords=remove_stopwords, stem=stem,
                known=dict(zip((int(i) for i in sample), sampled_tokens)),
            )
        self._corpus_tokens = corpus_tokens
        self._maybe_build_split()
        self._finalize_index()
        per_query_scores = self._sample_pseudo_query_scores(corpus_tokens)
        alpha, beta = self._estimate_parameters(per_query_scores)
        base_rate: float | None = None
        if self._user_base_rate == "auto":
            base_rate = self._estimate_base_rate(per_query_scores, len(texts))
        elif isinstance(self._user_base_rate, (int, float)):
            base_rate = float(self._user_base_rate)
        self._transform = BayesianProbabilityTransform(
            alpha=alpha, beta=beta, base_rate=base_rate
        )

    def index_jsonl(self, path: str, *, lowercase: bool = True,
                    remove_stopwords: bool = True,
                    stem: bool | str = True) -> list[str]:
        """Index a BEIR-format corpus.jsonl end-to-end natively.

        The C++ data loader parses the file (depth-tracked mini-JSON:
        "_id"/"title"/"text" at the top level, escapes and \\uXXXX
        decoded) and hands the document bodies to the C++ corpus builder
        as one blob — per-document text never materializes as Python
        strings. Returns the corpus doc-id strings in index order, so
        ``retrieve`` row indices map back to dataset ids. Falls back to a
        Python json pass + ``index_texts`` when the native toolchain is
        unavailable.
        """
        try:
            from bayesian_bm25_tpu.engine.native import load_jsonl_native

            loaded = load_jsonl_native(path)
        except (ImportError, OSError):
            loaded = None
        if loaded is None:
            import json

            ids: list[str] = []
            texts: list[str] = []
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    row = json.loads(line)
                    did = str(row.get("_id", ""))
                    if not did:
                        continue
                    ids.append(did)
                    texts.append(row.get("text", ""))
            self.index_texts(texts, lowercase=lowercase,
                             remove_stopwords=remove_stopwords, stem=stem)
            return ids
        ids, _titles, texts = loaded
        self.index_texts(texts, lowercase=lowercase,
                         remove_stopwords=remove_stopwords, stem=stem)
        return ids

    def _sample_pseudo_query_scores(self, corpus_tokens) -> list[np.ndarray]:
        """<=50 sampled docs as 5-token pseudo-queries -> per-query nonzero
        score arrays, via one batched scoring call."""
        n = len(corpus_tokens)
        sample_size = min(n, 50)
        rng = np.random.default_rng(42)
        sample_indices = rng.choice(n, size=sample_size, replace=False)

        queries = []
        for idx in sample_indices:
            toks = corpus_tokens[idx]
            if toks:
                queries.append(toks[:5])
        if not queries:
            return []

        # Internal (unshifted) scores: alpha/beta must calibrate the
        # quantity the probability kernels transform. Under bm25l/bm25+
        # the public get_scores adds a per-query shift; sampling that
        # here would skew beta by the pseudo-queries' shifts.
        scores = self._scores_internal(queries)
        out = []
        for row in scores:
            nz = row[row > 0]
            if len(nz) > 0:
                out.append(nz.astype(np.float64))
        return out

    def _estimate_parameters(self, per_query_scores) -> tuple[float, float]:
        """beta = median(pooled nonzero scores); alpha = 1 / std
        (scorer.py:313-337). User-supplied values override."""
        if self._user_alpha is not None and self._user_beta is not None:
            return self._user_alpha, self._user_beta
        if not per_query_scores:
            return (self._user_alpha or 1.0, self._user_beta or 0.0)
        pooled = np.concatenate(per_query_scores)
        est_beta = float(np.median(pooled))
        std = float(np.std(pooled))
        est_alpha = 1.0 / std if std > 0 else 1.0
        return (
            self._user_alpha if self._user_alpha is not None else est_alpha,
            self._user_beta if self._user_beta is not None else est_beta,
        )

    # -- base rate estimation (host-side fit-time work) -----------------------

    def _estimate_base_rate(self, per_query_scores, n_docs: int) -> float:
        if not per_query_scores:
            return 1e-6
        method = self._base_rate_method
        if method == "percentile":
            return self._base_rate_percentile(per_query_scores, n_docs)
        if method == "mixture":
            return self._base_rate_mixture(per_query_scores)
        return self._base_rate_elbow(per_query_scores)

    @staticmethod
    def _base_rate_percentile(per_query_scores, n_docs: int) -> float:
        """Mean fraction of docs at/above each query's 95th percentile."""
        ratios = []
        for s in per_query_scores:
            thr = float(np.percentile(s, 95))
            ratios.append(float(np.sum(s >= thr)) / n_docs)
        return float(np.clip(np.mean(ratios), 1e-6, 0.5))

    @staticmethod
    def _base_rate_mixture(per_query_scores) -> float:
        """2-component Gaussian EM on pooled scores; the higher-mean
        component's mixing weight is the base rate (scorer.py:380-433)."""
        x = np.concatenate(per_query_scores)
        if len(x) < 2:
            return 1e-6
        med = float(np.median(x))
        lo = x <= med
        hi = ~lo
        mu0 = float(np.mean(x[lo])) if lo.any() else med - 1.0
        mu1 = float(np.mean(x[hi])) if hi.any() else med + 1.0
        var0 = max(float(np.var(x[lo])) if lo.any() else 1.0, 1e-8)
        var1 = max(float(np.var(x[hi])) if hi.any() else 1.0, 1e-8)
        pi1 = 0.5
        for _ in range(20):
            s0, s1 = np.sqrt(var0), np.sqrt(var1)
            lp0 = -0.5 * ((x - mu0) / s0) ** 2 - np.log(s0)
            lp1 = -0.5 * ((x - mu1) / s1) ** 2 - np.log(s1)
            lw0 = np.log(max(1.0 - pi1, 1e-10)) + lp0
            lw1 = np.log(max(pi1, 1e-10)) + lp1
            gamma = np.exp(lw1 - np.logaddexp(lw0, lw1))
            n1 = float(np.sum(gamma))
            n0 = float(np.sum(1.0 - gamma))
            if n0 < 1e-8 or n1 < 1e-8:
                break
            mu0 = float(np.sum((1 - gamma) * x) / n0)
            mu1 = float(np.sum(gamma * x) / n1)
            var0 = max(float(np.sum((1 - gamma) * (x - mu0) ** 2) / n0), 1e-8)
            var1 = max(float(np.sum(gamma * (x - mu1) ** 2) / n1), 1e-8)
            pi1 = n1 / len(x)
        rate = pi1 if mu1 >= mu0 else 1.0 - pi1
        return float(np.clip(rate, 1e-6, 0.5))

    @staticmethod
    def _base_rate_elbow(per_query_scores) -> float:
        """Max-perpendicular-distance knee of the sorted score curve; the
        fraction of scores above the knee (scorer.py:435-467)."""
        x = np.sort(np.concatenate(per_query_scores))[::-1]
        n = len(x)
        if n < 3:
            return 1e-6
        dx = float(n - 1)
        dy = float(x[-1] - x[0])
        line_len = np.sqrt(dx * dx + dy * dy)
        if line_len < 1e-12:
            return 1e-6
        t = np.arange(n, dtype=np.float64)
        dist = np.abs(dy * t - dx * (x - x[0])) / line_len
        knee = int(np.argmax(dist))
        return float(np.clip(max(1, knee) / n, 1e-6, 0.5))

    # -- querying --------------------------------------------------------------

    def _encode(self, query_tokens_batch):
        return eidx.encode_queries(
            query_tokens_batch, self._index.vocab,
            native_encoder=eidx.get_native_encoder(self._index))

    def get_scores_batch(self, query_tokens_batch: list[list[str]]) -> np.ndarray:
        """Raw BM25 scores for every document, batched: (nq, num_docs).

        For bm25l/bm25+ the per-query nonoccurrence shift is included —
        score-level parity with bm25s.get_scores (rank-neutral; the
        internal calibrated pipeline works on the unshifted score, see
        engine/index.py module docstring)."""
        out = self._scores_internal(query_tokens_batch)
        shift = eidx.query_score_shift(self._index, query_tokens_batch)
        if shift.any():
            out = out + shift[:, None]
            if self._deleted is not None:  # keep tombstones at exactly 0
                out[:, self._deleted] = 0.0
        return out

    def _scores_internal(
            self, query_tokens_batch: list[list[str]]) -> np.ndarray:
        """Engine scores (no bm25l/bm25+ shift): the quantity every
        kernel, fit, and probability path consumes."""
        if self._index is None:
            raise RuntimeError("Call index() before scoring.")
        if self._split is not None:
            from bayesian_bm25_tpu.engine import split_index as sidx

            enc = sidx.encode_queries_split(query_tokens_batch, self._split)
            scores, _ = sidx.score_all_split(
                self._split, *enc, precision=self._matmul_precision)
        else:
            qids, qcnt = self._encode(query_tokens_batch)
            scores, _ = scoring.score_all(
                self._index.term_ids, self._index.weights, qids, qcnt
            )
        out = np.asarray(scores)[:, : self._index.n_docs].astype(np.float64)
        return self._apply_deleted(out)

    def _apply_deleted(self, dense: np.ndarray) -> np.ndarray:
        """Zero tombstoned docs' columns in a dense (nq, num_docs)
        score/probability array."""
        if self._deleted is not None:
            dense[:, self._deleted] = 0.0
        return dense

    def get_scores(self, query_tokens: list[str]) -> np.ndarray:
        """Raw BM25 scores for one query over all docs (bm25s.get_scores
        parity)."""
        return self.get_scores_batch([query_tokens])[0]

    def retrieve(
        self,
        query_tokens: list[list[str]],
        k: int = 10,
        show_progress: bool = False,
        explain: bool = False,
        approx: bool = False,
        doc_mask=None,
        coarse: bool = False,
    ):
        """Top-k by BM25 score with calibrated probabilities.

        Returns (doc_ids, probabilities) arrays of shape (nq, k), or a
        RetrievalResult with per-document traces when ``explain=True``.
        ``approx=True`` (an extension over the reference) selects
        lax.approx_max_k; requires the split index. On the GPU XLA
        lowers it to an exact top-k (recall 1.0) that is slower than
        the default blockwise selection.
        ``coarse=True`` (an extension) is the rank-only fast
        tier on int8 storage: the scoring matmul drops its lo-residual
        pass (half the matmul work) at ~0.8% relative score error —
        rankings approximately preserved, probabilities carry the same
        error class. No-op under exact storage modes; composes with
        ``approx``.
        ``doc_mask`` (an extension): a length-num_docs boolean
        array; False docs are excluded from selection entirely (serving
        tenant/metadata filters). Slots that cannot be filled from the
        unmasked set come back as id -1 / probability 0. The mask is a
        traced device array — varying masks reuse one compiled kernel.
        """
        del show_progress
        if not explain:
            chunk = self._auto_batch_size()
            if len(query_tokens) > chunk:
                # Auto-chunk oversized batches to the HBM sweet spot and
                # pipeline the chunks (launch all, then pull).
                parts = [query_tokens[i:i + chunk]
                         for i in range(0, len(query_tokens), chunk)]
                launched = []
                for part in parts:
                    pn, ids_d, probs_d, _, _ = self._retrieve_launch(
                        part, k, approx, doc_mask, coarse=coarse)
                    launched.append(
                        (pn, scoring.pack_ids_probs(ids_d, probs_d)))
                outs = [scoring.unpack_ids_probs(np.asarray(pk), pn)
                        for pn, pk in launched]
                return (np.concatenate([o[0] for o in outs]),
                        np.concatenate([o[1] for o in outs]))
        nq, top_ids, probs, top_scores, top_tfs = self._retrieve_launch(
            query_tokens, k, approx, doc_mask, coarse=coarse)
        if not explain:
            # One packed device->host pull: ids and probabilities travel
            # together, bitcast into one array.
            packed = np.asarray(scoring.pack_ids_probs(top_ids, probs))
            return scoring.unpack_ids_probs(packed, nq)
        doc_ids = np.asarray(top_ids)[:nq]
        probabilities = np.asarray(probs)[:nq].astype(np.float64)
        return self._explain_from(doc_ids, probabilities,
                                  np.asarray(top_scores)[:nq],
                                  np.asarray(top_tfs)[:nq])

    def retrieve_many(self, query_batches, k: int = 10,
                      approx: bool = False, coarse: bool = False):
        """Steady-state pipelined serving: launch EVERY batch's encode +
        kernel before pulling any result, so host-side encoding and
        transfers overlap device compute (JAX dispatch is asynchronous).
        Returns a list of (doc_ids, probabilities) in batch order —
        identical values to per-batch ``retrieve``, at materially higher
        sustained throughput when calls arrive back-to-back.
        """
        chunk = self._auto_batch_size()
        launched = []  # per batch: list of (chunk_nq, packed_device)
        for qb in query_batches:
            parts = ([qb] if len(qb) <= chunk else
                     [qb[i:i + chunk] for i in range(0, len(qb), chunk)])
            row = []
            for part in parts:
                pn, top_ids, probs, _, _ = self._retrieve_launch(
                    part, k, approx, None, coarse=coarse)
                row.append((pn, scoring.pack_ids_probs(top_ids, probs)))
            launched.append(row)
        # ONE device->host pull for the whole call: device-concatenate
        # the packed (2, nq_pad, k) arrays along the query axis and slice
        # host-side, so the call pays one transfer's fixed latency
        # instead of one per batch.
        flat = [pair for row in launched for pair in row]
        if len(flat) > 1:
            big = np.asarray(
                jnp.concatenate([pk for _, pk in flat], axis=1))
            pieces_flat, off = [], 0
            for pn, pk in flat:
                w = pk.shape[1]
                pieces_flat.append(
                    scoring.unpack_ids_probs(big[:, off:off + w], pn))
                off += w
        else:
            pieces_flat = [scoring.unpack_ids_probs(np.asarray(pk), pn)
                           for pn, pk in flat]
        out, pos = [], 0
        for row in launched:
            pieces = pieces_flat[pos:pos + len(row)]
            pos += len(row)
            if len(pieces) == 1:
                out.append(pieces[0])
            else:
                out.append((np.concatenate([p[0] for p in pieces]),
                            np.concatenate([p[1] for p in pieces])))
        return out

    def retrieve_stream(self, query_batches, k: int = 10,
                        approx: bool = False, lookahead: int = 4,
                        coarse: bool = False):
        """Latency-shaped pipelined serving: a generator yielding each
        batch's (doc_ids, probabilities) as soon as it is pulled, while
        keeping up to ``lookahead`` batches launched ahead on the
        device. First results arrive after ONE batch's latency (vs
        :meth:`retrieve_many`, which pulls everything in one packed
        transfer at the end — higher throughput, all-at-once). Values
        are identical to per-batch ``retrieve``.

        ``query_batches`` may be any iterable (including a live request
        generator); oversized batches auto-chunk like every other entry
        point.
        """
        from collections import deque

        chunk = self._auto_batch_size()
        pending = deque()  # (n_parts_of_batch, [(pn, packed), ...])
        it = iter(query_batches)

        def launch(qb):
            parts = ([qb] if len(qb) <= chunk else
                     [qb[i:i + chunk] for i in range(0, len(qb), chunk)])
            row = []
            for part in parts:
                pn, top_ids, probs, _, _ = self._retrieve_launch(
                    part, k, approx, None, coarse=coarse)
                row.append((pn, scoring.pack_ids_probs(top_ids, probs)))
            return row

        def pull(row):
            pieces = [scoring.unpack_ids_probs(np.asarray(pk), pn)
                      for pn, pk in row]
            if len(pieces) == 1:
                return pieces[0]
            return (np.concatenate([p[0] for p in pieces]),
                    np.concatenate([p[1] for p in pieces]))

        exhausted = False
        while True:
            while not exhausted and len(pending) < max(lookahead, 1):
                try:
                    pending.append(launch(next(it)))
                except StopIteration:
                    exhausted = True
            if not pending:
                return
            yield pull(pending.popleft())

    def _auto_batch_size(self) -> int:
        """Largest power-of-two query-chunk size whose (nq, D_pad) f32
        score matrix fits _SCORES_BUDGET_BYTES (floor 256, cap 8192)."""
        if self._index is None:
            return 8192
        D_pad = self._index.term_ids.shape[0]
        nq = self._SCORES_BUDGET_BYTES // max(D_pad * 4, 1)
        b = 256
        while b * 2 <= nq and b < 8192:
            b *= 2
        return b

    def delete_documents(self, doc_ids) -> None:
        """Tombstone documents: excluded from every query path (retrieve,
        thresholded, scores, probabilities) without rebuilding the index.
        Idempotent; a lifecycle extension (the reference
        supports add_documents only). ``num_docs`` keeps counting
        tombstoned docs — ids are stable."""
        if self._index is None:
            raise RuntimeError("Call index() before delete_documents().")
        ids = np.asarray(list(doc_ids), dtype=np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self._index.n_docs):
            raise ValueError(
                f"doc ids must be in [0, {self._index.n_docs}), got "
                f"range [{ids.min()}, {ids.max()}]")
        if self._deleted is None:
            self._deleted = np.zeros(self._index.n_docs, dtype=bool)
        self._deleted[ids] = True

    def restore_documents(self, doc_ids) -> None:
        """Undo :meth:`delete_documents` for the given ids."""
        if self._deleted is None:
            return
        ids = np.asarray(list(doc_ids), dtype=np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self._index.n_docs):
            raise ValueError(
                f"doc ids must be in [0, {self._index.n_docs}), got "
                f"range [{ids.min()}, {ids.max()}]")
        self._deleted[ids] = False
        if not self._deleted.any():
            self._deleted = None

    @property
    def deleted_mask(self) -> np.ndarray | None:
        """Host bool mask of tombstoned docs (None when nothing is
        deleted)."""
        return None if self._deleted is None else self._deleted.copy()

    def _combine_deleted(self, doc_mask):
        """Merge the tombstone mask into a (validated numpy) caller
        mask; returns numpy bool or None."""
        if self._deleted is None:
            return doc_mask
        alive = ~self._deleted
        return alive if doc_mask is None else (doc_mask & alive)

    def _retrieve_launch(self, query_tokens, k, approx, doc_mask,
                         coarse: bool = False):
        """Encode + dispatch the retrieval kernel; returns device arrays
        (no host sync): (nq, top_ids, probs, top_scores, top_tfs)."""
        if self._transform is None:
            raise RuntimeError("Call index() before retrieve().")
        idx = self._index
        k_eff = min(k, idx.n_docs)
        nq = len(query_tokens)
        t = self._transform
        if doc_mask is not None:
            doc_mask = np.asarray(doc_mask, dtype=bool)
            if doc_mask.shape != (idx.n_docs,):
                raise ValueError(
                    f"doc_mask must have shape ({idx.n_docs},), got "
                    f"{doc_mask.shape}")
        doc_mask = self._combine_deleted(doc_mask)
        if doc_mask is not None:
            doc_mask = jnp.asarray(doc_mask)
        if self._split is not None:
            from bayesian_bm25_tpu.engine import split_index as sidx

            s = self._split
            # Bucket the batch size (1, 2, 4, ...) with empty pad queries:
            # serving-latency calls with varying nq otherwise trigger a
            # fresh compilation per batch size.
            nq = len(query_tokens)
            nq_pad = sidx._pow2_bucket(max(nq, 1), 1)
            padded = list(query_tokens) + [[]] * (nq_pad - nq)
            enc = sidx.encode_queries_split(padded, s)
            if s.post_doc_ids is not None:
                # Sparse-candidate exact path: matmul + rare-postings
                # merge (no dense tail compare, no presence matmul).
                fslots, fcnt, trows, tqids, tqcnt = enc
                # Width-capped indexes (huge corpora) split the tail
                # group by tier: group B rows carry >=1 tier-2 term and
                # get a second merge pass; group A is the common case.
                (trows, tslots, tqcnt), grpB = sidx.split_tail_groups(
                    trows, tqids, tqcnt, s)
                # Light/heavy cap split: one heavy row otherwise forces
                # the whole batch through a wide merge (engages only
                # when the element savings clear the extra dispatch).
                lh = (sidx.split_light_heavy(trows, tslots, tqcnt,
                                             s, k_eff)
                      if sidx.LIGHT_HEAVY else None)
                # Every small host operand ships as ONE packed buffer
                # (sidx.ship_arrays), so the encode grids, group splits
                # and compact arrays cost one transfer's fixed latency
                # and split back apart on device. Whether this pays on
                # the H100's local link is not yet measured.
                ship_np, ship_slot = [], {}

                def _ship(name, arr):
                    ship_slot[name] = len(ship_np)
                    ship_np.append(arr)

                h_kw = {}
                h_static = {}
                if lh is not None:
                    (trows, tslots, tqcnt), (hrows, hslots, hqcnt) = lh
                    _ship("tailH_rows", hrows)
                    _ship("tailH_slots", hslots)
                    _ship("tailH_qcnt", hqcnt)
                    h_static = dict(
                        cand_capH=sidx.candidate_cap(s, hslots, k_eff))
                    if sidx.PACKED_BUILD:
                        R = s.post_doc_ids.shape[0] - 1
                        packedH, r_maxH = sidx.compact_tail_postings(
                            hslots, hqcnt, R)
                        if r_maxH < hslots.shape[1]:
                            _ship("compactH", packedH)
                            h_static["compactH_rmax"] = r_maxH
                cap = sidx.candidate_cap(s, tslots, k_eff)
                b_kw = {}
                b_static = {}
                if grpB is not None:
                    trB, s1B, qcB, s2B, qc2B = grpB
                    # Group-B cap split: splitting B by combined df
                    # totals runs the common rows of the tier-2 merge
                    # (its sbase gather is the widest of the kernel) at
                    # a narrow cap.
                    lhb = (sidx.split_light_heavy_b(
                        trB, s1B, qcB, s2B, qc2B, s, k_eff)
                        if sidx.LIGHT_HEAVY else None)
                    b_kw = dict(
                        post2_ids=s.post2_doc_ids,
                        post2_w=s.post2_weights,
                    )
                    if lhb is not None:
                        (trB, s1B, qcB, s2B, qc2B), \
                            (trB2, s1B2, qcB2, s2B2, qc2B2) = lhb
                        _ship("tailB2_rows", trB2)
                        _ship("tailB2_slots", s1B2)
                        _ship("tailB2_qcnt", qcB2)
                        _ship("tailB2_slots2", s2B2)
                        _ship("tailB2_qcnt2", qc2B2)
                        b_static["cand_cap2H"] = sidx.candidate_cap2(
                            s, s1B2, s2B2, k_eff)
                    _ship("tailB_rows", trB)
                    _ship("tailB_slots", s1B)
                    _ship("tailB_qcnt", qcB)
                    _ship("tailB_slots2", s2B)
                    _ship("tailB_qcnt2", qc2B)
                    b_static["cand_cap2"] = sidx.candidate_cap2(
                        s, s1B, s2B, k_eff)
                # Rank-packed candidate build: gathers only real
                # postings rows and runs the whole merge at the packed
                # width; engages when it actually narrows the layout.
                r_max = 0
                if sidx.PACKED_BUILD:
                    R = s.post_doc_ids.shape[0] - 1
                    packed, r_max = sidx.compact_tail_postings(
                        tslots, tqcnt, R)
                    if r_max < tslots.shape[1]:
                        _ship("compact", packed)
                    else:
                        r_max = 0
                for name, arr in (("fslots", fslots), ("fcnt", fcnt),
                                  ("trows", trows), ("tslots", tslots),
                                  ("tqcnt", tqcnt)):
                    _ship(name, arr)
                shipped = sidx.ship_arrays(ship_np)
                dev = {name: shipped[i] for name, i in ship_slot.items()}
                h_kw.update({k: dev[k] for k in
                             ("tailH_rows", "tailH_slots", "tailH_qcnt")
                             if k in dev})
                if "compactH" in dev:
                    h_kw["compactH"] = dev["compactH"]
                h_kw.update(h_static)
                b_kw.update({k: dev[k] for k in
                             ("tailB_rows", "tailB_slots", "tailB_qcnt",
                              "tailB_slots2", "tailB_qcnt2",
                              "tailB2_rows", "tailB2_slots",
                              "tailB2_qcnt", "tailB2_slots2",
                              "tailB2_qcnt2")
                             if k in dev})
                b_kw.update(b_static)
                top_ids, probs, top_scores, top_tfs = (
                    sidx.retrieve_topk_split_sparse(
                        s.dense_impact, s.dense_presence, s.post_doc_ids,
                        s.post_weights, idx.doc_lengths, idx.avgdl,
                        dev["fslots"], dev["fcnt"],
                        dev["trows"], dev["tslots"],
                        dev["tqcnt"], k_eff, cap,
                        t.alpha, t.beta, t.base_rate, n_docs=idx.n_docs,
                        prior_free=t._training_mode == "prior_free",
                        approx=approx, precision=self._matmul_precision,
                        doc_mask=doc_mask, impact_lo=s.dense_impact_lo,
                        tf_from_sign=s.post_w_positive,
                        compact=dev.get("compact"), compact_rmax=r_max,
                        impact_scale=s.impact_scale,
                        q_int8_ok=sidx._q_int8_ok(s, fcnt),
                        coarse=coarse,
                        **b_kw, **h_kw,
                    )
                )
            else:
                top_ids, probs, top_scores, top_tfs = sidx.retrieve_topk_split(
                    s.dense_impact, s.dense_presence, s.tail_term_ids,
                    s.tail_weights, idx.doc_lengths, idx.avgdl,
                    *enc, k_eff,
                    t.alpha, t.beta, t.base_rate, n_docs=idx.n_docs,
                    prior_free=t._training_mode == "prior_free",
                    approx=approx, overflow=sidx._overflow_of(s),
                    precision=self._matmul_precision, doc_mask=doc_mask,
                    impact_lo=s.dense_impact_lo,
                    impact_scale=s.impact_scale,
                    q_int8_ok=sidx._q_int8_ok(s, enc[1]),
                )
            top_ids = top_ids[:nq]
            probs = probs[:nq]
            top_scores = top_scores[:nq]
            top_tfs = top_tfs[:nq]
        else:
            qids, qcnt = self._encode(query_tokens)
            top_ids, probs, top_scores, top_tfs = scoring.retrieve_topk(
                idx.term_ids, idx.weights, idx.doc_lengths, idx.avgdl,
                qids, qcnt, k_eff, t.alpha, t.beta, t.base_rate,
                n_docs=idx.n_docs,
                prior_free=t._training_mode == "prior_free",
                doc_mask=doc_mask,
            )
        return nq, top_ids, probs, top_scores, top_tfs

    def _explain_from(self, doc_ids, probabilities, scores_np, tfs_np):
        from bayesian_bm25_tpu.utils.debug import FusionDebugger

        idx = self._index
        debugger = FusionDebugger(self._transform)
        dl = np.asarray(idx.doc_lengths)
        explanations = []
        for qi in range(doc_ids.shape[0]):
            row = []
            for r in range(doc_ids.shape[1]):
                s = float(scores_np[qi, r])
                if s > 0:
                    did = int(doc_ids[qi, r])
                    row.append(
                        debugger.trace_bm25(
                            s, float(tfs_np[qi, r]), float(dl[did] / idx.avgdl)
                        )
                    )
                else:
                    row.append(None)
            explanations.append(row)
        return RetrievalResult(doc_ids, probabilities, explanations)

    def retrieve_thresholded(self, query_tokens: list[list[str]],
                             threshold: float, k: int = 10, doc_mask=None):
        """The k most probable documents with P >= threshold, per query.

        Calibrated probabilities make a fixed threshold meaningful across
        queries (the reference's threshold_filtering scenario). One dense
        probability pass scans every document, so the returned set is
        complete by construction — a top-k-by-*score* filter could miss
        passing docs because probability is not monotone in score (the
        prior depends on tf and doc length). ``doc_mask`` (as in
        ``retrieve``) zeroes masked docs' probabilities, excluding them
        from both the passing count and the returned set.

        Returns (doc_ids, probabilities, n_passing): ids/probabilities are
        (nq, k) ordered by descending probability, with -1 / 0.0 beyond
        each query's passing set; n_passing counts all docs at/above the
        threshold per query (possibly > k).
        """
        if self._transform is None:
            raise RuntimeError("Call index() before retrieve_thresholded().")
        from bayesian_bm25_tpu.ops import transform as T

        # The dense pass holds TWO (nq, D) f32 matrices (scores + tf)
        # alongside the resident index; chunk oversized batches at a
        # quarter of the retrieve budget so huge corpora can't OOM
        # (results concatenate exactly per query).
        chunk = max(self._auto_batch_size() // 4, 128)
        if len(query_tokens) > chunk:
            parts = [query_tokens[i:i + chunk]
                     for i in range(0, len(query_tokens), chunk)]
            outs = [self.retrieve_thresholded(p, threshold, k=k,
                                              doc_mask=doc_mask)
                    for p in parts]
            return (np.concatenate([o[0] for o in outs]),
                    np.concatenate([o[1] for o in outs]),
                    np.concatenate([o[2] for o in outs]))

        nq = len(query_tokens)
        idx = self._index
        t = self._transform
        k_eff = min(k, idx.n_docs)
        prior_free = t._training_mode == "prior_free"
        if doc_mask is not None:
            doc_mask = np.asarray(doc_mask, dtype=bool)
            if doc_mask.shape != (idx.n_docs,):
                raise ValueError(
                    f"doc_mask must have shape ({idx.n_docs},), "
                    f"got {doc_mask.shape}")
        doc_mask = self._combine_deleted(doc_mask)

        # WAND-pruned path: invert the certified probability bound to a
        # score prefilter (prior <= 0.9 by composite_prior's clip; 0.5
        # exactly in prior_free mode), transform only the survivors. The
        # passing set, counts, ids, and probabilities are identical to
        # the dense scan — pruning is output-invariant by the bound.
        s_min = T.wand_score_threshold(
            float(threshold), t.alpha, t.beta, t.base_rate,
            p_max=0.5 if prior_free else 0.9)
        if np.isfinite(s_min) or s_min > 0:
            scores_d, tfs_d = self._dense_scores_tfs_device(query_tokens)
            if doc_mask is not None:
                scores_d = jnp.where(jnp.asarray(doc_mask)[None, :],
                                     scores_d, -jnp.inf)
            counts = np.asarray(scoring.count_above(scores_d, s_min))
            c_max = int(counts.max()) if counts.size else 0
            C = _pow2_bucket_int(max(c_max, k_eff), 16)
            # lax.top_k cost grows with k, so candidate selection only
            # beats finishing densely while C stays TINY (the dense
            # finish shares the score pass and is one fused transform +
            # top-k(10)); the crossover on the H100 is not yet measured.
            # The certified bound's
            # durable value is the exact candidate-set semantics; the
            # fast path for everything else is the shared-scores dense
            # finish below.
            if C <= max(32, 2 * k_eff) and C <= idx.n_docs // 2:
                ids, probs, n_passing = scoring.thresholded_topk_pruned(
                    scores_d, tfs_d, idx.doc_lengths[: idx.n_docs],
                    idx.avgdl, float(threshold), s_min, k_eff,
                    min(C, idx.n_docs), t.alpha, t.beta, t.base_rate,
                    prior_free=prior_free,
                )
            else:
                # Too many survivors for candidate selection to win:
                # finish densely — but REUSE the score/tf pass already
                # computed rather than recomputing it.
                ids, probs, n_passing = scoring.thresholded_topk_from_scores(
                    scores_d, tfs_d, idx.doc_lengths[: idx.n_docs],
                    idx.avgdl, float(threshold), k_eff,
                    t.alpha, t.beta, t.base_rate, prior_free=prior_free,
                )
            return (np.asarray(ids)[:nq],
                    np.asarray(probs)[:nq].astype(np.float64),
                    np.asarray(n_passing)[:nq].astype(int))

        # Dense fallback: thresholds so low the prefilter keeps most of
        # the corpus (or prunes nothing) — one full probability scan.
        dense = self._dense_probs_device(query_tokens)
        if doc_mask is not None:
            dense = dense * jnp.asarray(doc_mask)[None, :]
        ids, probs, n_passing = scoring.thresholded_topk(
            dense, float(threshold), k_eff)
        return (np.asarray(ids)[:nq], np.asarray(probs)[:nq].astype(np.float64),
                np.asarray(n_passing)[:nq].astype(int))

    def retrieve_texts(self, query_texts: list[str], k: int = 10,
                       explain: bool = False, approx: bool = False):
        """Text-in serving API: tokenize (C++ pipeline when built) then
        retrieve. Pair with ``index_texts`` for an end-to-end raw-text path.
        Queries are tokenized with the options given to ``index_texts``.
        """
        from bayesian_bm25_tpu.engine.tokenize import tokenize_texts

        return self.retrieve(
            tokenize_texts(query_texts, **self._tok_opts), k=k,
            explain=explain, approx=approx)

    def get_probabilities(self, query_tokens: list[str]) -> np.ndarray:
        """Calibrated probability for every document (dense, one query)."""
        return self.get_probabilities_batch([query_tokens])[0]

    def get_probabilities_batch(
        self, query_tokens_batch: list[list[str]]
    ) -> np.ndarray:
        """Dense calibrated probabilities, batched: (nq, num_docs).

        Extension: the reference only offers the single-query form
        (scorer.py:564-590); batching keeps the device busy.
        """
        nq = len(query_tokens_batch)
        probs = self._dense_probs_device(query_tokens_batch)
        return self._apply_deleted(
            np.asarray(probs[:nq]).astype(np.float64))

    def _dense_scores_tfs_device(self, query_tokens_batch):
        """Dense (scores, tfs) device arrays sliced to n_docs (the
        score/tf halves of the probability pipeline, without the
        transform — the pruned thresholded path applies the transform to
        candidates only)."""
        idx = self._index
        if self._split is not None:
            from bayesian_bm25_tpu.engine import split_index as sidx

            s = self._split
            nq = len(query_tokens_batch)
            nq_pad = sidx._pow2_bucket(max(nq, 1), 1)
            padded = list(query_tokens_batch) + [[]] * (nq_pad - nq)
            enc = sidx.encode_queries_split(padded, s)
            scores, tfs = sidx.score_all_split(
                s, *enc, precision=self._matmul_precision)
        else:
            qids, qcnt = self._encode(query_tokens_batch)
            scores, tfs = scoring.score_all(
                idx.term_ids, idx.weights, qids, qcnt)
        return scores[:, : idx.n_docs], tfs[:, : idx.n_docs]

    def _dense_probs_device(self, query_tokens_batch) -> "jnp.ndarray":
        """Dense probabilities as a device array (rows beyond nq are
        batch-bucketing pads on the split path)."""
        if self._transform is None:
            raise RuntimeError("Call index() before get_probabilities().")
        idx = self._index
        t = self._transform
        if self._split is not None:
            from bayesian_bm25_tpu.engine import split_index as sidx

            s = self._split
            nq = len(query_tokens_batch)
            nq_pad = sidx._pow2_bucket(max(nq, 1), 1)
            padded = list(query_tokens_batch) + [[]] * (nq_pad - nq)
            enc = sidx.encode_queries_split(padded, s)
            return sidx.probabilities_all_split(
                s.dense_impact, s.dense_presence, s.tail_term_ids,
                s.tail_weights, idx.doc_lengths, idx.avgdl, *enc,
                t.alpha, t.beta, t.base_rate, n_docs=idx.n_docs,
                prior_free=t._training_mode == "prior_free",
                overflow=sidx._overflow_of(s),
                precision=self._matmul_precision,
                impact_lo=s.dense_impact_lo,
                impact_scale=s.impact_scale,
                q_int8_ok=sidx._q_int8_ok(s, enc[1]),
            )
        qids, qcnt = self._encode(query_tokens_batch)
        probs, _, _ = scoring.probabilities_all(
            idx.term_ids, idx.weights, idx.doc_lengths, idx.avgdl,
            qids, qcnt, t.alpha, t.beta, t.base_rate,
            n_docs=idx.n_docs,
            prior_free=t._training_mode == "prior_free",
        )
        return probs

    def add_documents(self, new_corpus_tokens, show_progress: bool = True) -> None:
        """Append documents incrementally.

        The reference re-indexes the whole corpus on every add
        (scorer.py:469-492) because IDF/avgdl are global. Here only the
        NEW docs are tokenized and counted; the engine recomputes weights
        vectorized from its count table (bit-identical to a full rebuild,
        see engine.index.append_to_index), then alpha/beta/base_rate are
        re-estimated on the grown corpus with the same seed-42 protocol —
        so the result is indistinguishable from index(old + new).
        """
        del show_progress
        if self._corpus_tokens is None:
            raise RuntimeError("Call index() before add_documents().")
        new_list = list(new_corpus_tokens)
        if self._index is None or self._index.term_counts_host is None:
            deleted = self._deleted
            self.index(list(self._corpus_tokens) + new_list)
            if deleted is not None:
                # full-rebuild fallback keeps ids stable: restore the
                # tombstones and mark the appended docs alive
                self._deleted = np.concatenate(
                    [deleted, np.zeros(len(new_list), dtype=bool)])
            return
        self._index = eidx.append_to_index(
            self._index, new_list,
            doc_pad_multiple=self._doc_pad_multiple())
        self._corpus_tokens = self._corpus_tokens + new_list
        if self._deleted is not None:
            # appended docs are alive; ids of existing docs are stable
            self._deleted = np.concatenate(
                [self._deleted, np.zeros(len(new_list), dtype=bool)])
        self._maybe_build_split()
        self._finalize_index()
        per_query_scores = self._sample_pseudo_query_scores(self._corpus_tokens)
        alpha, beta = self._estimate_parameters(per_query_scores)
        base_rate: float | None = None
        if self._user_base_rate == "auto":
            base_rate = self._estimate_base_rate(
                per_query_scores, len(self._corpus_tokens))
        elif isinstance(self._user_base_rate, (int, float)):
            base_rate = float(self._user_base_rate)
        self._transform = BayesianProbabilityTransform(
            alpha=alpha, beta=beta, base_rate=base_rate
        )

    def _compute_tf_batch(self, doc_ids, query_tokens: list[str]) -> np.ndarray:
        """Unique-overlap counts |query_set ∩ doc_set| for given docs
        (host-side parity helper; the device path computes this in-kernel)."""
        qset = set(query_tokens)
        return np.array(
            [len(qset & set(self._corpus_tokens[int(d)])) for d in doc_ids],
            dtype=np.float64,
        )
