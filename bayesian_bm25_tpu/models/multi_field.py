"""Multi-field BM25 search with weighted log-odds fusion of field signals.

API parity with the reference (bayesian_bm25/multi_field.py): one
BayesianBM25Scorer per field, field weights summing to 1, fused dense
probabilities via the weighted log-odds conjunction. The per-field dense
probability passes are batched device calls; fusion is one jnp op.
"""

from __future__ import annotations

import numpy as np

from bayesian_bm25_tpu.api_fusion import log_odds_conjunction
from bayesian_bm25_tpu.models.scorer import BayesianBM25Scorer
from bayesian_bm25_tpu.ops.fusion import resolve_alpha


class MultiFieldScorer:
    """Fuses per-field Bayesian probabilities via log-odds conjunction."""

    def __init__(self, fields: list[str], field_weights: dict | None = None,
                 alpha="auto", base_rate=None, k1: float = 1.2,
                 b: float = 0.75, method: str = "robertson",
                 score_scale: str = "classic", delta: float = 0.5) -> None:
        if not fields:
            raise ValueError("fields must be a non-empty list")
        if len(fields) != len(set(fields)):
            raise ValueError("fields must not contain duplicates")

        self._fields = list(fields)
        self._alpha = alpha
        self._base_rate = base_rate
        self._k1 = k1
        self._b = b
        self._method = method
        self._score_scale = score_scale
        self._delta = delta

        if field_weights is None:
            n = len(fields)
            self._field_weights = {f: 1.0 / n for f in fields}
        else:
            for f in fields:
                if f not in field_weights:
                    raise ValueError(f"field_weights missing key {f!r}")
            total = sum(field_weights[f] for f in fields)
            if abs(total - 1.0) > 1e-6:
                raise ValueError(f"field_weights must sum to 1, got {total}")
            self._field_weights = {f: field_weights[f] for f in fields}

        self._scorers: dict[str, BayesianBM25Scorer] = {}
        self._num_docs = 0

    @property
    def num_docs(self) -> int:
        return self._num_docs

    @property
    def fields(self) -> list[str]:
        return list(self._fields)

    @property
    def field_weights(self) -> dict:
        return dict(self._field_weights)

    @property
    def scorers(self) -> dict:
        """Per-field scorer instances (populated by index())."""
        return dict(self._scorers)

    def index(self, documents: list[dict], show_progress: bool = True) -> None:
        """Build one index per field; every document must have all fields."""
        for i, doc in enumerate(documents):
            for field in self._fields:
                if field not in doc:
                    raise ValueError(f"Document {i} missing field {field!r}")
        self._scorers = {}
        for field in self._fields:
            scorer = BayesianBM25Scorer(
                k1=self._k1, b=self._b, method=self._method,
                base_rate=self._base_rate, score_scale=self._score_scale,
                delta=self._delta,
            )
            scorer.index([doc[field] for doc in documents],
                         show_progress=show_progress)
            self._scorers[field] = scorer
        self._num_docs = len(documents)

    def index_jsonl(self, path: str, *, lowercase: bool = True,
                    remove_stopwords: bool = True,
                    stem: bool | str = True) -> list[str]:
        """Index a BEIR corpus.jsonl as title/body fields natively.

        Requires ``fields == ["title", "body"]`` (the BEIR convention the
        reference's harness uses, hybrid_beir.py:194-264). The C++ data
        loader supplies both fields as lazy blobs; each field scorer
        indexes through the native text pipeline. Returns the corpus doc
        ids in index order.
        """
        if self._fields != ["title", "body"]:
            raise ValueError(
                "index_jsonl requires fields=['title', 'body'], got "
                f"{self._fields}")
        try:
            from bayesian_bm25_tpu.engine.native import load_jsonl_native

            loaded = load_jsonl_native(path)
        except (ImportError, OSError):
            loaded = None
        if loaded is None:
            import json

            ids, titles, texts = [], [], []
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    row = json.loads(line)
                    did = str(row.get("_id", ""))
                    if not did:
                        continue
                    ids.append(did)
                    titles.append(row.get("title", "") or "")
                    texts.append(row.get("text", ""))
        else:
            ids, titles, texts = loaded
        self._scorers = {}
        for field, field_texts in (("title", titles), ("body", texts)):
            scorer = BayesianBM25Scorer(
                k1=self._k1, b=self._b, method=self._method,
                base_rate=self._base_rate, score_scale=self._score_scale,
                delta=self._delta,
            )
            scorer.index_texts(field_texts, lowercase=lowercase,
                               remove_stopwords=remove_stopwords, stem=stem)
            self._scorers[field] = scorer
        self._num_docs = len(ids)
        return list(ids)

    def delete_documents(self, doc_ids) -> None:
        """Tombstone documents across every field scorer: fused
        probabilities become exactly 0 and the docs sort behind every
        live candidate (ids stay stable; ``restore_documents`` undoes).
        """
        if not self._scorers:
            raise RuntimeError("Call index() before delete_documents().")
        for f in self._fields:
            self._scorers[f].delete_documents(doc_ids)

    def restore_documents(self, doc_ids) -> None:
        """Undo :meth:`delete_documents` across every field scorer."""
        if not self._scorers:
            raise RuntimeError("Call index() before restore_documents().")
        for f in self._fields:
            self._scorers[f].restore_documents(doc_ids)

    @property
    def deleted_mask(self):
        """Tombstone mask (None when nothing is deleted)."""
        if not self._scorers:
            return None
        return self._scorers[self._fields[0]].deleted_mask

    def _zero_deleted(self, fused: np.ndarray) -> np.ndarray:
        mask = self.deleted_mask
        if mask is not None:
            fused = np.array(fused)  # jnp->np views arrive read-only
            fused[..., mask] = 0.0
        return fused

    def get_probabilities(self, query_tokens: list[str]) -> np.ndarray:
        """Fused probabilities for all documents (weighted Log-OP)."""
        if not self._scorers:
            raise RuntimeError("Call index() before get_probabilities().")
        field_probs = np.column_stack([
            self._scorers[f].get_probabilities(query_tokens)
            for f in self._fields
        ])
        weights = np.array(
            [self._field_weights[f] for f in self._fields], dtype=np.float64
        )
        return self._zero_deleted(np.asarray(log_odds_conjunction(
            field_probs, alpha=resolve_alpha(self._alpha, default=0.5),
            weights=weights,
        )))

    def get_probabilities_batch(self, query_tokens_batch: list) -> np.ndarray:
        """Fused probabilities for a query batch: (nq, num_docs).

        Extension: one batched device pass per field, one fusion
        op — keeps the chip busy instead of a per-query loop.
        """
        if not self._scorers:
            raise RuntimeError("Call index() before get_probabilities_batch().")
        field_probs = np.stack([
            self._scorers[f].get_probabilities_batch(query_tokens_batch)
            for f in self._fields
        ], axis=-1)  # (nq, n_docs, n_fields)
        weights = np.array(
            [self._field_weights[f] for f in self._fields], dtype=np.float64
        )
        return self._zero_deleted(np.asarray(log_odds_conjunction(
            field_probs, alpha=resolve_alpha(self._alpha, default=0.5),
            weights=weights,
        )))

    def retrieve(self, query_tokens: list[str], k: int = 10):
        """Top-k by fused probability (descending); tombstoned docs
        carry probability 0 and rank behind every live candidate."""
        probs = self.get_probabilities(query_tokens)
        k = min(k, len(probs))
        top = np.argsort(probs)[::-1][:k]
        return top, probs[top]

    def retrieve_texts(self, query_text: str, k: int = 10):
        """Text-in retrieve: tokenize with the field scorers' options
        (set by ``index_jsonl``/``index_texts``) then fuse-and-rank."""
        if not self._scorers:
            raise RuntimeError("Call index() before retrieve_texts().")
        from bayesian_bm25_tpu.engine.tokenize import tokenize_texts

        opts = self._scorers[self._fields[0]]._tok_opts
        return self.retrieve(tokenize_texts([query_text], **opts)[0], k=k)

    def add_documents(self, new_documents: list[dict],
                      show_progress: bool = True) -> None:
        """Append documents (full per-field re-index, IDF changes)."""
        if not self._scorers:
            raise RuntimeError("Call index() before add_documents().")
        for i, doc in enumerate(new_documents):
            for field in self._fields:
                if field not in doc:
                    raise ValueError(f"New document {i} missing field {field!r}")
        for field in self._fields:
            self._scorers[field].add_documents(
                [doc[field] for doc in new_documents],
                show_progress=show_progress,
            )
        self._num_docs += len(new_documents)
