"""ctypes bindings for the C++ host-side hot loops (native/bb25_native.cpp).

Builds the shared library on first use with g++ into ``<checkout>/build/``
(gitignored), under a file name keyed by a hash of the source text and the
compiler command, and exposes:

  * ``tokenize_texts_native`` — batch tokenization (strings out)
  * ``build_corpus_native``   — tokenize + vocab + per-doc term counts in
    one pass, returning numpy CSR arrays ready for the device index builder

Falls back are handled by callers (engine/tokenize.py, engine/index.py):
everything here raises ImportError/OSError when the toolchain or source is
unavailable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from bayesian_bm25_tpu.engine.tokenize import stem_mode as _stem_mode
from itertools import chain as _chain

import numpy as np


def _encode_threads() -> int:
    """Lookup threads for batch encoding, respecting cgroup CPU limits."""
    try:
        n = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        n = os.cpu_count() or 1
    return max(1, min(8, n))

_LIB = None
_LOCK = threading.Lock()

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC = os.path.join(_ROOT, "native", "bb25_native.cpp")
_BUILD_DIR = os.path.join(_ROOT, "build")
_CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


class _TokenizeResult(ctypes.Structure):
    _fields_ = [
        ("token_blob", ctypes.c_char_p),
        ("token_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("doc_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("n_tokens", ctypes.c_int64),
        ("blob_size", ctypes.c_int64),
    ]


class _CorpusResult(ctypes.Structure):
    _fields_ = [
        ("doc_indptr", ctypes.POINTER(ctypes.c_int64)),
        ("term_ids", ctypes.POINTER(ctypes.c_int32)),
        ("term_counts", ctypes.POINTER(ctypes.c_int32)),
        ("doc_lengths", ctypes.POINTER(ctypes.c_int32)),
        ("vocab_blob", ctypes.c_char_p),
        ("vocab_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("n_vocab", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("vocab_blob_size", ctypes.c_int64),
    ]


def library_path(src: str = _SRC, build_dir: str = _BUILD_DIR,
                 flags: tuple = _CXX_FLAGS) -> str:
    """Where the library built from ``src`` with ``flags`` lives: the
    name carries a hash of both, so a library built from another source
    or with other flags (or copied from another machine under the old
    name) is never loaded."""
    with open(src, "rb") as f:
        text = f.read()
    h = hashlib.sha256(text + b"\0" + " ".join(flags).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(build_dir, f"{stem}-{h.hexdigest()[:16]}.so")


def _build_library(src: str = _SRC, build_dir: str = _BUILD_DIR,
                   flags: tuple = _CXX_FLAGS) -> str:
    if not os.path.exists(src):
        raise ImportError(f"native source not found: {src}")
    so = library_path(src, build_dir, flags)
    if os.path.exists(so):
        return so
    os.makedirs(build_dir, exist_ok=True)
    # Build beside the target, then rename: concurrent builders (test
    # workers) never see a half-written library.
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *flags, src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, so)
    except (subprocess.CalledProcessError, FileNotFoundError) as exc:
        detail = getattr(exc, "stderr", str(exc))
        raise ImportError(f"failed to build native library: {detail}") from exc
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


class _EncodeResult(ctypes.Structure):
    _fields_ = [
        ("pair_q", ctypes.POINTER(ctypes.c_int32)),
        ("pair_t", ctypes.POINTER(ctypes.c_int32)),
        ("pair_c", ctypes.POINTER(ctypes.c_int32)),
        ("n_pairs", ctypes.c_int64),
    ]


class _SplitEncodeResult(ctypes.Structure):
    _fields_ = [
        ("fslots", ctypes.POINTER(ctypes.c_int32)),
        ("fcnt", ctypes.POINTER(ctypes.c_float)),
        ("trows", ctypes.POINTER(ctypes.c_int32)),
        ("qids", ctypes.POINTER(ctypes.c_int32)),
        ("qcnt", ctypes.POINTER(ctypes.c_float)),
        ("nq", ctypes.c_int64),
        ("Qf", ctypes.c_int64),
        ("nt", ctypes.c_int64),
        ("Qt", ctypes.c_int64),
        ("has_pairs", ctypes.c_int32),
    ]


class _JsonlResult(ctypes.Structure):
    _fields_ = [
        ("id_blob", ctypes.POINTER(ctypes.c_char)),
        ("id_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("title_blob", ctypes.POINTER(ctypes.c_char)),
        ("title_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("text_blob", ctypes.POINTER(ctypes.c_char)),
        ("text_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("n_docs", ctypes.c_int64),
        ("id_blob_size", ctypes.c_int64),
        ("title_blob_size", ctypes.c_int64),
        ("text_blob_size", ctypes.c_int64),
    ]


def _load():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build_library())
            lib.bb25_tokenize.restype = ctypes.POINTER(_TokenizeResult)
            lib.bb25_tokenize.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.bb25_free_tokenize.argtypes = [ctypes.POINTER(_TokenizeResult)]
            lib.bb25_build_corpus.restype = ctypes.POINTER(_CorpusResult)
            lib.bb25_build_corpus.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.bb25_free_corpus.argtypes = [ctypes.POINTER(_CorpusResult)]
            lib.bb25_build_corpus_tokens.restype = ctypes.POINTER(
                _CorpusResult)
            lib.bb25_build_corpus_tokens.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ]
            lib.bb25_vocab_create.restype = ctypes.c_void_p
            lib.bb25_vocab_create.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ]
            lib.bb25_vocab_free.argtypes = [ctypes.c_void_p]
            lib.bb25_encode_tokens.restype = ctypes.POINTER(_EncodeResult)
            lib.bb25_encode_tokens.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
            ]
            lib.bb25_encode_tokens_sep.restype = ctypes.POINTER(_EncodeResult)
            lib.bb25_encode_tokens_sep.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int,
            ]
            lib.bb25_encode_texts.restype = ctypes.POINTER(_EncodeResult)
            lib.bb25_encode_texts.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.bb25_free_encode.argtypes = [ctypes.POINTER(_EncodeResult)]
            lib.bb25_encode_tokens_split.restype = ctypes.POINTER(
                _SplitEncodeResult)
            lib.bb25_encode_tokens_split.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32,
            ]
            lib.bb25_free_encode_split.argtypes = [
                ctypes.POINTER(_SplitEncodeResult)]
            lib.bb25_load_jsonl.restype = ctypes.POINTER(_JsonlResult)
            lib.bb25_load_jsonl.argtypes = [ctypes.c_char_p]
            lib.bb25_free_jsonl.argtypes = [ctypes.POINTER(_JsonlResult)]
            _LIB = lib
    return _LIB


class BlobTexts:
    """Texts held as one bytes blob + int64 offsets; items decode lazily.

    Sequence-compatible (len / index / slice-free iteration) so it drops
    into any ``texts: list[str]`` parameter, while bulk consumers
    (`_pack_texts`) ship the blob without ever materializing per-document
    Python strings.
    """

    def __init__(self, blob: bytes, offsets: np.ndarray):
        self._blob = blob
        self._offsets = np.asarray(offsets, dtype=np.int64)

    def __len__(self) -> int:
        return len(self._offsets) - 1

    def __getitem__(self, i: int) -> str:
        i = int(i)
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        o = self._offsets
        return self._blob[o[i]:o[i + 1]].decode("utf-8", errors="replace")

    def __iter__(self):
        o = self._offsets
        for i in range(len(self)):
            yield self._blob[o[i]:o[i + 1]].decode("utf-8",
                                                   errors="replace")


def _pack_texts(texts):
    if isinstance(texts, BlobTexts):
        return texts._blob, texts._offsets
    encoded = [t.encode("utf-8", errors="ignore") for t in texts]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    blob = b"".join(encoded)
    return blob, offsets


def tokenize_texts_native(texts: list[str], *, lowercase=True,
                          remove_stopwords=True, stem=True) -> list[list[str]]:
    """Batch tokenize via the C++ pipeline; returns per-doc token lists."""
    lib = _load()
    blob, offsets = _pack_texts(texts)
    res = lib.bb25_tokenize(
        blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(texts), int(lowercase), int(remove_stopwords), _stem_mode(stem),
    )
    try:
        r = res.contents
        n_tok = int(r.n_tokens)
        tok_off = np.ctypeslib.as_array(r.token_offsets, shape=(n_tok + 1,))
        doc_off = np.ctypeslib.as_array(r.doc_offsets, shape=(len(texts) + 1,))
        token_blob = ctypes.string_at(r.token_blob, int(r.blob_size))
        tokens = [
            token_blob[tok_off[i]:tok_off[i + 1]].decode("utf-8")
            for i in range(n_tok)
        ]
        return [
            tokens[doc_off[d]:doc_off[d + 1]] for d in range(len(texts))
        ]
    finally:
        lib.bb25_free_tokenize(res)


def _unpack_corpus(lib, res, n_docs: int):
    try:
        r = res.contents
        nnz = int(r.nnz)
        n_vocab = int(r.n_vocab)
        indptr = np.array(
            np.ctypeslib.as_array(r.doc_indptr, shape=(n_docs + 1,))
        )
        term_ids = np.array(
            np.ctypeslib.as_array(r.term_ids, shape=(max(nnz, 1),))
        )[:nnz]
        term_counts = np.array(
            np.ctypeslib.as_array(r.term_counts, shape=(max(nnz, 1),))
        )[:nnz]
        doc_lengths = np.array(
            np.ctypeslib.as_array(r.doc_lengths, shape=(max(n_docs, 1),))
        )[:n_docs]
        voc_off = np.ctypeslib.as_array(r.vocab_offsets, shape=(n_vocab + 1,))
        vocab_blob = ctypes.string_at(r.vocab_blob, int(r.vocab_blob_size))
        vocab = {
            vocab_blob[voc_off[i]:voc_off[i + 1]].decode("utf-8"): i
            for i in range(n_vocab)
        }
        return vocab, indptr, term_ids, term_counts, doc_lengths
    finally:
        lib.bb25_free_corpus(res)


def build_corpus_native(texts: list[str], *, lowercase=True,
                        remove_stopwords=True, stem=True):
    """Tokenize + vocab + per-doc unique-term counts in one native pass.

    Returns (vocab: dict[str, int], doc_indptr (n+1,), term_ids (nnz,),
    term_counts (nnz,), doc_lengths (n,)).
    """
    lib = _load()
    blob, offsets = _pack_texts(texts)
    res = lib.bb25_build_corpus(
        blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(texts), int(lowercase), int(remove_stopwords), _stem_mode(stem),
    )
    return _unpack_corpus(lib, res, len(texts))


def build_corpus_tokens_native(corpus_tokens: list):
    """Pre-tokenized corpus -> vocab + CSR in one C++ pass.

    Same return contract as build_corpus_native; vocab id assignment and
    per-doc term order are bit-compatible with the Python
    ``_corpus_to_csr`` (global/within-doc first-occurrence). Returns None
    when the corpus can't ship as a NUL-joined ASCII blob (non-ASCII or
    NUL-containing tokens) — callers fall back to the Python builder.
    """
    lib = _load()
    n_docs = len(corpus_tokens)
    dc = np.fromiter(map(len, corpus_tokens), np.int64, n_docs)
    n_tokens = int(dc.sum())
    if n_tokens == 0:
        return None
    joined = "\x00".join(_chain.from_iterable(corpus_tokens))
    try:
        blob = joined.encode("utf-8")
    except UnicodeEncodeError:
        return None
    if len(blob) != len(joined) or joined.count("\x00") != n_tokens - 1:
        return None
    res = lib.bb25_build_corpus_tokens(
        blob, len(blob),
        dc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n_docs)
    if not res:
        return None
    return _unpack_corpus(lib, res, n_docs)


def _unpack_pairs(lib, res):
    try:
        r = res.contents
        n = int(r.n_pairs)
        if n == 0:
            z = np.zeros(0, np.int32)
            return z, z.copy(), z.copy()
        pq = np.array(np.ctypeslib.as_array(r.pair_q, shape=(n,)))
        pt = np.array(np.ctypeslib.as_array(r.pair_t, shape=(n,)))
        pc = np.array(np.ctypeslib.as_array(r.pair_c, shape=(n,)))
        return pq, pt, pc
    finally:
        lib.bb25_free_encode(res)


class VocabEncoder:
    """Persistent native vocabulary for batch query encoding.

    Replaces the per-token Python ``dict.get`` loop in
    ``engine/index.py:encode_queries`` / ``engine/split_index.py:
    encode_queries_split`` with one C++ pass over a token blob.  Output
    triples (query, term id, count) are grouped by query with term ids
    ascending within each query — bit-identical to the numpy
    ``np.unique`` dedup those functions perform.
    """

    def __init__(self, vocab: dict):
        lib = _load()
        terms = [None] * len(vocab)
        for tok, tid in vocab.items():
            terms[tid] = tok
        joined = "".join(terms)
        blob = joined.encode("utf-8")
        if len(blob) == len(joined):  # pure ASCII: char lengths == byte lengths
            lens = np.fromiter(map(len, terms), np.int64, len(terms))
        else:
            lens = np.fromiter((len(t.encode("utf-8")) for t in terms),
                               np.int64, len(terms))
        offsets = np.zeros(len(terms) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        self._lib = lib
        self._free = lib.bb25_vocab_free  # bound for __del__ at shutdown
        self._h = lib.bb25_vocab_create(
            blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(terms))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._free(h)
            self._h = None

    def encode_tokens(self, query_tokens: list) -> tuple | None:
        """Pre-tokenized queries -> (pair_q, pair_t, pair_c) int32 arrays.

        Ships one NUL-joined blob; token boundaries are recovered by a
        memchr scan in C++, so Python never computes per-token lengths.
        Returns None when a token is non-ASCII or contains NUL (the two
        cases the blob layout can't represent) — callers fall back to the
        Python dict loop.
        """
        qc = np.fromiter(map(len, query_tokens), np.int64,
                         len(query_tokens))
        n_tokens = int(qc.sum())
        if n_tokens == 0:
            z = np.zeros(0, np.int32)
            return z, z.copy(), z.copy()
        joined = "\x00".join(_chain.from_iterable(query_tokens))
        try:
            blob = joined.encode("utf-8")
        except UnicodeEncodeError:
            return None
        if (len(blob) != len(joined)
                or joined.count("\x00") != n_tokens - 1):
            return None
        res = self._lib.bb25_encode_tokens_sep(
            self._h, blob, len(blob),
            qc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(query_tokens),
            _encode_threads() if n_tokens >= 4096 else 1)
        return _unpack_pairs(self._lib, res)

    def encode_tokens_split(self, query_tokens: list, slot_of, K: int,
                            query_pad: int, freq_pad: int, tail_pad: int,
                            nt_min: int):
        """Pre-tokenized queries -> the PADDED split-encode arrays
        (fslots, fcnt, trows, qids, qcnt) in one native pass — lookup,
        dedup, frequency partition, and group-by all happen in C++
        (engine/split_index.py:encode_queries_split is the numpy twin
        and the semantics contract). Returns None when the token blob
        can't be represented (non-ASCII or embedded NUL) or when no
        token is in vocabulary (callers produce the empty-batch block).
        ``slot_of`` must be an int32 array over the vocabulary."""
        qc = np.fromiter(map(len, query_tokens), np.int64,
                         len(query_tokens))
        n_tokens = int(qc.sum())
        if n_tokens == 0:
            return None
        joined = "\x00".join(_chain.from_iterable(query_tokens))
        try:
            blob = joined.encode("utf-8")
        except UnicodeEncodeError:
            return None
        if (len(blob) != len(joined)
                or joined.count("\x00") != n_tokens - 1):
            return None
        res = self._lib.bb25_encode_tokens_split(
            self._h, blob, len(blob),
            qc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(query_tokens),
            slot_of.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            K, query_pad, freq_pad, tail_pad, nt_min)
        try:
            r = res.contents
            if not r.has_pairs:
                return None
            nq, Qf, nt, Qt = int(r.nq), int(r.Qf), int(r.nt), int(r.Qt)
            fslots = np.array(np.ctypeslib.as_array(r.fslots, (nq, Qf)))
            fcnt = np.array(np.ctypeslib.as_array(r.fcnt, (nq, Qf)))
            trows = np.array(np.ctypeslib.as_array(r.trows, (nt,)))
            qids = np.array(np.ctypeslib.as_array(r.qids, (nt, Qt)))
            qcnt = np.array(np.ctypeslib.as_array(r.qcnt, (nt, Qt)))
            return fslots, fcnt, trows, qids, qcnt
        finally:
            self._lib.bb25_free_encode_split(res)

    def encode_texts(self, texts: list[str], *, lowercase=True,
                     remove_stopwords=True, stem=True):
        """Raw query texts -> (pair_q, pair_t, pair_c): tokenize + vocab
        lookup + dedup in one native pass (no Python token objects)."""
        blob, offsets = _pack_texts(texts)
        res = self._lib.bb25_encode_texts(
            self._h, blob,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(texts), int(lowercase), int(remove_stopwords), _stem_mode(stem))
        return _unpack_pairs(self._lib, res)


def load_jsonl_native(path: str):
    """BEIR-format .jsonl -> (ids, titles, texts) with texts/titles as
    lazy BlobTexts (the document bodies never materialize as per-doc
    Python strings; they flow blob-to-blob into the corpus builder).

    Returns None when the file can't be opened. The C++ parser walks each
    top-level object with depth tracking (a "text" key nested inside
    "metadata" is skipped), decodes JSON escapes incl. \\uXXXX surrogate
    pairs to UTF-8, and keeps only lines with a non-empty "_id".
    """
    lib = _load()
    res = lib.bb25_load_jsonl(os.fsencode(path))
    if not res:
        return None
    try:
        r = res.contents
        n = int(r.n_docs)

        def unpack(blob_p, off_p, size):
            off = np.array(np.ctypeslib.as_array(off_p, shape=(n + 1,)))
            blob = ctypes.string_at(blob_p, int(size))
            return blob, off

        id_blob, id_off = unpack(r.id_blob, r.id_offsets, r.id_blob_size)
        # errors="replace": a lone \uD800-style escape in an _id decodes
        # to invalid UTF-8 (unpaired surrogate); keep the document rather
        # than raising mid-load.
        ids = [id_blob[id_off[i]:id_off[i + 1]].decode("utf-8", "replace")
               for i in range(n)]
        titles = BlobTexts(*unpack(r.title_blob, r.title_offsets,
                                   r.title_blob_size))
        texts = BlobTexts(*unpack(r.text_blob, r.text_offsets,
                                  r.text_blob_size))
        return ids, titles, texts
    finally:
        lib.bb25_free_jsonl(res)
