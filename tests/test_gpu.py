"""On-card checks: the serving path against the compare path, and what the
frequent-term matmuls lower to on the GPU.

Run on a machine with a GPU:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py

Elsewhere every test skips (the ``gpu_device`` fixture finds no GPU).
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke as cs  # noqa: E402
from bayesian_bm25_tpu import BayesianBM25Scorer  # noqa: E402
from bayesian_bm25_tpu.engine import split_index as sidx  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu_device():
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("no GPU visible to JAX")
    with jax.default_device(devices[0]):
        yield devices[0]


def _hlo(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


@pytest.mark.parametrize("storage", [None, "int8"])
def test_retrieve_matches_compare_path(gpu_device, storage):
    rng = np.random.default_rng(0)
    doc_terms = bench.corpus_term_ids(rng, 3000, 60, 3000)
    queries = bench.as_tokens(bench.query_term_ids(rng, 256, 8, 3000))
    scorer = BayesianBM25Scorer(base_rate=0.01, impact_storage=storage)
    scorer.index(bench.as_tokens(doc_terms), show_progress=False)
    got = cs.launch(scorer, queries, 10)
    ref, full_s, full_tf = cs.device_reference(scorer, queries, 10)
    checks = cs.Checks()
    cs.compare(checks, "gpu", got, ref, full_s, full_tf, scorer, queries)
    assert checks.failed == []


def test_f32_high_runs_three_bf16_passes(gpu_device):
    rng = np.random.default_rng(1)
    q = jnp.asarray(rng.integers(0, 3, (64, 512)).astype(np.float32))
    w = jnp.asarray(rng.gamma(2.0, 1.0, (4096, 512)).astype(np.float32))

    def high(a, b):
        return sidx._impact_matmul(a, b, None, jax.lax.Precision.HIGH)

    assert "bf16_bf16_f32_x3" in _hlo(high, q, w)
    ref = jnp.dot(q, w.T, precision=jax.lax.Precision.HIGHEST)
    rel = np.asarray(jnp.abs(high(q, w) - ref) / jnp.maximum(ref, 1e-3))
    assert rel.max() <= 1e-5


def test_int8_dot_is_an_integer_gemm(gpu_device):
    rng = np.random.default_rng(2)
    q = jnp.asarray(rng.integers(0, 3, (64, 512)).astype(np.int8))
    w = jnp.asarray(rng.integers(-127, 128, (4096, 512)).astype(np.int8))
    text = _hlo(lambda a, b: jnp.dot(a, b.T,
                                     preferred_element_type=jnp.int32), q, w)
    assert "gemm" in text
    got = jnp.dot(q, w.T, preferred_element_type=jnp.int32)
    want = np.asarray(q, np.int64) @ np.asarray(w, np.int64).T
    np.testing.assert_array_equal(np.asarray(got), want)
