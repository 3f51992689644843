"""Bring-up machinery that runs without a GPU: chip_smoke.py's reference
comparisons and result line, its refusal to run off the GPU (and
bench.py's), the compile-cache placement, the hash-keyed native build,
each storage tier's score error against the highest-precision path, and
the float32 precision of the fused Bayesian transform."""

import json
import os
import shutil
import subprocess
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
from bayesian_bm25_tpu.engine import index as eidx  # noqa: E402
from bayesian_bm25_tpu.engine import native  # noqa: E402
from bayesian_bm25_tpu.engine import scoring  # noqa: E402
from bayesian_bm25_tpu.engine import split_index as sidx  # noqa: E402
from bayesian_bm25_tpu.ops import transform as T  # noqa: E402

TINY = cs.PhaseSize(n_docs=1500, doc_len=40, vocab=2000, n_queries=128,
                    n_host_check=16)


def _cpu_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_COMPILATION_CACHE_DIR")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, **extra)
    return env


def _run(args, cwd=ROOT, **env):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          env=_cpu_env(**env), capture_output=True,
                          text=True, timeout=300)


# ---------------------------------------------------------------------------
# chip_smoke.py: refusal, result line, reference comparisons
# ---------------------------------------------------------------------------


class TestRefusal:
    def test_chip_smoke_refuses_cpu(self):
        r = _run(["chip_smoke.py"])
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
        assert "not a GPU" in r.stderr

    def test_bench_refuses_cpu(self):
        r = _run(["bench.py"])
        assert r.returncode != 0
        assert r.stdout.strip() == ""
        assert "not a GPU" in r.stderr

    def test_chip_smoke_alone_fails(self, tmp_path):
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        env = _cpu_env()
        env.pop("PYTHONPATH")
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


class _FakeGpu:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def fake_gpu(monkeypatch):
    monkeypatch.setattr(bench, "require_gpu", lambda: _FakeGpu())
    monkeypatch.setattr(bench, "card_name_and_power_limit",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    calls = []
    monkeypatch.setattr(cs, "phase_50k", lambda c, card: calls.append("50k"))
    monkeypatch.setattr(cs, "phase_1m", lambda c, card: calls.append("1m"))
    monkeypatch.setattr(cs, "sharded_phase",
                        lambda c, devs: calls.append(("sharded", len(devs))))
    return calls


class TestResultLine:
    def test_exact_last_line(self, fake_gpu, capsys):
        assert cs.main([]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        n = len(jax.devices())
        assert lines[-1] == ('{"ok": true, "device": {"platform": "gpu", '
                             '"kind": "NVIDIA H100 80GB HBM3", "count": '
                             f'{n}}}}}')
        assert json.loads(lines[-1]) == {"ok": True, "device": {
            "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
            "count": n}}
        assert lines[-2] == "card: NVIDIA H100 80GB HBM3, 700.00 W"
        assert fake_gpu == ["50k", "1m"]

    def test_devices_option_runs_only_sharded(self, fake_gpu, capsys):
        assert cs.main(["--devices", "4"]) == 0
        last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert last["device"]["count"] == 4
        assert fake_gpu == [("sharded", 4)]

    def test_failed_check_prints_no_result(self, fake_gpu, monkeypatch,
                                           capsys):
        monkeypatch.setattr(
            cs, "phase_1m", lambda c, card: c.gate("x", 1.0, 0.5))
        assert cs.main([]) == 1
        out = capsys.readouterr()
        assert '"ok"' not in out.out
        assert "FAILED: x" in out.err


@pytest.fixture(scope="module")
def tiny_scorer():
    rng = np.random.default_rng(0)
    doc_terms = bench.corpus_term_ids(rng, 600, 40, 1500)
    query_terms = bench.query_term_ids(rng, 64, 8, 1500)
    s = BayesianBM25Scorer(base_rate=0.01)
    s.index(bench.as_tokens(doc_terms), show_progress=False)
    return s, doc_terms, query_terms, bench.as_tokens(query_terms)


class TestCompare:
    def _run(self, tiny_scorer, corrupt=None):
        s, _, _, queries = tiny_scorer
        got = [a.copy() for a in cs.launch(s, queries, 10)]
        ref, fs, ft = cs.device_reference(s, queries, 10)
        if corrupt:
            corrupt(got, ref)
        checks = cs.Checks()
        cs.compare(checks, "t", tuple(got), ref, fs, ft, s, queries)
        return checks.failed

    def test_clean_result_passes(self, tiny_scorer):
        assert self._run(tiny_scorer) == []

    def test_wrong_id_is_caught(self, tiny_scorer):
        def corrupt(got, ref):
            got[0][0, 0] = ref[0][0, -1] if ref[2][0, 0] != ref[2][0, -1] \
                else (ref[0][0, 0] + 1) % 600
        assert "t ids equal outside tie groups" in self._run(
            tiny_scorer, corrupt)

    def test_score_drift_is_caught(self, tiny_scorer):
        def corrupt(got, ref):
            got[2][3, 2] *= 1.001
        assert "t score relative error (max)" in self._run(
            tiny_scorer, corrupt)

    def test_tf_error_is_caught(self, tiny_scorer):
        def corrupt(got, ref):
            got[3][1, 1] += 1
        assert "t tf exact" in self._run(tiny_scorer, corrupt)

    def test_probability_error_is_caught(self, tiny_scorer):
        def corrupt(got, ref):
            got[1][2, 0] += 1e-4
        assert "t f32 transform vs float64 (max abs)" in self._run(
            tiny_scorer, corrupt)

    def test_host_reference_agrees(self, tiny_scorer):
        s, _, query_terms, queries = tiny_scorer
        host = bench.CpuReference(tiny_scorer[1])
        checks = cs.Checks()
        cs.compare_host(checks, "h", cs.launch(s, queries, 10), host,
                        query_terms, s)
        assert checks.failed == []

    def test_int8_bound_holds_and_is_tight(self, tiny_scorer):
        _, doc_terms, _, queries = tiny_scorer
        s8 = BayesianBM25Scorer(base_rate=0.01, impact_storage="int8")
        s8.index(bench.as_tokens(doc_terms), show_progress=False)
        ids, _, scores, _ = cs.launch(s8, queries, 10)
        _, fs, _ = cs.device_reference(s8, queries, 10)
        ref_at = cs._take(fs, ids).astype(np.float64)
        bound = cs.score_bound(s8, queries, ids, ref_at)
        err = np.abs(scores - ref_at)[ids >= 0]
        assert np.all(err <= bound[ids >= 0])
        assert bound[ids >= 0].max() < 1e-2 * ref_at[ids >= 0].max()


class TestPhases:
    def test_phase_50k_tiny(self):
        checks = cs.Checks()
        cs.phase_50k(checks, "cpu", TINY, n_batches=2)
        assert checks.failed == []

    def test_phase_1m_tiny_engages_every_pass(self, monkeypatch):
        monkeypatch.setattr(sidx, "_POSTINGS_MAX_ENTRIES", 150_000)
        monkeypatch.setattr(sidx, "_LH_MIN_SAVE", 500)
        monkeypatch.setattr(sidx, "_LHB_MIN_SAVE", 100)
        monkeypatch.setattr(BayesianBM25Scorer, "_SPLIT_INT8_MIN_DOCS",
                            1 << 11)
        monkeypatch.setattr(BayesianBM25Scorer, "_SPLIT_BUDGET_BYTES",
                            128 * 4096 * 4)
        checks = cs.Checks()
        cs.phase_1m(checks, "cpu", cs.PhaseSize(
            n_docs=4000, doc_len=30, vocab=6000, n_queries=256,
            n_host_check=16), n_batches=2)
        assert checks.failed == []

    def test_sharded_comparison_on_four_devices(self):
        if len(jax.devices()) < 8:
            pytest.skip("needs the 8 virtual CPU devices")
        checks = cs.Checks()
        cs.sharded_phase(checks, jax.devices()[:4], TINY, n_queries=64)
        assert checks.failed == []


# ---------------------------------------------------------------------------
# Compile cache and native build
# ---------------------------------------------------------------------------


_PRINT_CACHE = ("import bayesian_bm25_tpu, jax; import jax.numpy as jnp; "
                "jax.jit(lambda x: x * 2 + 1)(jnp.ones(3)).block_until_ready();"
                " print(jax.config.jax_compilation_cache_dir)")


class TestCompileCache:
    def test_env_dir_is_used(self, tmp_path):
        r = _run(["-c", _PRINT_CACHE], JAX_COMPILATION_CACHE_DIR=str(
            tmp_path), JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
            JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0")
        assert r.returncode == 0, r.stderr
        assert r.stdout.strip().splitlines()[-1] == str(tmp_path)
        assert any(tmp_path.iterdir())

    def test_default_is_inside_checkout(self):
        r = _run(["-c", _PRINT_CACHE])
        assert r.returncode == 0, r.stderr
        assert r.stdout.strip().splitlines()[-1] == os.path.join(
            ROOT, ".cache", "jax")

    def test_helper_and_this_process_agree(self, monkeypatch):
        import bayesian_bm25_tpu as bb

        assert jax.config.jax_compilation_cache_dir == (
            os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(ROOT, ".cache", "jax"))
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/x/y")
        assert bb.compile_cache_dir() == "/x/y"
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        assert bb.compile_cache_dir() == os.path.join(ROOT, ".cache", "jax")


_TINY_CPP = 'extern "C" int bb25_probe() { return %d; }\n'


class TestNativeBuild:
    def test_output_under_build_dir(self):
        assert native._BUILD_DIR == os.path.join(ROOT, "build")
        path = native.library_path()
        assert os.path.dirname(path) == os.path.join(ROOT, "build")
        assert os.path.basename(path).startswith("bb25_native-")

    def test_reuse_when_unchanged(self, tmp_path, monkeypatch):
        src = tmp_path / "probe.cpp"
        src.write_text(_TINY_CPP % 1)
        out = tmp_path / "build"
        first = native._build_library(str(src), str(out))
        assert os.path.exists(first)

        def no_compiler(*a, **k):
            raise AssertionError("rebuilt an unchanged source")

        monkeypatch.setattr(native.subprocess, "run", no_compiler)
        assert native._build_library(str(src), str(out)) == first

    def test_rebuild_on_source_change(self, tmp_path):
        src = tmp_path / "probe.cpp"
        out = tmp_path / "build"
        src.write_text(_TINY_CPP % 1)
        a = native._build_library(str(src), str(out))
        src.write_text(_TINY_CPP % 2)
        b = native._build_library(str(src), str(out))
        assert a != b and os.path.exists(b)
        import ctypes

        assert ctypes.CDLL(b).bb25_probe() == 2

    def test_flags_are_part_of_the_key(self, tmp_path):
        src = tmp_path / "probe.cpp"
        src.write_text(_TINY_CPP % 1)
        a = native.library_path(str(src), str(tmp_path), ("-O3",))
        b = native.library_path(str(src), str(tmp_path), ("-O2",))
        assert a != b

    def test_stale_name_is_ignored(self, tmp_path):
        # A library copied in under another name (e.g. the old mtime-keyed
        # one) is never loaded: only the hash-keyed path is consulted.
        src = tmp_path / "probe.cpp"
        src.write_text(_TINY_CPP % 3)
        out = tmp_path / "build"
        out.mkdir()
        (out / "probe.so").write_bytes(b"not a library")
        path = native._build_library(str(src), str(out))
        assert os.path.basename(path) != "probe.so"
        import ctypes

        assert ctypes.CDLL(path).bb25_probe() == 3


# ---------------------------------------------------------------------------
# Storage tiers against the highest-precision path; transform precision
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tier_setup():
    rng = np.random.default_rng(4)
    corpus = [[f"t{t}" for t in rng.zipf(1.3, size=rng.integers(20, 80))
               % 3000] for _ in range(900)]
    queries = [[f"t{t}" for t in rng.zipf(1.3, size=8) % 3000]
               for _ in range(64)]
    idx = eidx.build_index(corpus)
    base = sidx.build_split_index(idx, n_frequent=256, storage="f32")
    enc = sidx.encode_queries_split(queries, base)
    ref = np.asarray(sidx.score_all_split(
        base, *enc, precision=jax.lax.Precision.HIGHEST)[0])
    return idx, queries, ref


class TestStorageTierClasses:
    @pytest.mark.parametrize("storage,tol", [
        ("f32", 1e-6), ("hilo", 1e-5), ("bf16", 2.0 ** -8)])
    def test_relative_class(self, tier_setup, storage, tol):
        idx, queries, ref = tier_setup
        split = sidx.build_split_index(idx, n_frequent=256, storage=storage)
        enc = sidx.encode_queries_split(queries, split)
        got = np.asarray(sidx.score_all_split(
            split, *enc, precision=jax.lax.Precision.HIGH)[0])
        m = ref > 1e-3
        rel = np.abs(got[m] - ref[m]) / ref[m]
        assert rel.max() <= tol

    def test_int8_within_representation_bound(self, tier_setup):
        idx, queries, ref = tier_setup
        split = sidx.build_split_index(idx, n_frequent=256, storage="int8")
        enc = sidx.encode_queries_split(queries, split)
        got = np.asarray(sidx.score_all_split(split, *enc)[0])
        scale = np.asarray(split.impact_scale, dtype=np.float64)
        qsum = enc[1].sum(axis=1)[:, None]
        bound = qsum * (scale[1] / 2 + 1e-6 * 127 * scale[0])[None, :]
        assert np.all(np.abs(got - ref) <= bound + 1e-6 * np.abs(ref))


class TestTransformPrecision:
    def test_float32_near_saturation(self):
        s = np.linspace(0.01, 40, 20001)
        tf = np.full_like(s, 3.0)
        r = np.ones_like(s)
        for a, b in ((0.87, 9.0), (0.4, 5.0), (2.0, 3.0)):
            want = bench.reference_probability(s, tf, r, a, b, 0.01,
                                               eps=1e-6)
            with jax.enable_x64(False):
                got = np.asarray(T.score_to_probability(
                    jnp.asarray(s, jnp.float32), jnp.asarray(tf, jnp.float32),
                    jnp.asarray(r, jnp.float32), a, b, 0.01))
            assert np.abs(got - want).max() < 1e-6

    def test_complement_form_equals_plain_update(self):
        rng = np.random.default_rng(0)
        L = rng.uniform(0.01, 0.99, 500)
        p = rng.uniform(0.1, 0.9, 500)
        br = 0.05
        num = L * p
        out = num / (num + (1 - L) * (1 - p))
        want = out * br / (out * br + (1 - out) * (1 - br))
        got = np.asarray(T.posterior(jnp.asarray(L), jnp.asarray(p), br))
        np.testing.assert_allclose(got, want, rtol=1e-12)


class TestCpuReference:
    def test_matches_compare_path(self, tiny_scorer):
        s, doc_terms, query_terms, queries = tiny_scorer
        idx, t = s.bm25_index, s.transform
        qids, qcnt = eidx.encode_queries(queries, idx.vocab)
        ids, probs, scores, tfs = (np.asarray(a) for a in scoring.retrieve_topk(
            idx.term_ids, idx.weights, idx.doc_lengths, idx.avgdl, qids,
            qcnt, 10, t.alpha, t.beta, t.base_rate, n_docs=idx.n_docs))
        host = bench.CpuReference(doc_terms)
        h_ids, h_probs, h_scores, h_tfs = host.topk(
            query_terms, 10, t.alpha, t.beta, t.base_rate)
        np.testing.assert_allclose(scores, h_scores, rtol=1e-5)
        # Equal-length docs tie often; a differing id must tie on score.
        at = np.stack([host.scores(q)[row] for q, row in
                       zip(query_terms, ids)])
        np.testing.assert_allclose(at, h_scores, rtol=1e-5)
        same = ids == h_ids
        assert same.any()
        np.testing.assert_array_equal(tfs[same], h_tfs[same])
        np.testing.assert_allclose(probs[same], h_probs[same], atol=1e-5)

    def test_corpus_and_queries_draws_unchanged(self):
        # bench's tokens are the integer draws it always made.
        a = bench.make_corpus(np.random.default_rng(0), 5, 4, 30)
        rng = np.random.default_rng(0)
        b = [[f"t{t}" for t in row]
             for row in rng.zipf(1.3, size=(5, 4)) % 30]
        assert a == b
        q = bench.make_queries(rng, 3, 2, 30)
        rng2 = np.random.default_rng(0)
        rng2.zipf(1.3, size=(5, 4))
        assert q == [[f"t{t}" for t in rng2.zipf(1.3, size=2) % 30]
                     for _ in range(3)]
