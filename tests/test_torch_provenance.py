"""The port's provenance stamps (generativeaiexamples_tpu_torch/utils/
provenance.py) against the JAX package's (utils/provenance.py): the five
functions give equal results on the same inputs (git queries, their
environment overrides, fingerprints of dataclasses, dicts, lists and
unknown leaves, the provenance block and the comparability reasons), and
the two modules that kept trimmed copies (engine/request_snapshot.py,
utils/blackbox.py) now stamp through it.

A snapshot document written in the format the port's spool has always
written (its provenance block, the fingerprint of the engine config) still
restores on an engine of this tree: a replay-only document that the JAX
package's ``RequestSnapshot.to_doc`` wrote, and a mid-stream document with
its KV payload, each continued token for token. Exact comparisons: no
tolerance applies.
"""
import dataclasses
import json

import numpy as np
import pytest

from generativeaiexamples_tpu.engine import request_snapshot as jsnap
from generativeaiexamples_tpu.utils import provenance as jprov
from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import request_snapshot as tsnap
from generativeaiexamples_tpu_torch.utils import blackbox as tbb
from generativeaiexamples_tpu_torch.utils import provenance as tprov
from tests.test_torch_drain_restore import (
    PARAMS, PROMPTS, _drain_mid_decode, _engine, _finish, _throttled_wave, _wave,
)


@dataclasses.dataclass
class _Inner:
    b: float = 1.5
    c: tuple = (1, "x")


@dataclasses.dataclass
class _Outer:
    a: int = 3
    inner: _Inner = dataclasses.field(default_factory=_Inner)
    extra: dict = dataclasses.field(default_factory=lambda: {2: "two", "k": [None, True]})


def _configs(seed):
    rng = np.random.default_rng(seed)
    keys = [f"k{int(i)}" for i in rng.integers(0, 50, 6)]
    return [
        None, {}, [], _Outer(), _Outer(a=int(rng.integers(0, 100))),
        {k: float(rng.normal()) for k in keys},
        {"nested": {"x": [1, 2, {"y": object.__name__}]}, 3: "int key"},
        EngineConfig(), EngineConfig(kv_cache_dtype="int8", max_batch_size=int(rng.integers(1, 9))),
        {"unknown_leaf": complex(1, 2)}, [_Inner(), _Inner(b=float(rng.normal()))],
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_config_fingerprint_is_jax_s(seed):
    for cfg in _configs(seed):
        got = tprov.config_fingerprint(cfg)
        assert got == jprov.config_fingerprint(cfg)
        assert got is None if cfg is None else len(got) == 12


@pytest.mark.parametrize("sha,dirty", [
    (None, None), ("abc123", None), (None, "0"), (None, "false"), (None, "no"), (None, ""),
    (None, "1"), (None, "yes"), ("deadbeef", "true"),
])
def test_git_stamps_are_jax_s(monkeypatch, sha, dirty):
    for name, value in (("GENAI_GIT_SHA", sha), ("GENAI_GIT_DIRTY", dirty)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    assert tprov.git_sha() == jprov.git_sha()
    assert tprov.git_dirty() == jprov.git_dirty()
    if sha:
        assert tprov.git_sha() == sha
    if dirty is not None:
        assert tprov.git_dirty() is (dirty.lower() not in ("0", "false", "no", ""))


@pytest.mark.parametrize("seed", [0, 1])
def test_provenance_block_is_jax_s(monkeypatch, seed):
    monkeypatch.setenv("GENAI_GIT_SHA", "feedface")
    monkeypatch.setenv("GENAI_GIT_DIRTY", "0")
    for cfg in _configs(seed):
        for weights in (None, True, False):
            extra = {"kv_cache_dtype": "int4", "paged_kernel_path": "kernel"} if seed else {}
            got = tprov.provenance(cfg, weights, **extra)
            assert got == jprov.provenance(cfg, weights, **extra)
            assert list(got)[:4] == ["git_sha", "git_dirty", "config_fingerprint",
                                     "weights_random_init"]


def test_comparable_reasons_are_jax_s():
    base = tprov.provenance({"k": 1}, True, kv_cache_dtype="bfloat16")
    cases = [
        dict(base), dict(base, git_sha="other"), dict(base, config_fingerprint="000000000000"),
        dict(base, weights_random_init=False), dict(base, kv_cache_dtype="int8"),
        {k: v for k, v in base.items() if k != "kv_cache_dtype"},
        dict(base, config_fingerprint=None, weights_random_init=None),
        dict(base, config_fingerprint="1", weights_random_init=False, kv_cache_dtype="int4"),
    ]
    for a in cases:
        for b in cases:
            assert tprov.comparable(a, b) == jprov.comparable(a, b)
    assert tprov.comparable(base, cases[4]) == ["kv_cache_dtype differs: 'bfloat16' vs 'int8'"]


def test_the_snapshot_and_the_black_box_stamp_through_the_module(monkeypatch, tmp_path):
    monkeypatch.setenv("GENAI_GIT_SHA", "cafe0001")
    monkeypatch.setenv("GENAI_GIT_DIRTY", "1")
    assert not hasattr(tsnap, "git_sha") and not hasattr(tsnap, "config_fingerprint")
    snap = tsnap.RequestSnapshot(snapshot_id="s", rid=1, prompt_ids=[1, 2], emitted=[3],
                                 position=2, sampling_seed=4, params={})
    assert snap.to_doc()["provenance"] == {"git_sha": "cafe0001", "git_dirty": True}
    tbb.reset()
    try:
        tbb.configure(enable=True, directory=str(tmp_path), min_interval_s=0.0)
        bundle = tbb._snapshot("manual", {})
        assert bundle["provenance"]["git_sha"] == "cafe0001"
        assert bundle["provenance"]["git_dirty"] is True
    finally:
        tbb.reset()


def test_an_old_replay_document_written_by_the_jax_format_restores(tmp_path):
    eng = _engine(tmp_path)
    try:
        want = _finish(_wave(eng, PROMPTS[:1], PARAMS[:1]))[0]
        fp = jprov.config_fingerprint(eng.engine_config)
        assert eng.snapshot_spool.fingerprint == fp
        doc = jsnap.RequestSnapshot(
            snapshot_id="old-replay", rid=7, prompt_ids=list(PROMPTS[0]), emitted=[],
            position=0, sampling_seed=0,
            params={"temperature": 0.0, "top_p": 1.0, "max_tokens": PARAMS[0].max_tokens},
            config_fingerprint=fp).to_doc()
        doc = json.loads(json.dumps(doc))  # as the spool holds it
        snap = tsnap.RequestSnapshot.from_doc(doc)
        eng.snapshot_spool.check_fingerprint(snap)
        new, _, prior, mode = eng.restore_snapshot(snap)
        assert (mode, prior) == ("replay", [])
        assert _finish([new]) == [want]
    finally:
        eng.shutdown()


def test_an_old_mid_stream_document_restores_token_for_token(tmp_path):
    e1 = _engine(tmp_path)
    e2 = None
    try:
        ref = _finish(_wave(e1))
        reqs = _throttled_wave(e1)
        summary = _drain_mid_decode(e1, reqs)
        assert summary["spooled"] == len(reqs)
        e2 = _engine(tmp_path, params=e1.params)
        restored = []
        for req in reqs:
            doc = e2.snapshot_spool.load_doc(req.error.snapshot_id)
            # the stamp of the tree that wrote it
            doc["provenance"] = {"git_sha": "e6a205957dd990ae2ccf40c65968ac5d3e347a99",
                                 "git_dirty": False}
            new, _, prior, mode = e2.restore_snapshot(tsnap.RequestSnapshot.from_doc(doc))
            assert mode == "restore" and prior == list(req.emitted)
            restored.append(new)
        assert _finish(restored) == ref
    finally:
        e1.shutdown()
        if e2 is not None:
            e2.shutdown()
