"""Drain and restore of a sharded engine's KV (``mesh=`` of ``cpu``
shards) against the one-shard port and the JAX engine.

A TP=2 engine drained mid-decode (the ``engine.dispatch`` delay keeps its
requests live across the drain) spools documents whose payload and
``geometry.num_kv_heads`` are the full model's: each shard's heads of the
snapshot's pages, concatenated in shard order. The geometry equals the
JAX TP=2 engine's document's, and every payload array has the JAX
document's shape. Each document restores, token for token, into a fresh
TP=2 engine, a TP=1 engine and the JAX engine (JAX's ``from_doc``,
``decode_kv_payload`` and ``check_geometry`` accept it): the spooled
tokens plus the continuation equal the undrained TP=2 stream (float32
weights: the row reduce moves logits by ~1e-6, no tolerance on tokens).
A TP=1 document restores at TP=2 the same way, and the fixed layout stays
replay-only, as in JAX.
"""
import time

import jax.numpy as jnp
import pytest

from generativeaiexamples_tpu.engine import request_snapshot as jsnap
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import request_snapshot as rs
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
from generativeaiexamples_tpu_torch.models.convert import params_from_jax
from generativeaiexamples_tpu_torch.parallel import create_mesh
from generativeaiexamples_tpu_torch.utils import faults

COMMON = dict(model_config_name="debug", dtype="float32", max_batch_size=4, max_seq_len=128,
              prefill_chunk=16, page_size=8, decode_block=2)
PROMPTS = [[256, 72, 105], list(range(40, 56)), [256] + [(5 * i) % 250 for i in range(37)]]
KW = [dict(temperature=0.0, max_tokens=24), dict(temperature=0.9, top_p=0.8, max_tokens=24, seed=7),
      dict(temperature=0.0, max_tokens=24)]


def _mesh(n):
    return create_mesh(n, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def weights():
    return jl.init_params_fast(jl.PRESETS["debug"], 0, jnp.float32)


def _engine(weights, n, tmp_path, **kw):
    cfg = EngineConfig(kv_layout=kw.pop("kv_layout", "paged"), snapshot_spool_dir=str(tmp_path),
                       **COMMON, **kw)
    return LLMEngine(cfg, params=params_from_jax(weights), mesh=_mesh(n))


def _undrained(weights, n, tmp_path, **kw):
    eng = _engine(weights, n, tmp_path, **kw)
    try:
        return [list(eng.iter_ids(p, SamplingParams(**k), timeout=120)) for p, k in zip(PROMPTS, KW)]
    finally:
        eng.shutdown()


def _drain(eng):
    """Every prompt submitted, the engine drained once each has a token:
    (the drain summary, the requests)."""
    faults.configure("engine.dispatch", "delay", at=1, count=0, value=0.05)
    try:
        with eng.hold_admissions():
            reqs = [eng.submit(p, SamplingParams(**k)) for p, k in zip(PROMPTS, KW)]
        deadline = time.time() + 120
        while not all(r.generated for r in reqs):
            assert time.time() < deadline
            time.sleep(0.005)
        summary = eng.drain()
    finally:
        faults.reset()
    assert summary["parked"]
    return summary, reqs


def _drained_docs(eng):
    """The drain's spooled documents in prompt order."""
    _, reqs = _drain(eng)
    return [eng.snapshot_spool.load_doc(r.error.snapshot_id) for r in reqs]


def _restored(eng, doc):
    snap = rs.RequestSnapshot.from_doc(doc)
    new, _, prior, mode = eng.restore_snapshot(snap)
    while new.out_queue.get(timeout=120) is not None:
        pass
    return mode, prior, [t for t in new.emitted if t not in eng._stop_ids]


def _jax_restored(jax_engine, doc):
    snap = jsnap.RequestSnapshot.from_doc(dict(doc, config_fingerprint=None))
    jsnap.check_geometry(jax_engine, snap)
    assert len(jsnap.decode_kv_payload(snap.kv)) == jl.PRESETS["debug"].num_layers
    new, _, prior, mode = jax_engine.restore_snapshot(snap)
    cont = []
    while (t := new.out_queue.get(timeout=600)) is not None:
        cont.append(t)
    return mode, prior, [t for t in list(prior) + cont if t not in jax_engine._stop_ids]


@pytest.mark.parametrize("kv_dtype", ["float32", "int8", "int4"])
def test_a_tp2_drain_restores_into_tp2_and_tp1(weights, tmp_path, kv_dtype):
    kv = {} if kv_dtype == "float32" else {"kv_cache_dtype": kv_dtype}
    ref = _undrained(weights, 2, tmp_path, **kv)
    e1 = _engine(weights, 2, tmp_path, **kv)
    try:
        docs = _drained_docs(e1)
    finally:
        e1.shutdown()
    hkv = jl.PRESETS["debug"].num_kv_heads
    for doc in docs:
        assert doc["geometry"]["num_kv_heads"] == hkv
        k = doc["kv"]["layers"][0]["k"]
        assert k["shape"][:3] == [doc["geometry"]["pages"], 8, hkv]
    for n in (2, 1):
        eng = _engine(weights, n, tmp_path, **kv)
        try:
            for doc, want in zip(docs, ref):
                mode, prior, got = _restored(eng, doc)
                assert mode == "restore" and 1 <= len(prior) < len(want)
                assert got == [t for t in want if t not in eng._stop_ids], (n, kv_dtype)
        finally:
            eng.shutdown()


def test_a_tp1_drain_restores_at_tp2(weights, tmp_path):
    ref = _undrained(weights, 2, tmp_path)
    e1 = _engine(weights, 1, tmp_path)
    try:
        docs = _drained_docs(e1)
    finally:
        e1.shutdown()
    eng = _engine(weights, 2, tmp_path)
    try:
        for doc, want in zip(docs, ref):
            mode, _, got = _restored(eng, doc)
            assert mode == "restore" and got == [t for t in want if t not in eng._stop_ids]
    finally:
        eng.shutdown()


def test_a_tp2_drain_restores_into_the_jax_engine(weights, tmp_path):
    """The JAX engine (one device, its own float32 weights: the same tree)
    takes the port's TP=2 documents and continues each stream as the
    undrained TP=2 port engine does."""
    from generativeaiexamples_tpu.config import EngineConfig as JaxEngineConfig
    from generativeaiexamples_tpu.engine.llm_engine import LLMEngine as JaxEngine

    ref = _undrained(weights, 2, tmp_path)
    e1 = _engine(weights, 2, tmp_path)
    try:
        docs = _drained_docs(e1)
    finally:
        e1.shutdown()
    jax_engine = JaxEngine(JaxEngineConfig(tensor_parallelism=1, kv_layout="paged",
                                           decode_runahead=1, snapshot_spool_dir=str(tmp_path / "j"),
                                           **COMMON))
    try:
        for doc, want in zip(docs, ref):
            mode, prior, got = _jax_restored(jax_engine, doc)
            assert mode == "restore" and prior == doc["emitted"]
            assert got == [t for t in want if t not in jax_engine._stop_ids]
    finally:
        jax_engine.shutdown()


def test_the_tp2_document_geometry_is_the_jax_tp2_engine_s(weights, tmp_path, monkeypatch):
    """The JAX engine at tensor_parallelism=2 drained mid-decode: its
    document's geometry (the page count aside, which depends on where the
    drain landed) and every payload array's dtype and per-page shape equal
    the port's TP=2 document's."""
    from generativeaiexamples_tpu.config import EngineConfig as JaxEngineConfig
    from generativeaiexamples_tpu.engine.llm_engine import LLMEngine as JaxEngine
    from generativeaiexamples_tpu.engine.llm_engine import SamplingParams as JaxParams
    from generativeaiexamples_tpu.utils import faults as jfaults

    kv = dict(kv_cache_dtype="int8")
    e1 = _engine(weights, 2, tmp_path, **kv)
    try:
        port_doc = _drained_docs(e1)[1]
    finally:
        e1.shutdown()
    monkeypatch.setenv("GENAI_TPU_TP_KERNELS", "interpret")
    jax_engine = JaxEngine(JaxEngineConfig(tensor_parallelism=2, serving_layout="layered",
                                           kv_layout="paged", decode_runahead=1,
                                           snapshot_spool_dir=str(tmp_path / "j"), **COMMON, **kv))
    monkeypatch.delenv("GENAI_TPU_TP_KERNELS")
    try:
        assert jax_engine._tp is not None
        jfaults.configure("engine.dispatch", "delay", at=1, count=0, value=0.05)
        try:
            req = jax_engine.submit(PROMPTS[1], JaxParams(**KW[1]))
            deadline = time.time() + 300
            while not req.generated:
                assert time.time() < deadline
                time.sleep(0.005)
            jax_engine.drain()
        finally:
            jfaults.reset()
        jax_doc = jax_engine.snapshot_spool.load_doc(req.error.snapshot_id)
    finally:
        jax_engine.resume_from_drain()
        jax_engine.shutdown()
    geo_p, geo_j = dict(port_doc["geometry"]), dict(jax_doc["geometry"])
    assert geo_p.pop("pages") >= 1 and geo_j.pop("pages") >= 1
    assert geo_p == geo_j
    for lp, lj in zip(port_doc["kv"]["layers"], jax_doc["kv"]["layers"]):
        assert sorted(lp) == sorted(lj)
        for key in lp:
            assert lp[key]["dtype"] == lj[key]["dtype"]
            assert lp[key]["shape"][1:] == lj[key]["shape"][1:]


def test_the_fixed_layout_stays_replay_only_under_tp(weights, tmp_path):
    ref = _undrained(weights, 2, tmp_path, kv_layout="fixed")
    e1 = _engine(weights, 2, tmp_path, kv_layout="fixed")
    try:
        summary, reqs = _drain(e1)
    finally:
        e1.shutdown()
    assert summary["replay_only"] == len(PROMPTS) and summary["spooled"] == 0
    eng = _engine(weights, 2, tmp_path, kv_layout="fixed")
    try:
        for req, want in zip(reqs, ref):
            assert req.error.snapshot_id is None
            doc = rs.capture(e1, req, 0, ()).to_doc()
            mode, prior, got = _restored(eng, doc)
            assert mode == "replay" and prior == []
            assert got == [t for t in want if t not in eng._stop_ids]
    finally:
        eng.shutdown()
