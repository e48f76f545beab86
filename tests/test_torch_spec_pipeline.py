"""The pipelined verify (``spec_pipeline_enable``) on the port's engine, on
the CPU at the debug model's size (float32).

- Pipeline on equals pipeline off token for token (greedy copy-heavy and
  plain prompts, a seeded row), on both layouts, at ``decode_runahead`` 1
  and 4, and the runahead engages: drafts proposed while a verify was in
  flight are confirmed on the copy-heavy prompt.
- The fault point ``engine.spec_pipeline``: an ``error`` rule (installed
  from a ``GENAI_FAULTS`` spec) turns every flush's runahead drafts into
  rollbacks, the streams stay the same, and nothing is confirmed; on the
  JAX engine's weights it fires at the same calls as in the JAX engine
  (slow).
- A drain lands the verify in flight before it parks: every stream is
  checkpointed, and a fresh spec engine restores each token for token.
- Under ``disagg`` the spec streams equal ``unified``'s (the proposer
  context crosses the tiers with the handoff).
- A shutdown with a verify in flight delivers its tokens and ends every
  stream.
"""
import time

import jax.numpy as jnp
import pytest

from generativeaiexamples_tpu.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine.llm_engine import LLMEngine as JaxEngine
from generativeaiexamples_tpu.engine.llm_engine import SamplingParams as JaxParams
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.utils import faults as jfaults
from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import request_snapshot as rs
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
from generativeaiexamples_tpu_torch.engine.scheduler import handoff
from generativeaiexamples_tpu_torch.models.convert import params_from_jax
from generativeaiexamples_tpu_torch.utils import faults
from generativeaiexamples_tpu_torch.utils.resilience import RequestPreempted

TINY = dict(model_config_name="debug", max_batch_size=4, max_seq_len=128, prefill_chunk=16,
            decode_block=1, dtype="float32", page_size=8, spec_decode_enable="on")
COPY_PROMPT = [3 + 10 * i for i in range(16)]
PLAIN_PROMPT = [(i * 7) % 250 + 1 for i in range(24)]
LEGS = [
    (COPY_PROMPT, dict(temperature=0.0, max_tokens=64)),
    (PLAIN_PROMPT, dict(temperature=0.0, max_tokens=48)),
    (COPY_PROMPT, dict(temperature=0.8, top_p=0.9, max_tokens=32, seed=1234)),
]


@pytest.fixture(autouse=True)
def _no_faults():
    faults.reset()
    yield
    faults.reset()


def _engine(tmp_path=None, params=None, **kw):
    cfg = dict(TINY, **kw)
    if tmp_path is not None:
        cfg["snapshot_spool_dir"] = str(tmp_path / "spool")
    return LLMEngine(EngineConfig(**cfg), device="cpu", params=params)


def _streams(engine, legs=LEGS):
    return [list(engine.iter_ids(p, SamplingParams(**kw), timeout=120)) for p, kw in legs]


@pytest.mark.parametrize("runahead", [1, 4])
@pytest.mark.parametrize("layout", ["paged", "fixed"])
def test_pipeline_on_equals_off_and_engages(layout, runahead):
    on = _engine(kv_layout=layout, decode_runahead=runahead)
    off = _engine(kv_layout=layout, decode_runahead=runahead, spec_pipeline_enable="off")
    try:
        assert on._spec_pipeline and not off._spec_pipeline
        got, ref = _streams(on), _streams(off)
        assert got == ref and all(got)
        st, st_off = on.stats(), off.stats()
        assert st["spec_pipeline_confirmed"] > 0
        assert st_off["spec_pipeline_confirmed"] == st_off["spec_pipeline_rollbacks"] == 0
        assert off._spec_pending is None
    finally:
        on.shutdown()
        off.shutdown()


def test_fault_forced_rollbacks_stay_token_identical():
    on = _engine(kv_layout="paged")
    off = _engine(kv_layout="paged", spec_pipeline_enable="off")
    try:
        params = [(COPY_PROMPT, dict(temperature=0.0, max_tokens=64))]
        ref = _streams(off, params)
        s0 = on.stats()
        assert faults.install("engine.spec_pipeline:error@1x0") == 1
        try:
            got = _streams(on, params)
            fired = faults.call_count("engine.spec_pipeline")
        finally:
            faults.reset()
        s1 = on.stats()
        assert got == ref and fired > 0
        assert s1["spec_pipeline_rollbacks"] > s0["spec_pipeline_rollbacks"]
        assert s1["spec_pipeline_confirmed"] == s0["spec_pipeline_confirmed"]
        # once the rule is gone the runahead confirms again
        assert _streams(on, params) == ref
        assert on.stats()["spec_pipeline_confirmed"] > s1["spec_pipeline_confirmed"]
    finally:
        on.shutdown()
        off.shutdown()


@pytest.mark.slow
def test_the_fault_point_fires_where_the_jax_engine_s_does():
    """The same weights, prompts and rule on both engines: the same number
    of calls reach ``engine.spec_pipeline`` (one per flush that carried
    runahead drafts) and the streams are equal."""
    kw = dict(TINY, kv_layout="paged", decode_block=4)
    jax_engine = JaxEngine(JaxEngineConfig(tensor_parallelism=1, **kw))
    port = LLMEngine(EngineConfig(**kw), device="cpu",
                     params=params_from_jax(jl.init_params_fast(jl.PRESETS["debug"], 0, jnp.float32)))
    spec = "engine.spec_pipeline:error@2x0"
    try:
        calls = []
        for mod, engine, params in ((jfaults, jax_engine, JaxParams), (faults, port, SamplingParams)):
            mod.install(spec)
            try:
                out = [list(engine.iter_ids(p, params(**k), timeout=600)) for p, k in LEGS]
                calls.append((mod.call_count("engine.spec_pipeline"), out))
            finally:
                mod.reset()
        assert calls[0][0] > 1
        assert calls[1] == calls[0]
    finally:
        jax_engine.shutdown()
        port.shutdown()


WAVE = [COPY_PROMPT, PLAIN_PROMPT, [5 + 7 * i for i in range(20)], COPY_PROMPT[:12]]
WAVE_PARAMS = [dict(temperature=0.0, max_tokens=40), dict(temperature=0.0, max_tokens=40),
               dict(temperature=0.7, top_p=0.9, max_tokens=40, seed=5),
               dict(temperature=0.0, max_tokens=40)]


def _wave(engine):
    with engine.hold_admissions():
        return [engine.submit(p, SamplingParams(**k)) for p, k in zip(WAVE, WAVE_PARAMS)]


def _finish(reqs, timeout=120):
    for req in reqs:
        while req.out_queue.get(timeout=timeout) is not None:
            pass
    return [list(r.emitted) for r in reqs]


def test_a_drain_lands_the_verify_in_flight_and_restores_token_identical(tmp_path):
    e1 = _engine(tmp_path, kv_layout="paged", decode_block=2)
    e2 = None
    try:
        ref = _finish(_wave(e1))
        reqs = _wave(e1)
        parks = []
        orig_flush = e1._flush_spec_pipeline

        def flush():
            if e1._draining:
                parks.append(e1._spec_pending is not None)
            orig_flush()

        e1._flush_spec_pipeline = flush
        faults.configure("engine.dispatch", "delay", at=1, count=0, value=0.05)
        try:
            deadline = time.time() + 60
            while not all(r.generated >= 4 for r in reqs):
                assert time.time() < deadline
                time.sleep(0.005)
            assert not any(r.finished for r in reqs)
            summary = e1.drain()
        finally:
            faults.reset()
        assert summary["parked"] and summary["spooled"] == len(reqs)
        assert e1._spec_pending is None and not e1._spec_ctx
        assert True in parks  # a verify was in flight at the park
        e2 = _engine(tmp_path, params=e1.params, kv_layout="paged", decode_block=2)
        restored = []
        for req in reqs:
            assert isinstance(req.error, RequestPreempted)
            snap = rs.RequestSnapshot.from_doc(e2.snapshot_spool.load_doc(req.error.snapshot_id))
            new, _, prior, mode = e2.restore_snapshot(snap)
            assert mode == "restore" and prior == list(req.emitted)
            restored.append(new)
        assert _finish(restored) == ref
        assert e2.stats()["spec_verify_dispatches"] > 0
    finally:
        e1.shutdown()
        if e2 is not None:
            e2.shutdown()


def test_disagg_spec_streams_equal_unified():
    results = {}
    for policy in ("unified", "disagg"):
        engine = _engine(kv_layout="paged", decode_block=4, scheduler_policy=policy)
        try:
            h0 = handoff.metrics_snapshot()["handoffs"]
            results[policy] = _finish(_wave(engine))
            # the contexts crossed with the handoffs: the decode tier drafts
            assert engine.stats()["spec_verify_dispatches"] > 0, policy
            assert (handoff.metrics_snapshot()["handoffs"] - h0 == len(WAVE)) == (policy == "disagg")
        finally:
            engine.shutdown()
    assert results["disagg"] == results["unified"]


def test_shutdown_with_a_verify_in_flight_ends_every_stream():
    engine = _engine(kv_layout="paged")
    lands = []
    orig = engine._flush_spec_pipeline

    def flush():
        lands.append(engine._spec_pending is not None)
        orig()

    engine._flush_spec_pipeline = flush
    reqs = _wave(engine)
    deadline = time.time() + 60
    while not all(r.generated >= 2 for r in reqs):
        assert time.time() < deadline
        time.sleep(0.002)
    assert engine.shutdown()
    for req in reqs:
        assert req.finished
        # every token the reader got made it to the stream, then the end
        items = []
        while (t := req.out_queue.get(timeout=10)) is not None:
            items.append(t)
    assert any(lands)
