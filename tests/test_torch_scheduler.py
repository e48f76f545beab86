"""The port's scheduler policies (generativeaiexamples_tpu_torch/engine/scheduler/)
on the CPU at the ``debug`` model's size, against the JAX package's seam:

- ``disagg`` streams (a prefill-tier thread prefills, the dispatch thread
  imports between decode blocks) equal ``unified`` streams token for
  token (exact), greedy and seeded, short and chunked prompts, bf16 and
  int4 pools, the prefix cache at its default; one handoff a request,
  the pages handed equal to the pages funded, no recompute, and neither
  tier's thread reads the device back;
- a transfer queue of depth 1 stalls the prefill tier and recovers, and
  the queue's own rules are JAX's (capacity, overshoot by one wave,
  ``pop_all`` wakes a stalled producer);
- a drain while handoffs wait in the queue captures them, and they
  restore token-identically;
- ``disagg`` on the fixed layout refuses with JAX's message, and the
  policies' validation and windows match JAX's.
"""
import dataclasses
import os
import threading
import time
import types

import pytest
import torch

from generativeaiexamples_tpu.config import get_config as jget_config
from generativeaiexamples_tpu.config.validate import validate_config as jvalidate
from generativeaiexamples_tpu.engine.scheduler import base as jbase
from generativeaiexamples_tpu.engine.scheduler import disagg as jdisagg
from generativeaiexamples_tpu.engine.scheduler import handoff as jhandoff
from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import request_snapshot as rs
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
from generativeaiexamples_tpu_torch.engine.scheduler import base as tbase
from generativeaiexamples_tpu_torch.engine.scheduler import handoff as thandoff
from generativeaiexamples_tpu_torch.utils.resilience import RequestPreempted

TINY = dict(model_config_name="debug", max_batch_size=4, max_seq_len=128, prefill_chunk=16,
            decode_block=2, dtype="float32", page_size=8, kv_layout="paged")
PRE = [(i * 7) % 250 + 1 for i in range(16)]
PROMPTS = [PRE + [3, 4, 5], [(i * 5) % 240 + 1 for i in range(9)], PRE + [9, 10, 11, 12, 13],
           [(i * 3) % 200 + 1 for i in range(21)], [7, 8, 9], [(i * 11) % 230 + 1 for i in range(40)]]
PARAMS = [SamplingParams(temperature=0.0, max_tokens=20),
          SamplingParams(temperature=0.7, top_p=0.9, max_tokens=20, seed=5),
          SamplingParams(temperature=0.0, max_tokens=20),
          SamplingParams(temperature=0.7, top_p=0.9, max_tokens=20, seed=11),
          SamplingParams(temperature=0.0, max_tokens=20),
          SamplingParams(temperature=0.7, top_p=0.9, max_tokens=20, seed=3)]


def _engine(tmp_path, policy, params=None, **overrides):
    cfg = EngineConfig(**{**TINY, "scheduler_policy": policy,
                          "snapshot_spool_dir": str(tmp_path / "spool"), **overrides})
    return LLMEngine(cfg, device="cpu", params=params)


def _streams(eng, prompts=PROMPTS, params=PARAMS):
    reqs = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    for req in reqs:
        while req.out_queue.get(timeout=120) is not None:
            pass
    return reqs


def _settle(eng, timeout=60.0):
    deadline = time.time() + timeout
    while (eng._slot_req or eng._tier_slots) and time.time() < deadline:
        time.sleep(0.01)
    assert not eng._slot_req and not eng._tier_slots


def _funded_pages(eng):
    """Record the pages funded a request (the allocator's grants in _fund)."""
    funded = {}
    orig = eng._fund

    def fund(claimed):
        out = orig(claimed)
        for req in out:
            funded[req.rid] = len(eng._slot_pages[req.slot])
        return out

    eng._fund = fund
    return funded


@pytest.mark.parametrize("kv", ["bfloat16", "int4"])
def test_disagg_streams_equal_unified_streams(tmp_path, kv, monkeypatch):
    uni = _engine(tmp_path, "unified", kv_cache_dtype=kv)
    dis = None
    try:
        assert uni.scheduler.kind == "unified" and uni.scheduler.describe()["tiers"] == 1
        want = [r.emitted for r in _streams(uni)]
        dis = _engine(tmp_path, "disagg", params=uni.params, kv_cache_dtype=kv)
        assert dis.scheduler.describe()["tiers"] == 2
        funded = _funded_pages(dis)
        seen = set()

        def recording(name):
            original = getattr(torch.Tensor, name)

            def wrapper(self, *args, **kwargs):
                seen.add(threading.current_thread().name)
                return original(self, *args, **kwargs)
            return wrapper

        for name in ("cpu", "tolist", "item", "numpy"):
            monkeypatch.setattr(torch.Tensor, name, recording(name))
        before = thandoff.metrics_snapshot()
        reqs = _streams(dis)
        _settle(dis)
        monkeypatch.undo()
        after = thandoff.metrics_snapshot()
        assert [r.emitted for r in reqs] == want
        assert after["handoffs"] - before["handoffs"] == len(PROMPTS)
        assert after["handoff_pages"] - before["handoff_pages"] == sum(funded.values())
        assert after["handoff_recompute"] == before["handoff_recompute"]
        assert after["handoff_bytes"] - before["handoff_bytes"] == \
            sum(funded.values()) * dis._page_bytes()
        assert "torch-llm-engine" not in seen and "torch-llm-prefill-tier" not in seen
        assert "torch-llm-reader" in seen
        assert dis.stats()["requests_prefilled"] == len(PROMPTS)
    finally:
        monkeypatch.undo()
        uni.shutdown()
        if dis is not None:
            assert dis.shutdown()
            assert not dis.scheduler._thread.is_alive()


def test_a_depth_one_queue_stalls_the_prefill_tier_and_recovers(tmp_path):
    # one row a wave (prefill_wave_tokens = one chunk): free slots and
    # pending requests remain while the first record fills the queue
    ref = _engine(tmp_path, "unified", prefill_wave_tokens=16)
    eng = _engine(tmp_path, "disagg", params=ref.params, prefill_wave_tokens=16,
                  handoff_queue_depth=1)
    try:
        want = [r.emitted for r in _streams(ref, PROMPTS[:4], PARAMS[:4])]
        hold = threading.Event()
        orig = eng._admit

        def gated():
            if hold.is_set():
                time.sleep(0.01)
                return
            orig()

        eng._admit = gated
        hold.set()
        before = thandoff.metrics_snapshot()
        reqs = [eng.submit(p, sp) for p, sp in zip(PROMPTS[:4], PARAMS[:4])]
        deadline = time.time() + 60
        while len(eng.scheduler.transfer) == 0:  # the first wave's records wait
            assert time.time() < deadline
            time.sleep(0.01)
        time.sleep(0.3)  # the tier stalls on the full queue meanwhile
        assert eng.scheduler.describe()["transfer_queued"] == 1
        with eng._lock:
            assert eng._pending and eng._free_slots  # the rest waits for room
        hold.clear()
        for req in reqs:
            while req.out_queue.get(timeout=120) is not None:
                pass
        after = thandoff.metrics_snapshot()
        assert after["handoff_stall_seconds"] - before["handoff_stall_seconds"] > 0.1
        assert after["handoffs"] - before["handoffs"] == 4
        assert [r.emitted for r in reqs] == want
        _settle(eng)
    finally:
        ref.shutdown()
        eng.shutdown()


def test_transfer_queue_rules_are_jax_s():
    for mod in (jhandoff, thandoff):
        cond = threading.Condition()
        with pytest.raises(ValueError, match="transfer queue capacity must be >= 1, got 0"):
            mod.TransferQueue(0, cond)
        q = mod.TransferQueue(1, cond)
        rec = types.SimpleNamespace(req=types.SimpleNamespace(rid=7))
        with cond:
            assert q.has_room()
            q.put(rec)
            q.put(types.SimpleNamespace(req=types.SimpleNamespace(rid=8)))  # a wave overshoots
            assert len(q) == 2 and not q.has_room()
        waited = {}

        def producer(q=q, cond=cond):
            with cond:
                waited["s"] = q.wait_room(lambda: False, 0.05)

        thread = threading.Thread(target=producer, name="test-wait-room", daemon=True)
        thread.start()
        time.sleep(0.2)
        assert thread.is_alive()
        with cond:
            assert [r.req.rid for r in q.pop_all()] == [7, 8]
        thread.join(5)
        assert not thread.is_alive() and waited["s"] >= 0.15


def test_a_drain_captures_queued_handoffs(tmp_path):
    """Records the decode tier never imported are checkpointed (their
    first token emitted, their prefill's pages read back) and restore on
    a fresh engine token for token."""
    ref = _engine(tmp_path, "unified")
    eng = _engine(tmp_path, "disagg", params=ref.params)
    other = None
    try:
        want = [r.emitted for r in _streams(ref, PROMPTS[:4], PARAMS[:4])]
        orig = eng._admit
        eng._admit = lambda: time.sleep(0.01)  # the decode tier imports nothing
        reqs = [eng.submit(p, sp) for p, sp in zip(PROMPTS[:4], PARAMS[:4])]
        deadline = time.time() + 60
        while not (len(eng.scheduler.transfer) == 4 and all(r.generated for r in reqs)):
            assert time.time() < deadline
            time.sleep(0.01)
        summary = eng.drain()
        eng._admit = orig
        assert summary["parked"] and summary["spooled"] == 4
        assert all(isinstance(r.error, RequestPreempted) for r in reqs)
        assert len(eng.scheduler.transfer) == 0
        assert sorted(eng._free_slots) == list(range(eng.num_slots)) and not eng._tier_slots
        other = _engine(tmp_path, "disagg", params=ref.params)
        restored = []
        for req in reqs:
            snap = rs.RequestSnapshot.from_doc(
                other.snapshot_spool.load_doc(req.error.snapshot_id))
            assert snap.position == len(req.prompt_ids) and len(snap.emitted) == 1
            new, _, _, mode = other.restore_snapshot(snap)
            assert mode == "restore"
            restored.append(new)
        for req in restored:
            while req.out_queue.get(timeout=120) is not None:
                pass
        assert [r.emitted for r in restored] == want
    finally:
        ref.shutdown()
        eng.shutdown()
        if other is not None:
            other.shutdown()


def test_disagg_refuses_the_fixed_layout_with_jax_s_message(tmp_path):
    fake = types.SimpleNamespace(_pp=None, _chunked=True, _paged=False,
                                 engine_config=types.SimpleNamespace(spec_draft_min_acceptance=0.0))
    with pytest.raises(ValueError) as want:
        jdisagg.DisaggPolicy(fake)
    with pytest.raises(ValueError) as got:
        _engine(tmp_path, "disagg", kv_layout="fixed")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("field,value", [("scheduler_policy", "pd"), ("handoff_queue_depth", -1)])
def test_scheduler_validation_has_jax_s_messages(field, value, monkeypatch):
    """``EngineConfig.validate`` (engine build and server startup) refuses
    as the JAX chain server's startup validation does."""
    for key in list(os.environ):
        if key.startswith("APP_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv({"scheduler_policy": "APP_ENGINE_SCHEDULERPOLICY",
                        "handoff_queue_depth": "APP_ENGINE_HANDOFFQUEUEDEPTH"}[field], str(value))
    jget_config.cache_clear()
    try:
        with pytest.raises(ValueError) as want:
            jvalidate(jget_config())
    finally:
        jget_config.cache_clear()
    with pytest.raises(ValueError) as got:
        dataclasses.replace(EngineConfig(), **{field: value}).validate()
    assert str(got.value) == str(want.value)
    assert tbase.POLICY_KINDS == jbase.POLICY_KINDS


def test_windows_follow_the_policy(tmp_path):
    """``unified``: ingest waits for decode to be idle, retrieval for no
    pending admission; ``disagg``: both wait for an idle prefill tier."""
    for policy in ("unified", "disagg"):
        eng = _engine(tmp_path, policy)
        try:
            assert eng.scheduler.ingest_window(0.01) and eng.scheduler.retrieval_window(0.01)
            with eng._lock:
                eng._pending.append(types.SimpleNamespace(rid=0))
            assert not eng.scheduler.retrieval_window(0.05)
            assert eng.scheduler.ingest_window(0.05) == (policy == "unified")
            with eng._lock:
                eng._pending.clear()
        finally:
            eng.shutdown()
