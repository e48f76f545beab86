"""Drain and restore on the port's engine (generativeaiexamples_tpu_torch/engine/llm_engine.py),
on the CPU at the ``debug`` model's size (every kernel wrapper runs its
plain version; float32, ``prefill_chunk`` 16, ``page_size`` 8,
``decode_block`` 2):

- on the paged layout with bf16 (float32 rows here), int8 and int4 pools,
  greedy and seeded rows in one wave, the prefix cache at its default
  (``auto``): a drain landed mid-decode by the ``engine.dispatch`` delay
  fault (reset in a ``finally``) preempts every stream with
  ``RequestPreempted`` and a snapshot id; a fresh engine on the same
  weights that shares only the spool restores each in ``restore`` mode,
  and the spooled tokens plus the continuation equal the undisturbed
  stream token for token (exact);
- the payload's pages hold the drained pool's rows bitwise;
- after the drain every slot is free, no prefix entry is pinned, and the
  pages in use are the entries' own;
- ``replay`` on the fixed layout and for a request never admitted (its
  replay with the pinned seed equals the undisturbed stream);
- ``EngineOverloaded`` for submits and restores while draining; a restore
  of another config's snapshot is refused; resume reopens admission;
- the same drain and restore through the port's engine server: the chat
  stream ends in a ``PREEMPTED`` chunk, ``/internal/snapshots`` lists the
  documents, another server's ``/internal/restore`` streams with
  ``X-GenAI-Restore: <id>; mode=restore``.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import request_snapshot as rs
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
from generativeaiexamples_tpu_torch.utils import faults
from generativeaiexamples_tpu_torch.utils.resilience import EngineOverloaded, RequestPreempted
from tests.test_torch_engine import entry_pages

TINY = dict(model_config_name="debug", max_batch_size=4, max_seq_len=128, prefill_chunk=16,
            decode_block=2, dtype="float32", page_size=8)
PRE = [(i * 7) % 250 + 1 for i in range(16)]  # one chunk shared by two prompts
PROMPTS = [PRE + [3, 4, 5], [(i * 5) % 240 + 1 for i in range(9)], PRE + [9, 10, 11, 12, 13],
           [(i * 3) % 200 + 1 for i in range(21)]]
PARAMS = [SamplingParams(temperature=0.0, max_tokens=24),
          SamplingParams(temperature=0.7, top_p=0.9, max_tokens=24, seed=5),
          SamplingParams(temperature=0.0, max_tokens=24),
          SamplingParams(temperature=0.7, top_p=0.9, max_tokens=24, seed=11)]


@pytest.fixture(autouse=True)
def _no_faults():
    faults.reset()
    yield
    faults.reset()


def _engine(tmp_path, params=None, **overrides):
    cfg = EngineConfig(**{**TINY, "kv_layout": "paged",
                          "snapshot_spool_dir": str(tmp_path / "spool"), **overrides})
    return LLMEngine(cfg, device="cpu", params=params)


def _wave(eng, prompts=PROMPTS, params=PARAMS):
    with eng.hold_admissions():
        return [eng.submit(p, sp) for p, sp in zip(prompts, params)]


def _finish(reqs, timeout=120):
    for req in reqs:
        while req.out_queue.get(timeout=timeout) is not None:
            pass
    return [list(r.emitted) for r in reqs]


def _settle(eng, timeout=60.0):
    deadline = time.time() + timeout
    while eng._slot_req and time.time() < deadline:
        time.sleep(0.01)
    return eng.stats()


def _drain_mid_decode(eng, reqs, min_tokens=1):
    """Throttle the dispatch loop, wait until every stream has tokens but
    none has finished, and drain."""
    faults.configure("engine.dispatch", "delay", at=1, count=0, value=0.05)
    try:
        deadline = time.time() + 60
        while not all(r.generated >= min_tokens for r in reqs):
            assert time.time() < deadline
            time.sleep(0.005)
        assert not any(r.finished for r in reqs)
        return eng.drain()
    finally:
        faults.reset()


def _assert_clean(eng):
    stats = _settle(eng)
    assert sorted(eng._free_slots) == list(range(eng.num_slots))
    assert not eng._slot_req and not eng._tier_slots
    if eng._prefix is not None:
        with eng._prefix._lock:
            assert all(e.refs == 0 for e in eng._prefix._entries)
    assert stats["pages_in_use"] == entry_pages(eng)


@pytest.mark.parametrize("kv", ["bfloat16", "int8", "int4"])
def test_drained_streams_restore_token_identical_on_a_fresh_engine(tmp_path, kv):
    e1 = _engine(tmp_path, kv_cache_dtype=kv)
    e2 = None
    try:
        assert e1._prefix is not None  # the JAX default, auto
        ref = _finish(_wave(e1))
        reqs = _wave(e1)
        pages_before = {}
        # the pool rows of each live request, read at the park
        orig_capture = rs.capture

        def spy(engine, req, position, pages):
            if pages:
                n = -(-position // engine.engine_config.page_size)
                pages_before[req.rid] = rs.read_pages(engine, pages[:n])
            return orig_capture(engine, req, position, pages)

        rs.capture = spy
        try:
            summary = _drain_mid_decode(e1, reqs)
        finally:
            rs.capture = orig_capture
        assert summary["parked"] and summary["spooled"] == len(reqs) == summary["preempted"]
        assert summary["replay_only"] == summary["completed"] == 0
        for req in reqs:
            assert isinstance(req.error, RequestPreempted)
            assert req.error.snapshot_id in summary["snapshots"]
        listed = {d["snapshot_id"]: d for d in e1.snapshot_spool.list()}
        assert set(listed) == set(summary["snapshots"])
        assert all(d["restorable"] for d in listed.values())
        _assert_clean(e1)
        with pytest.raises(EngineOverloaded, match="engine draining"):
            e1.submit(PROMPTS[0], PARAMS[0])

        e2 = _engine(tmp_path, params=e1.params, kv_cache_dtype=kv)
        assert e2.snapshot_spool.fingerprint == e1.snapshot_spool.fingerprint
        restored = {}
        for req in reqs:
            doc = e2.snapshot_spool.load_doc(req.error.snapshot_id)
            snap = rs.RequestSnapshot.from_doc(doc)
            payload = rs.decode_kv_payload(snap.kv)
            for layer, want in zip(payload, pages_before[req.rid]):
                for key in want:
                    assert layer[key].dtype == want[key].dtype
                    assert layer[key].reshape(-1).view(torch.uint8).equal(
                        want[key].reshape(-1).view(torch.uint8))
            new, _, prior, mode = e2.restore_snapshot(snap)
            assert mode == "restore" and prior == list(req.emitted)
            restored[req.rid] = new
        got = _finish([restored[r.rid] for r in reqs])
        assert got == ref
        # each was drained mid-stream: spooled tokens, then more decoded
        assert all(1 <= len(r.emitted) < len(g) for r, g in zip(reqs, got))
    finally:
        e1.shutdown()
        if e2 is not None:
            e2.shutdown()


def test_resume_reopens_admission_and_the_engine_serves_on(tmp_path):
    eng = _engine(tmp_path)
    try:
        ref = _finish(_wave(eng))
        reqs = _wave(eng)
        _drain_mid_decode(eng, reqs)
        assert eng.is_draining()
        snap = rs.RequestSnapshot.from_doc(
            eng.snapshot_spool.load_doc(reqs[0].error.snapshot_id))
        with pytest.raises(EngineOverloaded, match="cannot accept restores"):
            eng.restore_snapshot(snap)
        eng.resume_from_drain()
        assert not eng.is_draining()
        assert _finish(_wave(eng)) == ref
        # a snapshot restores on the engine that drained it too
        new, _, _, mode = eng.restore_snapshot(snap)
        assert mode == "restore" and _finish([new]) == [ref[0]]
        _assert_clean(eng)
    finally:
        eng.shutdown()


def test_fixed_layout_and_unadmitted_requests_replay_with_the_pinned_seed(tmp_path):
    """The fixed layout carries no KV: every live request is preempted
    replay-only, and so is a request still waiting for a slot on the
    paged layout; each replay equals the undisturbed stream."""
    fixed = _engine(tmp_path, kv_layout="fixed")
    try:
        ref = _finish(_wave(fixed))
        reqs = _wave(fixed)
        summary = _drain_mid_decode(fixed, reqs)
        assert summary["parked"] and summary["spooled"] == 0
        assert summary["replay_only"] == len(reqs) and fixed.snapshot_spool.list() == []
        assert all(isinstance(r.error, RequestPreempted) and r.error.snapshot_id is None
                   for r in reqs)
        fixed.resume_from_drain()
        for req, want in zip(reqs, ref):
            snap = rs.capture(fixed, req, 0, ())
            assert not snap.restorable
            new, params, prior, mode = fixed.restore_snapshot(snap)
            assert (mode, prior, params.seed) == ("replay", [], req.sampling_seed)
            assert _finish([new]) == [want]
    finally:
        fixed.shutdown()

    paged = _engine(tmp_path, max_batch_size=2)
    try:
        ref = _finish(_wave(paged))
        reqs = _wave(paged)
        summary = _drain_mid_decode(paged, reqs[:2])
        assert summary["spooled"] == 2 and summary["replay_only"] == 2
        assert [r.error.snapshot_id is None for r in reqs] == [False, False, True, True]
        assert all(r.emitted == [] for r in reqs[2:])
        paged.resume_from_drain()
        for req, want in zip(reqs[2:], ref[2:]):
            new, _, _, mode = paged.restore_snapshot(rs.capture(paged, req, 0, ()))
            assert mode == "replay" and _finish([new]) == [want]
    finally:
        paged.shutdown()


def test_restore_refuses_another_config_and_an_aborted_request_completes(tmp_path):
    e1 = _engine(tmp_path)
    e2 = _engine(tmp_path, params=e1.params, kv_cache_dtype="int8")
    try:
        reqs = _wave(e1)
        faults.configure("engine.dispatch", "delay", at=1, count=0, value=0.05)
        try:
            while not all(r.generated for r in reqs):
                time.sleep(0.005)
            assert e1.abort(reqs[3])
            summary = e1.drain()
        finally:
            faults.reset()
        # the abort ends the request, not the drain: a pass before the park
        # releases it, or the drain completes it
        assert summary["spooled"] == 3 and summary["completed"] in (0, 1)
        assert reqs[3].error is None and reqs[3].finished
        snap = rs.RequestSnapshot.from_doc(e1.snapshot_spool.load_doc(summary["snapshots"][0]))
        with pytest.raises(rs.SnapshotMismatch, match="refusing to restore"):
            e2.restore_snapshot(snap)
        snap.config_fingerprint = None
        with pytest.raises(rs.SnapshotMismatch, match="KV geometry mismatch: quantized is False"):
            e2.restore_snapshot(snap)
        _assert_clean(e1)
    finally:
        e1.shutdown()
        e2.shutdown()


def _serve(engine):
    from generativeaiexamples_tpu_torch.engine.server import make_server

    server = make_server("127.0.0.1", 0, engine=engine)
    thread = threading.Thread(target=server.serve_forever, name="test-engine-server",
                              daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def _sse(resp):
    out = []
    for raw in resp:
        line = raw.decode().strip()
        if line.startswith("data: "):
            out.append(line[6:])
    return out


def test_drain_and_restore_through_the_engine_servers(tmp_path):
    e1 = _engine(tmp_path)
    e2 = _engine(tmp_path, params=e1.params)
    servers = [_serve(e1), _serve(e2)]
    (_, _, base1), (_, _, base2) = servers
    try:
        body = {"messages": [{"role": "user", "content": "tell me"}], "stream": True,
                "max_tokens": 24, "temperature": 0.0}
        ref_ids = []
        orig_submit = e1.submit
        e1.submit = lambda *a, **k: ref_ids.append(orig_submit(*a, **k)) or ref_ids[-1]
        data = json.dumps(body).encode()
        post = lambda base, path, payload: urllib.request.urlopen(urllib.request.Request(
            base + path, data=payload, headers={"Content-Type": "application/json"}), timeout=120)
        _sse(post(base1, "/v1/chat/completions", data))
        undisturbed = list(ref_ids[0].emitted)
        frames = {}
        faults.configure("engine.dispatch", "delay", at=1, count=0, value=0.05)
        try:
            thread = threading.Thread(
                target=lambda: frames.update(v=_sse(post(base1, "/v1/chat/completions", data))),
                name="test-chat-stream", daemon=True)
            thread.start()
            while len(ref_ids) < 2 or not ref_ids[1].generated:
                time.sleep(0.005)
            summary = json.loads(post(base1, "/internal/drain", b"{}").read())
        finally:
            faults.reset()
        thread.join(60)
        (sid,) = summary["snapshots"]
        assert frames["v"][-1] == "[DONE]"
        last = json.loads(frames["v"][-2])
        assert last["choices"][0]["finish_reason"] == "PREEMPTED"
        assert last["warnings"] == [f"preempted snapshot_id={sid}"]
        listed = json.loads(urllib.request.urlopen(base1 + "/internal/snapshots").read())
        assert [d["snapshot_id"] for d in listed["snapshots"]] == [sid]
        doc = urllib.request.urlopen(f"{base1}/internal/snapshots/{sid}").read()
        with pytest.raises(urllib.error.HTTPError) as missing:
            urllib.request.urlopen(f"{base1}/internal/snapshots/nope")
        assert missing.value.code == 404
        restored = []
        orig_restore = e2.restore_snapshot
        e2.restore_snapshot = lambda snap: restored.append(orig_restore(snap)) or restored[-1]
        resp = post(base2, "/internal/restore", doc)
        assert resp.headers["X-GenAI-Restore"] == f"{sid}; mode=restore"
        out = _sse(resp)
        assert json.loads(out[-1])["choices"][0]["finish_reason"] == "[DONE]"
        assert restored[0][0].emitted == undisturbed
        assert json.loads(post(base1, "/internal/drain", b'{"resume": true}').read()) == \
            {"draining": False}
    finally:
        for server, thread, _ in servers:
            server.shutdown()
            server.server_close()
            thread.join(10)
        e1.shutdown()
        e2.shutdown()
