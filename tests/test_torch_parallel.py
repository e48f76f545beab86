"""Mesh resolution, the tensor-parallel config and the paths served under
more than one shard: ``create_mesh`` resolves and refuses as the JAX
package's does (``-1`` takes every device, more shards than devices
raise), ``APP_ENGINE_TENSORPARALLELISM`` is served, heads that do not
divide raise, the automatic pipeline choice of JAX's
``_resolve_parallelism`` is the port's too, a default
engine takes every visible device, and spec decoding, the resident
draft, ``disagg``, drain, restore, the drain routes and the retrieval
tier serve on a sharded engine."""
import dataclasses
import json
import time
import types

import jax
import pytest
import torch

from generativeaiexamples_tpu.parallel.mesh import create_mesh as jcreate_mesh
from generativeaiexamples_tpu_torch import config as tconfig
from generativeaiexamples_tpu_torch import config_validate
from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import llm_engine
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.parallel import create_mesh, mesh as mesh_mod

SMALL = dict(model_config_name="debug-8dev", dtype="float32", max_batch_size=2, max_seq_len=64,
             prefill_chunk=16, page_size=8)


def _mesh(n):
    return create_mesh(n, devices=["cpu"] * n)


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
@pytest.mark.parametrize("tp", [-1, 1, 2, 4, 8])
def test_create_mesh_resolves_and_refuses_as_jax(n_devices, tp):
    jax_devices = jax.devices()[:n_devices]
    try:
        jmesh = jcreate_mesh(tensor_parallelism=tp, devices=jax_devices)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            create_mesh(tp, devices=["cpu"] * n_devices)
        assert str(got.value) == str(exc)
        return
    want = dict(jmesh.shape)["model"]
    mesh = create_mesh(tp, devices=["cpu"] * n_devices)
    assert mesh.size == want and mesh.shape == dict(jmesh.shape)
    assert mesh.devices == [torch.device("cpu")] * want and mesh.home == torch.device("cpu")


@pytest.mark.parametrize("args", [(2, 2, 2), (4, 2), (1, 1, 8), (-1, 2, 2), (2, 1, 1, 2), (1, 2, 2, 2),
                                  (-1, 3), (2, 2, 4), (-1, 1, 1, 4), (8,)])
def test_create_mesh_takes_jax_s_signature_by_position(args):
    """``create_mesh(tp, dp, sp, pp, devices)`` by position, as JAX's: the
    four axes in JAX's order and sizes, the devices in JAX's order, JAX's
    messages; the accessors pick JAX's coordinates."""
    devices = [torch.device("cpu", i) for i in range(8)]
    try:
        jmesh = jcreate_mesh(*args, devices=jax.devices())
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            create_mesh(*args, devices=devices)
        assert str(got.value) == str(exc)
        return
    mesh = create_mesh(*args, devices=devices)
    assert mesh.shape == dict(jmesh.shape) and list(mesh.shape) == list(jmesh.axis_names)
    grid = jmesh.devices  # [pipe, data, seq, model]
    assert [d.index for d in mesh.devices] == [d.id for d in grid.reshape(-1)]
    for d in range(mesh.data):
        assert [x.index for x in mesh.replica(d).devices] == [x.id for x in grid[:, d].reshape(-1)]
        for s in range(mesh.seq):
            assert [x.index for x in mesh.tp_mesh(d, s).devices] == [x.id for x in grid[0, d, s]]
        assert [x.index for x in mesh.ring(d)] == [x.id for x in grid[0, d, :, 0]]
    for p in range(mesh.pipe):
        assert [x.index for x in mesh.stage(p).devices] == [x.id for x in grid[p].reshape(-1)]


def test_an_engine_refuses_a_training_mesh():
    """The engine serves the ``pipe`` and ``model`` axes; a mesh with data
    replicas or sequence shards is a training mesh and raises."""
    with pytest.raises(ValueError, match="data=2, seq=1"):
        LLMEngine(EngineConfig(**SMALL), mesh=create_mesh(2, 2, devices=["cpu"] * 4))


def test_default_mesh_takes_every_visible_device():
    """No card here: the visible devices are the CPU, one of it."""
    assert mesh_mod.visible_devices() == [torch.device("cpu")]
    assert create_mesh().size == 1
    mesh = create_mesh(-1, devices=["cpu", "cpu", "cpu"])
    assert mesh.size == 3 and mesh.distinct() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="-1 or >= 1"):
        create_mesh(0)


@pytest.mark.parametrize("raw,want", [("-1", -1), ("1", 1), ("2", 2), ("8", 8)])
def test_tensor_parallelism_is_served_from_the_environment(raw, want):
    cfg = EngineConfig.from_env({"APP_ENGINE_TENSORPARALLELISM": raw})
    assert cfg.tensor_parallelism == want
    cfg.validate()


@pytest.mark.parametrize("raw", ["0", "-2"])
def test_tensor_parallelism_below_minus_one_or_zero_is_refused(raw):
    with pytest.raises(ValueError, match=f"APP_ENGINE_TENSORPARALLELISM={raw}: must be -1"):
        EngineConfig.from_env({"APP_ENGINE_TENSORPARALLELISM": raw})
    with pytest.raises(ValueError, match="tensor_parallelism must be -1"):
        EngineConfig(tensor_parallelism=int(raw)).validate()
    app = tconfig.AppConfig()
    app.engine.tensor_parallelism = int(raw)
    with pytest.raises(ValueError, match="engine.tensor_parallelism must be -1"):
        config_validate.validate_config(app)


def test_pipeline_parallelism_stays_refused_naming_its_item():
    """Refused until ROADMAP queue 1 item 9b; now read from
    ``APP_ENGINE_PIPELINEPARALLELISM`` and checked as JAX's
    ``validate_config`` checks it, with JAX's message."""
    from generativeaiexamples_tpu.config import AppConfig as JAppConfig
    from generativeaiexamples_tpu.config import validate as jvalidate

    assert EngineConfig().pipeline_parallelism == 1
    assert EngineConfig.from_env({"APP_ENGINE_PIPELINEPARALLELISM": "2"}).pipeline_parallelism == 2
    for raw in ("0", "-1"):
        app = tconfig.AppConfig()
        app.engine.pipeline_parallelism = int(raw)
        japp = JAppConfig()
        japp = dataclasses.replace(japp, engine=dataclasses.replace(
            japp.engine, pipeline_parallelism=int(raw)))
        with pytest.raises(ValueError) as want:
            jvalidate.validate_config(japp)
        with pytest.raises(ValueError) as got:
            config_validate.validate_config(app)
        assert str(got.value) == str(want.value)
        assert f"engine.pipeline_parallelism must be >= 1, got {raw}" in str(got.value)


def test_more_shards_than_devices_raise_as_jax():
    with pytest.raises(ValueError, match="Mesh wants 2 devices; only 1 available"):
        LLMEngine(EngineConfig(tensor_parallelism=2, **SMALL), device="cpu")


@pytest.mark.parametrize("name,n", [("debug", 4), ("debug-8dev", 3), ("kernel-8dev", 16),
                                    ("llama3-70b-shard8", 2)])
def test_heads_that_do_not_divide_raise(name, n):
    with pytest.raises(ValueError, match=f"tensor_parallelism={n} does not divide {name}"):
        LLMEngine(EngineConfig(**dict(SMALL, model_config_name=name)), mesh=_mesh(n))


def test_an_explicit_mesh_names_the_engine_device():
    with pytest.raises(ValueError, match="not the mesh's first device"):
        LLMEngine(EngineConfig(**SMALL), device="meta", mesh=_mesh(2))


def test_the_automatic_pipeline_choice_raises_naming_item_9b(monkeypatch):
    """Where ``num_kv_heads`` caps TP below the device count (8 of 16 for
    llama3-70b) JAX's fit plan chooses: with room for the capped mesh it
    serves ``(1, 8)`` on 8 devices, and where that mesh cannot hold the
    model, ``pipeline_parallelism=2`` over all 16: ``(2, 8)``. The port
    took all 16 devices, which the heads do not divide, and raised for
    PP; it now returns JAX's values. An explicit TP stays."""
    from generativeaiexamples_tpu_torch.parallel import pp_serving

    cfg = EngineConfig(**dict(SMALL, model_config_name="llama3-70b-tiny"))
    model_cfg = llama.PRESETS["llama3-70b-tiny"]
    devices = [torch.device("cpu")] * 16
    assert pp_serving.max_tp(model_cfg, 16) == 8 and pp_serving.supported(model_cfg, 2, 8)
    resolve = LLMEngine._resolve_parallelism
    roomy = types.SimpleNamespace(_per_device_memory=lambda devs: 16e9)
    tight = types.SimpleNamespace(_per_device_memory=lambda devs: 1.0)
    assert resolve(roomy, cfg, model_cfg, devices) == (1, 8)
    assert resolve(tight, cfg, model_cfg, devices) == (2, 8)
    assert resolve(tight, dataclasses.replace(cfg, tensor_parallelism=8), model_cfg,
                   devices) == (1, 8)


_DRAFT = dict(spec_decode_enable="on", spec_proposer="draft_model")


@pytest.mark.parametrize("field,value,what", [
    ("spec_decode_enable", "on", "speculative decoding's verify"),
    ("spec_draft_model", "debug-8dev", "the resident draft model"),
    ("scheduler_policy", "disagg", "the disagg KV handoff"),
])
def test_paths_carried_across_shards_serve_at_startup(field, value, what):
    """Each path once refused at startup on a sharded engine builds at
    TP=2 and serves a greedy stream equal to the one-shard engine's (the
    draft model drafting as the spec proposer, on its shards)."""
    extra = _DRAFT if field == "spec_draft_model" else {}
    cfg = EngineConfig(**dict(SMALL, kv_layout="paged", **{field: value}, **extra))
    prompt, params = [5, 9, 13, 200] * 4, llm_engine.SamplingParams(temperature=0.0, max_tokens=8)
    streams = []
    for kw in (dict(mesh=_mesh(2)), dict(device="cpu")):
        eng = LLMEngine(cfg, **kw)
        try:
            if field == "spec_draft_model":
                assert eng._draft.shards == eng.tp_shards, what
            if field == "scheduler_policy":
                assert eng.scheduler.kind == "disagg", what
            streams.append(list(eng.iter_ids(prompt, params, timeout=120)))
        finally:
            eng.shutdown()
    assert streams[0] == streams[1], what


def test_drain_restore_and_spec_switches_serve_under_tp(tmp_path):
    """On a TP=2 engine the spec switches take effect, a drain returns its
    summary and the spooled document restores on the same engine."""
    from generativeaiexamples_tpu_torch.engine import request_snapshot as rs
    from generativeaiexamples_tpu_torch.utils import faults

    eng = LLMEngine(EngineConfig(**dict(SMALL, kv_layout="paged",
                                        snapshot_spool_dir=str(tmp_path))), mesh=_mesh(2))
    try:
        assert eng.set_spec_decode(True) is True
        assert eng.set_spec_proposer("lookup") == "lookup"
        assert eng.set_spec_decode(False) is False
        faults.configure("engine.dispatch", "delay", at=1, count=0, value=0.05)
        try:
            req = eng.submit([5, 9, 13, 200] * 4,
                             llm_engine.SamplingParams(temperature=0.0, max_tokens=16))
            while not req.generated:
                time.sleep(0.005)
            summary = eng.drain()
        finally:
            faults.reset()
        assert summary["spooled"] == 1
        eng.resume_from_drain()
        snap = rs.RequestSnapshot.from_doc(eng.snapshot_spool.load_doc(req.error.snapshot_id))
        assert snap.geometry["num_kv_heads"] == llama.PRESETS["debug-8dev"].num_kv_heads
        new, _, prior, mode = eng.restore_snapshot(snap)
        assert mode == "restore" and prior
        while new.out_queue.get(timeout=60) is not None:
            pass
        assert new.error is None and new.generated == 16
    finally:
        eng.shutdown()


def test_the_retrieval_tier_serves_beside_a_sharded_process_engine(monkeypatch):
    """The configuration check is gone: a server's start accepts the tier
    beside ``tensor_parallelism`` > 1, and the process engine's factory
    builds the sharded engine (two visible devices, the CPU twice), whose
    scheduler answers the tier's retrieval window."""
    for key in ("APP_CONFIG_FILE", "APP_ENGINE_TENSORPARALLELISM", "APP_RETRIEVER_BACKEND"):
        monkeypatch.delenv(key, raising=False)
    app = tconfig.AppConfig()
    app.retriever.backend = "tier"
    app.engine.tensor_parallelism = 2
    config_validate.validate_config(app)
    _two_visible_cpus(monkeypatch)
    for key, value in {"APP_ENGINE_TENSORPARALLELISM": "2", "APP_RETRIEVER_BACKEND": "tier",
                       "APP_ENGINE_MODELCONFIGNAME": "debug-8dev", "APP_ENGINE_DTYPE": "float32",
                       "APP_ENGINE_MAXSEQLEN": "64", "APP_ENGINE_PREFILLCHUNK": "16",
                       "APP_ENGINE_PAGESIZE": "8", "APP_ENGINE_MAXBATCHSIZE": "2"}.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(llm_engine, "_ENGINE", None)
    eng = llm_engine.get_engine()
    try:
        assert eng.tp_shards == 2 and llm_engine._ENGINE is eng
        assert eng.scheduler.retrieval_window(1.0) is True
    finally:
        eng.shutdown()


def _two_visible_cpus(monkeypatch):
    """A host that shows two devices, both the CPU, with ``device=None``
    resolving there."""
    monkeypatch.setattr(mesh_mod, "visible_devices", lambda: [torch.device("cpu")] * 2)
    monkeypatch.setattr(llm_engine, "resolve_device", lambda device=None, what="": torch.device("cpu"))


def test_a_default_engine_on_two_visible_devices_takes_both_and_drains(monkeypatch):
    """``tensor_parallelism=-1``, the default, takes every visible device,
    as JAX's does, and a default replica's drain works on its shards; an
    explicit 1 serves one."""
    from generativeaiexamples_tpu_torch.server import api

    _two_visible_cpus(monkeypatch)
    cfg = EngineConfig(**dict(SMALL, kv_layout="paged"))
    assert cfg.tensor_parallelism == -1
    eng = LLMEngine(cfg)
    try:
        assert eng.tp_shards == 2 and eng._tp is not None
        assert eng._mesh.devices == [torch.device("cpu")] * 2
        status, summary = api.drain_route(b"", eng)
        assert status == 200 and "preempted" in summary
        assert api.drain_route(b'{"resume": true}', eng) == (200, {"draining": False})
    finally:
        eng.shutdown()
    eng = LLMEngine(dataclasses.replace(cfg, tensor_parallelism=1))
    try:
        assert eng.tp_shards == 1 and eng._tp is None
    finally:
        eng.shutdown()


def test_the_drain_routes_answer_200_on_a_sharded_engine(tmp_path):
    """Drain and restore on a sharded engine answer as on one shard: the
    drain's summary, and the restore's 200 with its stream."""
    from generativeaiexamples_tpu_torch.server import api
    from generativeaiexamples_tpu_torch.utils import faults

    eng = LLMEngine(EngineConfig(**dict(SMALL, kv_layout="paged",
                                        snapshot_spool_dir=str(tmp_path))), mesh=_mesh(2))
    try:
        faults.configure("engine.dispatch", "delay", at=1, count=0, value=0.05)
        try:
            req = eng.submit([7, 8, 9] * 5,
                             llm_engine.SamplingParams(temperature=0.0, max_tokens=16))
            while not req.generated:
                time.sleep(0.005)
            status, body = api.drain_route(b"", eng)
        finally:
            faults.reset()
        assert status == 200 and body["spooled"] == 1 and eng._draining
        assert api.drain_route(b'{"resume": true}', eng) == (200, {"draining": False})
        doc = eng.snapshot_spool.load_doc(body["snapshots"][0])
        status, headers, frames = api.restore_route(json.dumps(doc).encode(), eng)
        assert status == 200 and "mode=restore" in str(headers)
        out = b"".join(f if isinstance(f, bytes) else f.encode() for f in frames)
        assert b"[DONE]" in out
    finally:
        eng.shutdown()
