"""Mesh resolution, the tensor-parallel config and the paths refused under
more than one shard: ``create_mesh`` resolves and refuses as the JAX
package's does (``-1`` takes every device, more shards than devices
raise), ``APP_ENGINE_TENSORPARALLELISM`` is served, heads that do not
divide raise, the automatic pipeline choice of JAX's
``_resolve_parallelism`` raises naming its ROADMAP item, and each engine
path this slice does not carry across shards raises naming ROADMAP queue
1 item 9e."""
import dataclasses

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
        want = dict(jcreate_mesh(tensor_parallelism=tp, devices=jax_devices).shape)["model"]
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            create_mesh(tp, devices=["cpu"] * n_devices)
        assert str(got.value) == str(exc)
        return
    mesh = create_mesh(tp, devices=["cpu"] * n_devices)
    assert mesh.size == want and mesh.shape == {"model": want}
    assert mesh.devices == [torch.device("cpu")] * want and mesh.home == torch.device("cpu")


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
    with pytest.raises(ValueError, match="APP_ENGINE_PIPELINEPARALLELISM=2: .*queue 1 item 9b"):
        EngineConfig.from_env({"APP_ENGINE_PIPELINEPARALLELISM": "2"})


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
    """Where ``num_kv_heads`` caps TP below the device count and the capped
    mesh cannot hold the model, the JAX engine picks pipeline parallelism
    itself; the port raises. With room enough JAX keeps ``-1`` and the
    port serves one card (``-1`` is one card until item 9e)."""
    cfg = EngineConfig(**dict(SMALL, model_config_name="llama3-70b-tiny"))
    model_cfg = llama.PRESETS["llama3-70b-tiny"]
    devices = [torch.device("cpu")] * 16
    assert llm_engine._max_tp(model_cfg, 16) == 8 and llm_engine._pp_supported(model_cfg, 2, 8)
    resolve = LLMEngine._resolve_parallelism
    assert resolve(None, cfg, model_cfg, devices) == 1
    monkeypatch.setattr(llm_engine, "device_memory_bytes", lambda dev: 1.0)
    with pytest.raises(ValueError, match="pipeline_parallelism=2: .*queue 1 item 9b"):
        resolve(None, cfg, model_cfg, devices)
    assert resolve(None, dataclasses.replace(cfg, tensor_parallelism=8), model_cfg, devices) == 8


@pytest.mark.parametrize("field,value,what", [
    ("spec_decode_enable", "on", "speculative decoding's verify"),
    ("spec_draft_model", "debug-draft", "the resident draft model"),
    ("scheduler_policy", "disagg", "the disagg KV handoff"),
])
def test_paths_not_carried_across_shards_raise_at_startup(field, value, what):
    cfg = EngineConfig(**dict(SMALL, kv_layout="paged", **{field: value}))
    with pytest.raises(ValueError, match=f"{what}.* is not served under tensor_parallelism > 1 "
                                         r"yet \(ROADMAP queue 1 item 9e\)"):
        LLMEngine(cfg, mesh=_mesh(2))
    LLMEngine(cfg, device="cpu").shutdown()  # one shard serves it


def test_drain_restore_and_spec_switches_raise_under_tp():
    eng = LLMEngine(EngineConfig(**dict(SMALL, kv_layout="paged")), mesh=_mesh(2))
    try:
        for call, what in ((eng.drain, "drain's KV snapshots"),
                           (lambda: eng.restore_snapshot(None), "snapshot restore"),
                           (lambda: eng.set_spec_decode(True), "speculative decoding"),
                           (lambda: eng.set_spec_proposer("lookup"), "speculative decoding")):
            with pytest.raises(ValueError, match=f"{what} .*queue 1 item 9e"):
                call()
        assert eng.set_spec_decode(False) is False
    finally:
        eng.shutdown()


def test_the_retrieval_tier_refuses_a_sharded_process_engine(monkeypatch):
    """One check on the configuration: a server's start refuses the tier
    beside ``tensor_parallelism`` > 1, and so does the process engine's
    factory before it builds anything; the default ``-1`` (one card)
    serves beside the tier."""
    for key in ("APP_CONFIG_FILE", "APP_ENGINE_TENSORPARALLELISM", "APP_RETRIEVER_BACKEND"):
        monkeypatch.delenv(key, raising=False)
    app = tconfig.AppConfig()
    app.retriever.backend = "tier"
    config_validate.check_tier_shards(app)
    app.engine.tensor_parallelism = 2
    with pytest.raises(ValueError, match=r"retriever.backend=tier .*queue 1 item 9e"):
        config_validate.validate_config(app)
    monkeypatch.setenv("APP_ENGINE_TENSORPARALLELISM", "2")
    monkeypatch.setenv("APP_RETRIEVER_BACKEND", "tier")
    monkeypatch.setattr(llm_engine, "_ENGINE", None)
    with pytest.raises(ValueError, match=r"retriever.backend=tier .*queue 1 item 9e"):
        llm_engine.get_engine(device="cpu")
    assert llm_engine._ENGINE is None


def _two_visible_cpus(monkeypatch):
    """A host that shows two devices, both the CPU, with ``device=None``
    resolving there."""
    monkeypatch.setattr(mesh_mod, "visible_devices", lambda: [torch.device("cpu")] * 2)
    monkeypatch.setattr(llm_engine, "resolve_device", lambda device=None, what="": torch.device("cpu"))


def test_a_default_engine_on_two_visible_devices_serves_one_and_drains(monkeypatch):
    """``tensor_parallelism=-1``, the default, serves one card however many
    are visible, so a default replica's drain and handover work as before
    the port served TP; an explicit 2 shards over both."""
    from generativeaiexamples_tpu_torch.server import api

    _two_visible_cpus(monkeypatch)
    cfg = EngineConfig(**dict(SMALL, kv_layout="paged"))
    assert cfg.tensor_parallelism == -1
    eng = LLMEngine(cfg)
    try:
        assert eng.tp_shards == 1 and eng._tp is None
        status, summary = api.drain_route(b"", eng)
        assert status == 200 and "preempted" in summary
        assert api.drain_route(b'{"resume": true}', eng) == (200, {"draining": False})
    finally:
        eng.shutdown()
    eng = LLMEngine(dataclasses.replace(cfg, tensor_parallelism=2))
    try:
        assert eng.tp_shards == 2 and eng._mesh.devices == [torch.device("cpu")] * 2
    finally:
        eng.shutdown()


def test_the_drain_routes_answer_501_on_a_sharded_engine():
    """Drain and restore on a sharded engine answer 501 naming item 9e,
    never a dropped connection."""
    from generativeaiexamples_tpu_torch.server import api

    eng = LLMEngine(EngineConfig(**dict(SMALL, kv_layout="paged")), mesh=_mesh(2))
    try:
        status, body = api.drain_route(b"", eng)
        assert status == 501 and "queue 1 item 9e" in body["detail"]
        assert not eng._draining
    finally:
        eng.shutdown()
