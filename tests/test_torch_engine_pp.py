"""Pipeline-parallel serving through the port's engine
(engine/llm_engine.py, parallel/pp_serving.py) on ``cpu`` stages, the
JAX package's tests/test_engine_pp.py carried over and widened:

- the fit plan, ``_resolve_parallelism``, equals JAX's at every branch on
  the same inputs (JAX's 8 virtual CPU devices, a stub ``self`` for its
  per-device memory; the port's on 8 ``cpu`` devices): explicit stages
  win, an explicit or a one-device TP stays, a cap that fails its checks
  keeps -1, a capped mesh too small for the estimate resolves to
  ``(n // cap, cap)`` and one that fits to ``(1, cap)``;
- PP=2, PP=4 and PP=2 x TP=2 engines stream the same greedy tokens as
  the TP=1 engine on the same weights (dense f32; int8 packs over int8
  strips), and a seeded sampled row the same tokens as the one-stage
  engine of the stages' TP (the sampler runs on stage 0's home from the
  same logits);
- every refusal of the PP path carries JAX's message: ``kv_layout``
  paged, ``kv_cache_dtype`` int4, ``scheduler_policy`` disagg, stages that
  do not divide the layers, a mesh that does not divide the model;
- what JAX leaves out on its PP path the port leaves out: chunked
  prefill (a prompt longer than ``prefill_chunk`` is one wave), the
  prefix cache and speculative decoding; drain preempts replay-only and
  the replay equals the undisturbed stream;
- ``APP_ENGINE_PIPELINEPARALLELISM=2`` builds a PP engine over the
  visible devices, the automatic choice on a tight budget serves PP;
- a checkpoint streamed into PP x TP (``load_params_pp_streaming``) is
  byte-equal to the layered load cut into stages and serves its streams.
"""
import dataclasses
import types

import jax
import pytest
import torch

from generativeaiexamples_tpu.config import EngineConfig as JEngineConfig
from generativeaiexamples_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import llm_engine
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
from generativeaiexamples_tpu_torch.models import hf_loader, llama
from generativeaiexamples_tpu_torch.parallel import create_mesh, mesh as mesh_mod, pp_serving
from generativeaiexamples_tpu_torch.parallel.sharding import Shards
from generativeaiexamples_tpu_torch.utils import faults
from generativeaiexamples_tpu_torch.utils.resilience import RequestPreempted

_DIMS = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=4, num_heads=4,
             num_kv_heads=2, head_dim=16, max_seq_len=64)
TINY = dict(model_config_name="pp-tiny", max_batch_size=2, max_seq_len=64, prefill_chunk=16,
            decode_block=2, dtype="float32")
PROMPTS = [[1, 17, 93, 5, 64], [3, 9, 27, 81, 2, 6, 18, 54, 33, 99, 11, 44, 7, 21, 63, 120, 5, 15]]
GREEDY = SamplingParams(temperature=0.0, max_tokens=8)
SEEDED = SamplingParams(temperature=0.8, top_p=0.9, max_tokens=8, seed=7)


@pytest.fixture(scope="module", autouse=True)
def _preset():
    """A preset whose two KV heads cap TP at 2, so PP is the only way to
    use more devices (JAX's ``tiny`` of tests/test_engine_pp.py)."""
    llama.PRESETS["pp-tiny"] = llama.LlamaConfig(**_DIMS)
    yield
    llama.PRESETS.pop("pp-tiny", None)


def _mesh(stages, tp):
    return create_mesh(tp, pipeline_parallelism=stages, devices=["cpu"] * (stages * tp))


def _streams(eng, prompts=PROMPTS, params=GREEDY):
    with eng.hold_admissions():
        queues = [eng.generate_ids(p, params) for p in prompts]
    return [list(_drain(q)) for q in queues]


def _drain(q):
    while True:
        item = q.get(timeout=120)
        if item is None:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _serve(cfg, params=None, prompts=PROMPTS, sampling=GREEDY, **kw):
    eng = LLMEngine(cfg, params=params, **kw)
    try:
        return _streams(eng, prompts, sampling), eng
    finally:
        eng.shutdown()


# ------------------------------------------------------------------ //
# part 0: the fit plan is JAX's


_KV4 = dict(_DIMS, num_kv_heads=4)  # the cap (4) bites at 8 devices


@pytest.mark.parametrize("dims,pp,tp,n_dev,budget", [
    (_KV4, 1, -1, 8, 16e9),  # the capped mesh fits: (1, cap)
    (_KV4, 1, -1, 8, 1.0),  # too small for the estimate: (n // cap, cap)
    (_KV4, 2, -1, 8, 16e9),  # explicit stages win, tp the rest
    (_KV4, 2, 2, 8, 16e9),
    (_KV4, 3, -1, 8, 16e9),  # stages that do not divide the layers raise
    (_KV4, 1, 4, 8, 1.0),  # an explicit tp stays
    (_KV4, 1, -1, 1, 1.0),  # one device
    (dict(_KV4, num_kv_heads=8, num_heads=8), 1, -1, 8, 1.0),  # no cap below n: keeps -1
    (dict(_KV4, num_layers=3), 1, -1, 8, 1.0),  # auto stages do not divide: keeps -1
])
def test_resolve_parallelism_is_jax_s_at_every_branch(monkeypatch, dims, pp, tp, n_dev, budget):
    """The part that was wrong before: with room for the capped mesh JAX
    serves ``(1, tp_cap)`` on ``tp_cap`` devices; the port took every
    device, which the heads do not divide."""
    jcfg = JEngineConfig(tensor_parallelism=tp, pipeline_parallelism=pp, max_batch_size=2,
                         max_seq_len=64)
    tcfg = EngineConfig(tensor_parallelism=tp, pipeline_parallelism=pp, max_batch_size=2,
                        max_seq_len=64)
    devices = jax.devices()[:n_dev]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices)
    jself = types.SimpleNamespace(_per_device_hbm=lambda: budget)
    tself = types.SimpleNamespace(_per_device_memory=lambda devs: budget)
    try:
        want = JLLMEngine._resolve_parallelism(jself, jcfg, jl.LlamaConfig(**dims))
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            LLMEngine._resolve_parallelism(tself, tcfg, llama.LlamaConfig(**dims), ["cpu"] * n_dev)
        assert str(got.value) == str(exc)
        return
    got = LLMEngine._resolve_parallelism(tself, tcfg, llama.LlamaConfig(**dims), ["cpu"] * n_dev)
    assert got == want


# ------------------------------------------------------------------ //
# streams


@pytest.mark.parametrize("stages,tp", [(2, 1), (4, 1), (2, 2)])
@pytest.mark.parametrize("recipe", [dict(), dict(quantization="int8", kv_cache_dtype="int8")])
def test_pp_engine_streams_equal_the_one_device_engine_s(stages, tp, recipe):
    """Greedy rows (one prompt longer than ``prefill_chunk``, prefilled
    in the same single wave): the same tokens as the TP=1 engine on the
    same single-device weights, laid out per stage. A seeded sampled row:
    the same tokens as the one-stage engine of the stages' ``tp`` (the
    walk is that engine's function bit for bit; TP=2 itself rounds each
    int8 partial, so a sampled row may part from TP=1's)."""
    cfg = EngineConfig(**TINY, **recipe)
    ref_eng = LLMEngine(dataclasses.replace(cfg, tensor_parallelism=1), device="cpu")
    try:
        want = _streams(ref_eng)
    finally:
        ref_eng.shutdown()
    params = ref_eng.params
    tp_eng = LLMEngine(dataclasses.replace(cfg, tensor_parallelism=tp), params=params,
                       mesh=create_mesh(tp, devices=["cpu"] * tp))
    try:
        want_seeded = _streams(tp_eng, PROMPTS[:1], SEEDED)
    finally:
        tp_eng.shutdown()
    eng = LLMEngine(dataclasses.replace(cfg, tensor_parallelism=tp, pipeline_parallelism=stages),
                    params=params, mesh=_mesh(stages, tp))
    try:
        assert eng._pp is not None and (eng._pp.stages, eng._pp.tp) == (stages, tp)
        assert not eng._paged and eng.tp_shards == tp and eng.stats()["pp_stages"] == stages
        assert eng._kv_quant == (recipe.get("kv_cache_dtype") == "int8")
        got = _streams(eng)
        got_seeded = _streams(eng, PROMPTS[:1], SEEDED)
        stats = eng.stats()
    finally:
        eng.shutdown()
    assert got == want and got_seeded == want_seeded
    assert all(len(s) == GREEDY.max_tokens for s in got)
    # one monolithic wave a prompt, never a chunk: JAX's PP path has none
    assert stats["prefill_chunks"] == 0 and stats["requests_prefilled"] == 3


def test_pp_engine_builds_neither_prefix_cache_nor_spec_and_drains_replay_only(tmp_path):
    from tests.test_torch_drain_restore import _drain_mid_decode, _finish, _throttled_wave

    cfg = EngineConfig(**dict(TINY, max_batch_size=2), pipeline_parallelism=2, tensor_parallelism=1,
                       spec_decode_enable="on", snapshot_spool_dir=str(tmp_path / "spool"))
    eng = LLMEngine(cfg, mesh=_mesh(2, 1))
    params = [SamplingParams(temperature=0.0, max_tokens=24), SEEDED]
    try:
        assert eng._prefix is None and eng._prefix_store is None
        assert not eng._spec_available and not eng._spec_enabled and eng._spec_proposer is None
        assert eng.set_spec_decode(True) is False and eng.set_spec_proposer("lookup") is None
        ref = _finish(_throttled_wave(eng, PROMPTS, params))
        faults.reset()
        reqs = _throttled_wave(eng, PROMPTS, params)
        summary = _drain_mid_decode(eng, reqs)
        assert summary["parked"] and summary["spooled"] == 0 and summary["replay_only"] == 2
        assert all(isinstance(r.error, RequestPreempted) and r.error.snapshot_id is None
                   for r in reqs)
        eng.resume_from_drain()
        from generativeaiexamples_tpu_torch.engine import request_snapshot as rs

        for req, want in zip(reqs, ref):
            new, _, prior, mode = eng.restore_snapshot(rs.capture(eng, req, 0, ()))
            assert (mode, prior) == ("replay", [])
            assert _finish([new]) == [want]
    finally:
        faults.reset()
        eng.shutdown()


# ------------------------------------------------------------------ //
# refusals, JAX's messages


@pytest.mark.parametrize("overrides,message", [
    (dict(kv_layout="paged", page_size=8),
     "kv_layout='paged' is not supported on the pipeline-parallel serving path; use "
     "kv_layout='fixed' (the PP stage caches keep the dense per-slot layout)"),
    (dict(kv_cache_dtype="int4"),
     "kv_cache_dtype='int4' requires the paged KV layout, which the pipeline-parallel serving "
     "path does not support; use kv_cache_dtype='int8'"),
    (dict(scheduler_policy="disagg"),
     "scheduler_policy='disagg' is not supported on the pipeline-parallel serving path "
     "(use 'unified')"),
])
def test_pp_refusals_carry_jax_s_messages(overrides, message):
    cfg = EngineConfig(**TINY, pipeline_parallelism=2, tensor_parallelism=1, **overrides)
    with pytest.raises(ValueError) as got:
        LLMEngine(cfg, mesh=_mesh(2, 1))
    assert str(got.value) == message


def test_stages_or_a_mesh_that_do_not_divide_raise_as_jax():
    with pytest.raises(ValueError, match=r"pipeline_parallelism=3 x tensor_parallelism=1 does not "
                                         r"divide this architecture \(layers=4, kv_heads=2\)"):
        LLMEngine(EngineConfig(**TINY, pipeline_parallelism=3, tensor_parallelism=1), device="cpu")
    with pytest.raises(ValueError, match=r"mesh pipe=2 x model=4 does not divide this architecture"):
        LLMEngine(EngineConfig(**TINY), mesh=_mesh(2, 4))


# ------------------------------------------------------------------ //
# the environment and the automatic choice


def _visible_cpus(monkeypatch, n):
    monkeypatch.setattr(mesh_mod, "visible_devices", lambda: [torch.device("cpu")] * n)
    monkeypatch.setattr(llm_engine, "resolve_device",
                        lambda device=None, what="": torch.device("cpu"))


def test_pipeline_parallelism_from_the_environment_builds_a_pp_engine(monkeypatch):
    _visible_cpus(monkeypatch, 4)
    env = {"APP_ENGINE_PIPELINEPARALLELISM": "2", "APP_ENGINE_MODELCONFIGNAME": "pp-tiny",
           "APP_ENGINE_MAXBATCHSIZE": "2", "APP_ENGINE_MAXSEQLEN": "64",
           "APP_ENGINE_PREFILLCHUNK": "16", "APP_ENGINE_DECODEBLOCK": "2",
           "APP_ENGINE_DTYPE": "float32"}
    cfg = EngineConfig.from_env(env)
    assert cfg.pipeline_parallelism == 2 and cfg.tensor_parallelism == -1
    got, eng = _serve(cfg)
    assert (eng._pp.stages, eng._pp.tp, eng._mesh.size) == (2, 2, 4)
    want, _ = _serve(dataclasses.replace(cfg, pipeline_parallelism=1, tensor_parallelism=1),
                     params=None, device="cpu")
    assert got == want


def test_the_automatic_choice_on_a_tight_budget_serves_pp(monkeypatch):
    """Four visible devices, two KV heads (TP capped at 2) and a budget
    the capped mesh cannot hold: JAX's planner picks PP=2 x TP=2 over all
    four, and the engine serves it; with room it keeps TP=2 on two."""
    _visible_cpus(monkeypatch, 4)
    cfg = EngineConfig(**TINY)
    monkeypatch.setattr(LLMEngine, "_per_device_memory", lambda self, devices: 1.0)
    got, eng = _serve(cfg)
    assert (eng._pp.stages, eng._pp.tp) == (2, 2)
    monkeypatch.setattr(LLMEngine, "_per_device_memory", lambda self, devices: 16e9)
    roomy, eng = _serve(cfg)
    assert eng._pp is None and eng.tp_shards == 2 and eng._mesh.size == 2
    want, _ = _serve(dataclasses.replace(cfg, tensor_parallelism=1), device="cpu")
    assert got == want == roomy


# ------------------------------------------------------------------ //
# the streamed stage loader


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple, Shards)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("stages,tp", [(2, 1), (2, 2)])
@pytest.mark.parametrize("quantization", ["int8", "none"])
def test_pp_streaming_load_is_the_layered_load_cut_into_stages(tmp_path, stages, tp, quantization):
    cfg = llama.PRESETS["pp-tiny"]
    ckpt = str(tmp_path / "ckpt")
    hf_loader.write_hf_checkpoint(cfg, ckpt, seed=11, n_shards=2)
    ctx = pp_serving.PPContext(_mesh(stages, tp), stages, tp)
    stats = {}
    got = hf_loader.load_params_pp_streaming(ckpt, cfg, torch.float32, quantization=quantization,
                                             ctx=ctx, stats=stats)
    layered = hf_loader.load_params_layered_streaming(
        ckpt, cfg, torch.float32, quantization=quantization,
        tp_shards=tp if quantization != "none" else 1)
    want = pp_serving.stage_params(layered, ctx, repack_cfg=None if quantization != "none" else cfg)
    got_leaves, want_leaves = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype and a.device == b.device, path
        assert a.numpy().tobytes() == b.numpy().tobytes(), path
    assert stats["peak_host_bytes"] > 0


def test_pp_engine_streams_a_checkpoint_as_the_one_device_engine(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    hf_loader.write_hf_checkpoint(llama.PRESETS["pp-tiny"], ckpt, seed=11, n_shards=2)
    cfg = EngineConfig(**TINY, checkpoint_path=ckpt, quantization="int8")
    want, _ = _serve(dataclasses.replace(cfg, tensor_parallelism=1), device="cpu")
    got, eng = _serve(dataclasses.replace(cfg, tensor_parallelism=2, pipeline_parallelism=2),
                      mesh=_mesh(2, 2))
    assert eng._pp is not None and eng.load_stats["peak_host_bytes"] > 0
    assert got == want
