"""Pipeline-parallel serving's stage walk (parallel/pp_serving.py) against
the JAX package's, on the tiny config of tests/test_pp_serving.py: the
port walks the stages in order on a (pipe, model) mesh of ``cpu`` devices
(its kernels' plain versions); JAX runs its ``shard_map`` program over
the 8 virtual CPU devices, and its single-device ``llama.prefill`` /
``decode_step`` are the ground truth.

Tolerances.
- f32 weights: JAX's own bound, 2e-4 on the logits of the prefill and of
  every greedy decode step, at (stages, tp) = (2, 1), (4, 1), (2, 2); and
  the walk is the port's one-device (or TP) function bit for bit, since
  it runs the same operations on the same devices in the same order.
- int8 KV: both quantize each row per (token, head) as the JAX codec does
  and attend the dequantized strip; greedy tokens equal the f32
  reference's and logits stay within INT8_KV_TOL of JAX's PP program.
- int8 packs in the per-shard layout: the port's plain product is its
  kernel's (activations rounded to bf16, the scale after the f32 sum),
  JAX's PP program runs ``int8_matmul_xla`` (dequantized in the
  activations' f32): queue 3's "two int8 numerics", 0.028 on these
  logits; logits within INT8_PACK_TOL of JAX's PP program, greedy tokens
  equal where the reference's top-1 margin exceeds it.

JAX's PP program is compiled 6 times here (3 pairs of prefill and
decode), so the file stays in the fast tier.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.ops import quant as jquant
from generativeaiexamples_tpu.parallel import pp_serving as jpp
from generativeaiexamples_tpu.parallel.mesh import create_mesh as jcreate_mesh
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.models.convert import params_from_jax
from generativeaiexamples_tpu_torch.parallel import create_mesh, pp_serving, sharding, tp_kernels

_DIMS = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=4, num_heads=4,
             num_kv_heads=2, head_dim=16, max_seq_len=64)
JCFG = jl.LlamaConfig(**_DIMS)
TCFG = tl.LlamaConfig(**_DIMS)
S = 32  # cache rows a slot
PROMPT = np.array([[1, 17, 93, 5, 64], [2, 9, 120, 77, 31]], np.int32)
N_DECODE = 3
ATOL = 2e-4
INT8_KV_TOL = 2e-3
INT8_PACK_TOL = 0.05


@pytest.fixture(scope="module")
def jparams():
    return jl.init_params_fast(JCFG, seed=3, dtype=jnp.float32)


@pytest.fixture(scope="module")
def golden(jparams):
    """JAX's single-device prefill and greedy decode: the logits of each
    step (the numerics ground truth of tests/test_pp_serving.py)."""
    B, T = PROMPT.shape
    cache = jl.init_kv_cache(JCFG, B, S, jnp.float32)
    last, cache = jl.prefill(jparams, JCFG, jnp.asarray(PROMPT), jnp.full((B,), T, jnp.int32),
                             cache, use_flash=False)
    out = [np.asarray(last)]
    tok, pos = jnp.argmax(last, axis=-1).astype(jnp.int32), jnp.full((B,), T, jnp.int32)
    for _ in range(N_DECODE):
        logits, cache = jl.decode_step(jparams, JCFG, tok, pos, cache)
        out.append(np.asarray(logits))
        tok, pos = jnp.argmax(logits, axis=-1).astype(jnp.int32), pos + 1
    return out


def _jax_pp(params, stages, tp, kv_quant=False, n_decode=N_DECODE):
    """JAX's PP x TP program: prefill, then greedy decode steps."""
    mesh = jcreate_mesh(tensor_parallelism=tp, pipeline_parallelism=stages,
                        devices=jax.devices()[: stages * tp])
    ctx = jpp.PPContext(mesh=mesh, stages=stages, tp=tp)
    staged = jpp.stage_params(params, ctx)
    B, T = PROMPT.shape
    cache = jpp.init_cache(JCFG, ctx, B, S, jnp.float32, quantized=kv_quant)
    last, cache = jax.jit(jpp.build_prefill(JCFG, ctx))(
        staged, cache, jnp.asarray(PROMPT), jnp.full((B,), T, jnp.int32), jnp.arange(B, dtype=jnp.int32))
    out = [np.asarray(last)]
    decode = jax.jit(jpp.build_decode_step(JCFG, ctx))
    tok, pos = jnp.argmax(last, axis=-1).astype(jnp.int32), jnp.full((B,), T, jnp.int32)
    for _ in range(n_decode):
        logits, cache = decode(staged, cache, tok, pos)
        out.append(np.asarray(logits))
        tok, pos = jnp.argmax(logits, axis=-1).astype(jnp.int32), pos + 1
    return out


def _ctx(stages, tp, quant_kernel=None):
    mesh = create_mesh(tp, stages, devices=["cpu"] * (stages * tp))
    return pp_serving.PPContext(mesh, stages, tp, quant_kernel=quant_kernel)


def _torch_pp(params, stages, tp, kv_quant=False, n_decode=N_DECODE, quant_kernel=None):
    """The port's stage walk: prefill, then greedy decode steps, from a
    single-device tree laid out per stage."""
    ctx = _ctx(stages, tp, quant_kernel)
    staged = pp_serving.stage_params(params, ctx, repack_cfg=TCFG)
    B, T = PROMPT.shape
    cache = pp_serving.init_cache(TCFG, ctx, B, S, torch.float32, quantized=kv_quant)
    with torch.inference_mode():
        last, cache = pp_serving.build_prefill(TCFG, ctx)(
            staged, cache, torch.from_numpy(PROMPT).long(), torch.full((B,), T), torch.arange(B))
        out = [last.numpy().copy()]
        decode = pp_serving.build_decode_step(TCFG, ctx)
        tok, pos = torch.argmax(last, dim=-1), torch.full((B,), T)
        for _ in range(n_decode):
            logits, cache = decode(staged, cache, tok, pos)
            out.append(logits.numpy().copy())
            tok, pos = torch.argmax(logits, dim=-1), pos + 1
    return out


@pytest.mark.parametrize("stages,tp", [(2, 1), (4, 1), (2, 2)])
def test_stage_walk_matches_jax_within_its_bound(jparams, golden, stages, tp):
    """Prefill and 3 greedy decode steps through the port's PP x TP walk
    equal JAX's single-device logits within JAX's own bound; at (2, 2)
    JAX's PP program is held too."""
    got = _torch_pp(params_from_jax(jparams), stages, tp)
    refs = [("single device", golden)]
    if (stages, tp) == (2, 2):
        refs.append(("JAX's PP program", _jax_pp(jparams, stages, tp)))
    for what, ref in refs:
        for step, (r, g) in enumerate(zip(ref, got)):
            np.testing.assert_allclose(g, r, atol=ATOL, rtol=ATOL,
                                       err_msg=f"{what}, step {step} ({stages} x {tp})")


@pytest.mark.parametrize("stages,tp", [(2, 1), (2, 2)])
def test_stage_walk_is_the_one_stage_function_bit_for_bit(jparams, stages, tp):
    """The walk runs the same operations as ``prefill_layers`` and
    ``decode_layers`` (at TP=``tp`` over the same devices), so its logits
    and caches are theirs bit for bit."""
    params = params_from_jax(jparams)
    got = _torch_pp(params, stages, tp)
    tpc = None
    if tp > 1:
        mesh = create_mesh(tp, devices=["cpu"] * tp)
        tpc = tp_kernels.TPContext(mesh, tp)
        params = sharding.shard_params(params, mesh, repack_cfg=TCFG)
    B, T = PROMPT.shape
    caches = tl.init_kv_cache_layers(TCFG, B, S, torch.float32, tp=tpc)
    with torch.inference_mode():
        last, kvs = tl.prefill_layers(params, TCFG, torch.from_numpy(PROMPT).long(),
                                      torch.full((B,), T), tp=tpc)
        tl.write_prefill_slots(caches, kvs, torch.arange(B), tp=tpc)
        want = [last.numpy().copy()]
        tok, pos = torch.argmax(last, dim=-1), torch.full((B,), T)
        for _ in range(N_DECODE):
            logits, caches = tl.decode_layers(params, TCFG, tok, pos, caches, tp=tpc)
            want.append(logits.numpy().copy())
            tok, pos = torch.argmax(logits, dim=-1), pos + 1
    for step, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"step {step}")


def test_stage_walk_int8_kv_matches_jax(jparams, golden):
    """int8 fixed caches (head-major rows, per-(token, head) scales) at
    (2, 1) and (2, 2): greedy tokens equal the f32 reference's at every
    step, logits within INT8_KV_TOL of JAX's PP program at (2, 1)."""
    jax_q = _jax_pp(jparams, 2, 1, kv_quant=True)
    for stages, tp in ((2, 1), (2, 2)):
        got = _torch_pp(params_from_jax(jparams), stages, tp, kv_quant=True)
        for step, (r, g, q) in enumerate(zip(golden, got, jax_q)):
            assert np.array_equal(np.argmax(r, -1), np.argmax(g, -1)), (stages, tp, step)
            np.testing.assert_allclose(g, q, atol=INT8_KV_TOL, err_msg=f"step {step} ({stages} x {tp})")


def test_stage_walk_int8_packs_per_shard_match_jax(jparams, golden):
    """Per-shard int8 packs at (2, 2), laid out by the port from its own
    single-device quantization: logits within INT8_PACK_TOL of JAX's PP
    program on JAX's per-shard packs of the same weights; greedy tokens
    equal the f32 reference's where its top-1 margin exceeds the bound."""
    from generativeaiexamples_tpu_torch.ops import quant as tquant

    packed = jquant.quantize_params_int8(dict(jparams), tp_shards=2)
    want = _jax_pp(packed, 2, 2, n_decode=1)
    mine = tquant.quantize_params_int8(params_from_jax(jparams))
    got = _torch_pp(mine, 2, 2, n_decode=1)
    for step, (r, g, w) in enumerate(zip(golden, got, want)):
        np.testing.assert_allclose(g, w, atol=INT8_PACK_TOL, err_msg=f"step {step}")
        top2 = np.sort(r, -1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > INT8_PACK_TOL
        assert np.array_equal(np.argmax(r, -1)[sure], np.argmax(g, -1)[sure]), step


def test_supported_and_max_tp_are_jax_s():
    for stages in (1, 2, 3, 4):
        for tp in (1, 2, 4):
            assert pp_serving.supported(TCFG, stages, tp) == jpp.supported(JCFG, stages, tp)
    for n in (1, 2, 4, 8, 16):
        assert pp_serving.max_tp(TCFG, n) == jpp.max_tp(JCFG, n)
    assert pp_serving.max_tp(tl.PRESETS["llama3-70b"], 16) == 8


def test_stage_params_place_each_layer_on_its_stage():
    """Layer i on stage i // (L / stages): whole on a one-shard stage's
    device, cut over the stage's shards otherwise; the head over stage
    0's shards, the embedding whole on its home."""
    from generativeaiexamples_tpu_torch.ops import quant as tquant

    ctx = _ctx(2, 2)
    params = tquant.init_packed_params_int8(TCFG, seed=1, dtype=torch.float32)
    staged = pp_serving.stage_params(params, ctx, repack_cfg=TCFG)
    assert len(staged["layers"]) == TCFG.num_layers and sharding.is_sharded(staged)
    assert all(isinstance(lp["wq"], sharding.Shards) and len(lp["wq"]) == 2 for lp in staged["layers"])
    assert isinstance(staged["lm_head"], sharding.Shards) and len(staged["lm_head"]) == 2
    assert [lp["wq"][1]["q"].device for lp in staged["layers"]] == [torch.device("cpu")] * 4
    assert ctx.mesh.stage(1).devices == [torch.device("cpu")] * 2 and ctx.tps[1].shards == 2
    cache = pp_serving.init_cache(TCFG, ctx, 2, S, torch.float32, quantized=True)
    assert len(cache) == TCFG.num_layers
    assert cache[0][0]["k"].shape == (2, TCFG.num_kv_heads // 2, S, TCFG.head_dim)
    assert cache[3][1]["ks"].shape == (2, TCFG.num_kv_heads // 2, 1, S)
    with pytest.raises(ValueError, match="PPContext"):
        pp_serving.PPContext(ctx.mesh, 4, 1)


def test_each_stage_runs_inside_its_home_card_scope(jparams, monkeypatch):
    """The kernels' ctypes wrappers launch on the thread's current CUDA
    device, so each stage's layers and cache writes run inside its home's
    device scope (``torch.cuda.device`` of a card, whose construction needs
    no card), and stage 0's head inside stage 0's, in prefill and decode."""
    cards = pp_serving.PPContext(create_mesh(1, 2, devices=["cuda:0", "cuda:1"]), 2, 1)
    for s in (0, 1):
        scope = pp_serving._stage_scope(cards, s)
        assert isinstance(scope, torch.cuda.device) and scope.idx == s
    assert isinstance(pp_serving._stage_scope(_ctx(2, 1), 1), contextlib.nullcontext)

    inside, calls = [], []

    @contextlib.contextmanager
    def scope(ctx, s):
        inside.append(s)
        try:
            yield
        finally:
            inside.pop()

    def recorded(name):
        fn = getattr(tl, name)

        def wrapper(*args, **kwargs):
            calls.append((name, inside[-1] if inside else None))
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(pp_serving, "_stage_scope", scope)
    for name in ("prefill_stage", "write_prefill_slots", "decode_stage", "_head"):
        monkeypatch.setattr(tl, name, recorded(name))
    _torch_pp(params_from_jax(jparams), 2, 1, n_decode=1)
    assert calls == [("prefill_stage", 0), ("write_prefill_slots", 0), ("prefill_stage", 1),
                     ("write_prefill_slots", 1), ("_head", 0),
                     ("decode_stage", 0), ("decode_stage", 1), ("_head", 0)]
