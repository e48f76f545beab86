"""Sharded training (models/train.py on a mesh) against the JAX package's
sharded steps and the port's own one-device step, at the ``debug-8dev``
preset and f32 on the CPU:

- the LoRA step (all seven targets, so row- and column-parallel adapters
  both) and the SFT step on ``tp=4, dp=2`` and on ``tp=2, dp=2, sp=2``
  meshes of ``cpu`` shards, each against JAX's jitted step on
  ``create_mesh`` of the same shape (conftest's 8 virtual devices, the
  base cut by ``shard_params``, the adapters by ``shard_lora_params``,
  ``seq_sharded`` where ``sp`` is 2) and against the port's one-device
  step, from one carried JAX state;
- a loss mask whose supervised positions fall on both sides of a ``seq``
  cut and differ in count between the shards: the cut target (a shard's
  last position predicts the next shard's first token) and the global
  masked mean (not a mean of shard means);
- DP=2 in two ``gloo`` processes against the same steps in one process:
  equal, and the two processes' parameters equal;
- checkpoint and resume on a mesh, and a restore onto another mesh;
- a LoRA step's base placed on the mesh once and kept over its steps;
- a checkpointed layer over cards recomputed once, by one node;
- the finetune CLI on ``--tp``, ``--dp`` and ``--sp`` 2 against its
  one-device run.

Tolerances, as tests/test_torch_train.py states them: the sharded and
one-device steps compute one function in another summation order (the
row-parallel partials and the shards' loss parts are summed in f32 in
shard order), ~1e-6 relative at f32. The losses agree to 1e-4
relative. After the steps the parameters agree to 1e-5 absolute
(AdamW's update is ~lr * sign(g), lr 1e-2, and |g| dwarfs its error)
except where a gradient is within its rounding error of 0: there the two
sides' steps may differ by up to lr, so all within 2 lr and 99.9 % within
1e-5. With all seven LoRA targets such elements exist for the adapters
too: JAX's own sharded and one-device steps part by 2.2e-5 on 1 of the
17,408 adapter elements of the ``tp=4, dp=2`` case.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.models import lora as jlora
from generativeaiexamples_tpu.models import train as jtrain
from generativeaiexamples_tpu.parallel.mesh import create_mesh as jcreate_mesh
from generativeaiexamples_tpu.parallel.sharding import shard_params as jshard_params
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.models import lora as tlora
from generativeaiexamples_tpu_torch.models import train as ttrain
from generativeaiexamples_tpu_torch.models.checkpoint import CheckpointManager
from generativeaiexamples_tpu_torch.models.convert import (
    lora_from_jax, params_from_jax, train_state_from_jax,
)
from generativeaiexamples_tpu_torch.parallel import Shards, create_mesh, sharding
from tests import torch_group_workers as workers

CFG_J = jl.PRESETS["debug-8dev"]
CFG_T = tl.PRESETS["debug-8dev"]
TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
LORA_J = jlora.LoRAConfig(rank=4, alpha=8.0, targets=TARGETS)
LORA_T = tlora.LoRAConfig(rank=4, alpha=8.0, targets=TARGETS)
LR = 1e-2
# (tp, dp, sp)
MESHES = [(4, 2, 1), (2, 2, 2)]


def _np(x):
    return np.asarray(jax.device_get(x))


def _batch(seed, B=4, T=32):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, CFG_J.vocab_size, (B, T)).astype(np.int32),
            (rng.random((B, T)) < 0.7).astype(np.float32))


def _mesh(tp, dp, sp):
    return create_mesh(tp, dp, sp, devices=["cpu"] * (tp * dp * sp))


def _jmesh(tp, dp, sp):
    return jcreate_mesh(tensor_parallelism=tp, data_parallelism=dp, seq_parallelism=sp)


def _leaves(tree):
    return [t.detach().float().numpy() for t in ttrain.tree_leaves(sharding.unshard(tree, "cpu"))]


def _jax_leaves_like_port(tree):
    port = params_from_jax(jax.tree.map(_np, tree)) if "layers" in tree else \
        lora_from_jax(jax.tree.map(_np, tree))
    return [t.float().numpy() for t in ttrain.tree_leaves(port)]


def _jax_adapters():
    key_a, key_b = jax.random.split(jax.random.PRNGKey(2))
    ad = jlora.init_lora_params(CFG_J, LORA_J, key_a, jnp.float32)
    return {n: (jax.random.normal(key_b, x.shape, jnp.float32) * 0.05) if n.endswith("_b") else x
            for n, x in ad.items()}


def _port_state(jstate, mesh, lora):
    """The JAX state carried to the port and cut for ``mesh`` (whole for
    None)."""
    st = train_state_from_jax(jax.tree.map(_np, jstate))
    if mesh is None:
        return st
    cut = (lambda t: tlora.shard_lora_params(t, LORA_T, mesh)) if lora else \
        (lambda t: sharding.shard_params(t, mesh))
    params = ttrain.trainable(cut(st.params))
    return ttrain.TrainState(params, ttrain.AdamState(st.opt_state.count, cut(st.opt_state.mu),
                                                      cut(st.opt_state.nu)), st.step)


def _agree(got, want):
    diff = np.abs(np.concatenate([g.ravel() for g in got]) - np.concatenate([w.ravel() for w in want]))
    assert diff.max() <= 2 * LR
    assert np.mean(diff > 1e-5) <= 1e-3


@pytest.mark.parametrize("shape", MESHES, ids=["tp4_dp2", "tp2_dp2_sp2"])
def test_lora_steps_on_a_mesh_match_jax_s_and_one_device(shape):
    tp, dp, sp = shape
    jp = jl.init_params(CFG_J, jax.random.PRNGKey(0), jnp.float32)
    ja = _jax_adapters()
    jopt = jtrain.make_optimizer(learning_rate=LR)
    jmesh = _jmesh(tp, dp, sp)
    with jax.set_mesh(jmesh):
        jbase = jshard_params(jp, jmesh)
        jad = jlora.shard_lora_params(ja, LORA_J, jmesh)
        jstate = jtrain.TrainState(params=jad, opt_state=jopt.init(jad), step=jnp.zeros((), jnp.int32))
        jstep = jax.jit(jtrain.make_lora_train_step(CFG_J, LORA_J, jopt, sp > 1))
    mesh = _mesh(tp, dp, sp)
    tbase = params_from_jax(jax.tree.map(_np, jp))
    opt = ttrain.make_optimizer(learning_rate=LR)
    sharded = _port_state(jstate, mesh, lora=True)
    one = _port_state(jstate, None, lora=True)
    step = ttrain.make_lora_train_step(CFG_T, LORA_T, opt, sp > 1, mesh)
    step1 = ttrain.make_lora_train_step(CFG_T, LORA_T, opt)
    base = sharding.shard_params(tbase, mesh)
    assert isinstance(base["layers"][0]["wq"], Shards)
    assert isinstance(sharded.params[0]["wo_a"], Shards) and isinstance(sharded.params[0]["wq_b"], Shards)
    for i in range(2):
        tokens, mask = _batch(40 + i)
        with jax.set_mesh(jmesh):
            jstate, jloss = jstep(jstate, jbase, {"tokens": jnp.asarray(tokens),
                                                  "loss_mask": jnp.asarray(mask)})
        batch = {"tokens": torch.from_numpy(tokens), "loss_mask": torch.from_numpy(mask)}
        sharded, loss = step(sharded, base, batch)
        one, loss1 = step1(one, tbase, batch)
        assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
        assert abs(float(loss) - float(loss1)) <= 1e-4 * abs(float(loss1))
    assert int(sharded.step) == 2
    got = _leaves(sharded.params)
    _agree(got, _jax_leaves_like_port(jstate.params))
    _agree(got, _leaves(one.params))
    # the moments stay cut as the adapters are, each shard its own piece
    assert isinstance(sharded.opt_state.mu[1]["wo_a"], Shards)


@pytest.mark.parametrize("shape", MESHES, ids=["tp4_dp2", "tp2_dp2_sp2"])
def test_sft_steps_on_a_mesh_match_jax_s_and_one_device(shape):
    tp, dp, sp = shape
    jp = jl.init_params(CFG_J, jax.random.PRNGKey(0), jnp.float32)
    jopt = jtrain.make_optimizer(learning_rate=LR)
    jmesh = _jmesh(tp, dp, sp)
    with jax.set_mesh(jmesh):
        jps = jshard_params(jp, jmesh)
        jstate = jtrain.TrainState(params=jps, opt_state=jopt.init(jps), step=jnp.zeros((), jnp.int32))
        jstep = jax.jit(jtrain.make_train_step(CFG_J, jopt, sp > 1))
    mesh = _mesh(tp, dp, sp)
    opt = ttrain.make_optimizer(learning_rate=LR)
    sharded = _port_state(jstate, mesh, lora=False)
    one = _port_state(jstate, None, lora=False)
    step = ttrain.make_train_step(CFG_T, opt, sp > 1, mesh)
    step1 = ttrain.make_train_step(CFG_T, opt)
    for i in range(2):
        tokens, mask = _batch(50 + i)
        with jax.set_mesh(jmesh):
            jstate, jloss = jstep(jstate, {"tokens": jnp.asarray(tokens), "loss_mask": jnp.asarray(mask)})
        batch = {"tokens": torch.from_numpy(tokens), "loss_mask": torch.from_numpy(mask)}
        sharded, loss = step(sharded, batch)
        one, loss1 = step1(one, batch)
        assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
        assert abs(float(loss) - float(loss1)) <= 1e-4 * abs(float(loss1))
    got = _leaves(sharded.params)
    _agree(got, _jax_leaves_like_port(jstate.params))
    _agree(got, _leaves(one.params))


def test_a_mask_across_a_seq_cut_gives_the_one_device_loss_and_gradients():
    """T 16 on two seq shards (the cut at 8): the target of position 7
    (shard 0's last) is token 8 (shard 1's first), and shard 1 supervises
    four times as many positions as shard 0, so a mean of shard means
    would be another number. Loss and every adapter gradient equal the
    one-device ``sft_loss``'s within 1e-5 relative."""
    base = tl.init_params(CFG_T, 0, torch.float32)
    _, _, _, adapters, _, _ = workers.lora_setup()
    tokens = torch.from_numpy(np.random.default_rng(7).integers(1, CFG_T.vocab_size, (4, 16))
                              .astype(np.int32))
    mask = torch.zeros(4, 16)
    mask[:, 8] = 1.0  # supervised by position 7, across the cut
    mask[0, 9:13] = 1.0
    mask[3, 12:16] = 1.0
    want_params = ttrain.trainable(adapters)
    want = ttrain.sft_loss(ttrain.frozen(base), CFG_T, tokens, mask, lora=want_params,
                           lora_scale=LORA_T.scale)
    want_grads = torch.autograd.grad(want, ttrain.tree_leaves(want_params))
    want = want.detach()
    mesh = _mesh(2, 2, 2)
    params = ttrain.trainable(tlora.shard_lora_params(adapters, LORA_T, mesh))
    loss, grads = ttrain.mesh_value_and_grad(CFG_T, mesh, True, params,
                                             sharding.shard_params(base, mesh),
                                             {"tokens": tokens, "loss_mask": mask}, LORA_T.scale)
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))
    for g, w in zip(_leaves(grads), want_grads):
        scale = max(float(w.abs().max()), 1e-30)
        assert float(np.abs(g - w.numpy()).max()) <= 1e-5 * scale


def test_a_lora_step_places_its_base_once_and_keeps_it(monkeypatch):
    """The frozen base is placed on the mesh's positions when the step is
    first given it and stays there over the next steps (two steps, one
    placement of it on the one device tuple of ``cpu`` shards); a new base
    is placed anew. The adapters, trained, are placed every step."""
    placed = {"base": 0, "trained": 0}
    real = ttrain._place

    def counting(tree, tp_mesh, leaf):
        placed["trained" if leaf else "base"] += 1
        return real(tree, tp_mesh, leaf)

    monkeypatch.setattr(ttrain, "_place", counting)
    mesh = _mesh(2, 2, 2)
    _, _, base, _, batches, _ = workers.lora_setup()
    state = _mesh_lora_run(mesh, batches, steps=2)
    assert placed == {"base": 1, "trained": 2 * 2 * 2}  # (replica, seq shard) positions a step
    cfg, lcfg, _, _, _, opt = workers.lora_setup()
    step = ttrain.make_lora_train_step(cfg, lcfg, opt, True, mesh)
    other = sharding.shard_params(base, mesh)
    for _ in range(2):
        state, _ = step(state, other, batches[2])
    assert placed["base"] == 2


def test_two_gloo_processes_train_as_the_in_process_mesh():
    """DP=2 in two processes (each its rows, one all-reduce of the
    gradients a step) against DP=2 in one process: the losses and the
    adapters equal bit for bit (the same arithmetic, and a sum of two is
    one rounding either way), and both processes hold equal adapters."""
    results, seconds = workers.run_group(workers.lora_dp_worker, 2)
    assert {r: s for r, (s, _) in results.items()} == {0: "ok", 1: "ok"}, results
    r0, r1 = results[0][1], results[1][1]
    assert r0["backend"] == r1["backend"] == "gloo"
    assert r0["mesh"] == {"pipe": 1, "data": 2, "seq": 1, "model": 1}
    assert r0["calls"] == 2 * 3  # the mask count and the flattened gradients, each step
    for a, b in zip(r0["leaves"], r1["leaves"]):
        assert np.array_equal(a, b)
    losses, leaves = workers.lora_steps(create_mesh(1, 2, devices=["cpu"] * 2))
    assert r0["losses"] == r1["losses"] == losses
    for a, b in zip(r0["leaves"], leaves):
        assert np.array_equal(a, b)
    assert seconds < workers.GROUP_LIMIT_S


def _mesh_lora_run(mesh, batches, state=None, steps=None):
    cfg, lcfg, base, adapters, _, opt = workers.lora_setup()
    if state is None:
        params = ttrain.trainable(tlora.shard_lora_params(adapters, lcfg, mesh))
        state = ttrain.TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32))
    step = ttrain.make_lora_train_step(cfg, lcfg, opt, True, mesh)
    base = sharding.shard_params(base, mesh)
    for batch in batches[:steps]:
        state, _ = step(state, base, batch)
    return state


def test_checkpoint_and_resume_on_a_mesh(tmp_path):
    """Steps 1-3 uninterrupted on tp2 x dp2 x sp2, against 1-2, save,
    restore into a fresh sharded template, 3: bit for bit (the save joins
    the pieces, the restore cuts them again). The same checkpoint restores
    onto one device whole."""
    _, _, _, _, batches, _ = workers.lora_setup()
    mesh = _mesh(2, 2, 2)
    full = _mesh_lora_run(mesh, batches)
    part = _mesh_lora_run(mesh, batches, steps=2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, part)
    saved = torch.load(tmp_path / "2" / "state.pt", weights_only=True)
    assert saved["params"][0]["wo_a"].shape == (CFG_T.q_dim, LORA_T.rank)  # whole
    fresh = _mesh_lora_run(mesh, batches, steps=0)
    resumed = mgr.restore(fresh)
    assert isinstance(resumed.params[0]["wo_a"], Shards) and int(resumed.step) == 2
    resumed = _mesh_lora_run(mesh, batches[2:], state=resumed)
    for a, b in zip(_leaves(resumed.params) + _leaves(resumed.opt_state.nu),
                    _leaves(full.params) + _leaves(full.opt_state.nu)):
        assert np.array_equal(a, b)
    whole = mgr.restore(_mesh_lora_run(create_mesh(1, devices=["cpu"]), batches, steps=0))
    for a, b in zip(_leaves(whole.params), _leaves(part.params)):
        assert np.array_equal(a, b)


def _cli(tmp_path, capsys, *extra):
    from generativeaiexamples_tpu_torch.tools import finetune

    data = tmp_path / "data.jsonl"
    data.write_text("\n".join(json.dumps({"prompt": f"q{i}: what is a gpu?", "response": "a card of SMs"})
                              for i in range(8)))
    rc = finetune.main(["--model", "debug", "--data", str(data), "--mode", "lora", "--device", "cpu",
                        "--rank", "2", "--steps", "2", "--batch-size", "4", "--seq-len", "32",
                        "--log-every", "1", *extra])
    captured = capsys.readouterr()
    assert rc == 0
    return json.loads(captured.out.splitlines()[-1]), captured.err


@pytest.mark.parametrize("flag", ["--tp", "--dp", "--sp"])
def test_finetune_trains_on_more_than_one_device(tmp_path, capsys, flag):
    """Each flag at 2 trains 2 steps; the loss line agrees with the
    one-device run's within 2e-3 relative (bf16 weights: the sharded
    reduces round each partial to bf16 once more)."""
    want, _ = _cli(tmp_path, capsys)
    got, err = _cli(tmp_path, capsys, flag, "2")
    assert got["steps"] == want["steps"] == 2
    assert abs(got["final_loss"] - want["final_loss"]) <= 2e-3 * abs(want["final_loss"])
    parallel = json.loads(next(l for l in err.splitlines() if l.startswith("parallel: "))[10:])
    axis = {"--tp": "model", "--dp": "data", "--sp": "seq"}[flag]
    assert parallel["mesh"][axis] == 2 and parallel["processes"] == 1


def test_a_segment_over_cards_recomputes_once_and_keeps_the_gradients(monkeypatch):
    """A checkpointed layer that spans cards ends in one autograd node
    (``llama._RecomputeOnce``) whose unpack recomputes the layer, so
    autograd's device threads never start two recomputes of it. Forced on
    here over ``cpu`` shards: every layer is recomputed once, and the
    loss and gradients equal the step without it bit for bit."""
    def run():
        cfg, lcfg, base, adapters, batches, _ = workers.lora_setup()
        mesh = _mesh(2, 2, 2)
        params = ttrain.trainable(tlora.shard_lora_params(adapters, lcfg, mesh))
        return ttrain.mesh_value_and_grad(cfg, mesh, True, params, sharding.shard_params(base, mesh),
                                          batches[0], lcfg.scale)

    want_loss, want = run()
    monkeypatch.setattr(tl, "_spans_cards", lambda tps, tokens: True)
    calls = []
    real = tl._RecomputeOnce.backward

    def backward(ctx, *grads):
        calls.append(1)
        return real(ctx, *grads)

    monkeypatch.setattr(tl._RecomputeOnce, "backward", staticmethod(backward))
    loss, got = run()
    assert calls and len(calls) == 2 * CFG_T.num_layers  # one a layer of each data replica
    assert float(loss) == float(want_loss)
    for g, w in zip(_leaves(got), _leaves(want)):
        assert np.array_equal(g, w)
