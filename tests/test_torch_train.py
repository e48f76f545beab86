"""The port's fine-tuning plane against the JAX package's, at the ``debug``
preset on the CPU, the same weights on both sides (carried with
models/convert.py):

- ``llama.forward`` (the cache-free path) with and without LoRA
  adapters, with and without ``remat``, against JAX's ``forward`` at f32;
  the LoRA delta on a fused int8 pack (``_lora_delta``);
- ``lora.merge`` against JAX's, and the merged forward against the
  unmerged one; ``init_lora_params``' shapes and zero delta;
  ``count_params``/``count_lora_params`` against JAX's counts;
- ``train.sft_loss`` and its gradients (every weight, and the adapters)
  against ``jax.value_and_grad`` at f32;
- ``train.make_optimizer`` against ``optax.adamw`` over 5 steps;
- 3 LoRA steps and 2 SFT steps from a carried JAX state against JAX's
  jitted steps; the LoRA step never writes the base weights;
- models/checkpoint.py: round trip onto a template (its dtype and
  requires_grad), keep-N, a save cut short, and a resume that continues
  bit for bit as the uninterrupted run;
- the finetune CLI (tools/finetune.py): rows and batches equal JAX's,
  LoRA end to end with a merge and a resume, SFT, each package's
  ``load_merged`` reading the other's npz, and ``--tp/--dp/--sp 2``
  refused naming ROADMAP queue 1 item 15.

Tolerances. f32 forward and loss: both sides run the same f32 math in
another summation order, ~1e-6 relative, so 1e-4 (logits absolute, O(1)
values; loss and gradients relative to each leaf's largest entry). AdamW:
the same operations in the same order and dtype; f32 within 1e-6
relative (``pow`` may round an ulp apart), bf16 within one ulp of bf16.
Train steps: AdamW's update is ~lr * sign(g) where |g| dwarfs its error,
so the parameters after the steps agree to 1e-5 absolute (lr 1e-2; the
weights are O(0.1)) and the losses to 1e-4 relative; over every weight
(SFT), an element whose gradient is within its rounding error of 0 may
step up to lr otherwise, so there all within 2 lr and 99.9 % within 1e-5. merge: an f32 sum of
r products and one rounding, so f32 within 1e-6 and bf16 within one ulp.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.models import lora as jlora
from generativeaiexamples_tpu.models import train as jtrain
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.models import lora as tlora
from generativeaiexamples_tpu_torch.models import train as ttrain
from generativeaiexamples_tpu_torch.models.convert import (
    lora_from_jax, params_from_jax, to_tensor, train_state_from_jax,
)
from generativeaiexamples_tpu_torch.ops import quant

CFG_J = jl.PRESETS["debug"]
CFG_T = tl.PRESETS["debug"]
LORA_J = jlora.LoRAConfig(rank=4, alpha=8.0)
LORA_T = tlora.LoRAConfig(rank=4, alpha=8.0)
LORA_ALL_J = jlora.LoRAConfig(rank=2, alpha=4.0, targets=tuple(jlora._TARGET_DIMS))
LORA_ALL_T = tlora.LoRAConfig(rank=2, alpha=4.0, targets=tuple(tlora._TARGET_DIMS))
ATOL = 1e-4


def _np(x):
    return np.asarray(jax.device_get(x))


def _base(dtype=jnp.float32, seed=0):
    jp = jl.init_params(CFG_J, jax.random.PRNGKey(seed), dtype)
    return jp, params_from_jax(jax.tree.map(_np, jp))


def _adapters(cfg_j, seed=2, dtype=jnp.float32):
    """JAX adapters with B nonzero, so the delta fires."""
    key_a, key_b = jax.random.split(jax.random.PRNGKey(seed))
    ad = jlora.init_lora_params(CFG_J, cfg_j, key_a, dtype)
    ad = {n: (jax.random.normal(key_b, x.shape, jnp.float32) * 0.05).astype(x.dtype)
          if n.endswith("_b") else x for n, x in ad.items()}
    return ad, lora_from_jax(jax.tree.map(_np, ad))


def _batch(B=2, T=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, CFG_J.vocab_size, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) < 0.7).astype(np.float32)
    return tokens, mask


def _positions(tokens):
    B, T = tokens.shape
    return np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30))


def _mesh():
    from generativeaiexamples_tpu.parallel.mesh import single_device_mesh

    return jax.set_mesh(single_device_mesh())


@pytest.mark.parametrize("use_lora", [False, True])
@pytest.mark.parametrize("remat", [False, True])
def test_forward_matches_jax_at_f32(use_lora, remat):
    jp, tp = _base()
    tokens, _ = _batch()
    pos = _positions(tokens)
    ja, ta = _adapters(LORA_ALL_J) if use_lora else (None, None)
    want, _ = jl.forward(jp, CFG_J, jnp.asarray(tokens), jnp.asarray(pos), remat=remat,
                         lora=ja, lora_scale=LORA_ALL_J.scale)
    got = tl.forward(tp, CFG_T, torch.from_numpy(tokens), torch.from_numpy(pos.copy()),
                     remat=remat, lora=ta, lora_scale=LORA_ALL_T.scale)
    assert got.dtype == torch.float32 and got.shape == (2, 16, CFG_T.vocab_size)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)


def test_lora_delta_on_fused_packs_matches_the_unfused_projections():
    """A fused int8 tree with adapters: the deltas land on the q/k/v and
    gate/up slices exactly as on the unfused tree over the same
    (dequantized) weights."""
    _, tp = _base()
    _, ta = _adapters(LORA_ALL_J)
    packed = quant.quantize_params_int8(tp)
    dense = dict(packed)
    dense["layers"] = []
    widths = quant.fused_widths(CFG_T)
    for lp in packed["layers"]:
        d = {k: v for k, v in lp.items() if not isinstance(v, dict)}
        for key, pack in lp.items():
            if not isinstance(pack, dict):
                continue
            w = quant.dequantize_int8(pack, torch.float32, quant._k_features(CFG_T).get(key, CFG_T.hidden_size))
            if key in widths:
                f0 = 0
                for name, width in widths[key]:
                    d[name] = w[:, f0:f0 + width]
                    f0 += width
            else:
                d[key] = w
        dense["layers"].append(d)
    tokens, _ = _batch()
    pos = torch.from_numpy(_positions(tokens).copy())
    tok = torch.from_numpy(tokens)
    fused = tl.forward(packed, CFG_T, tok, pos, lora=ta, lora_scale=LORA_ALL_T.scale)
    unfused = tl.forward(dense, CFG_T, tok, pos, lora=ta, lora_scale=LORA_ALL_T.scale,
                         quant_kernel=False)
    base = tl.forward(packed, CFG_T, tok, pos)
    assert (fused - base).abs().max() > 1e-3  # the deltas fired
    # the pack's plain product rounds its activations to bf16 (int8_plain)
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), atol=5e-2, rtol=0)


@pytest.mark.parametrize("jdt, tdt", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)])
def test_merge_matches_jax(jdt, tdt):
    jp, tp = _base(jdt)
    ja, ta = _adapters(LORA_J, dtype=jdt)
    want = jlora.merge(jp, ja, LORA_J)
    got = tlora.merge(tp, ta, LORA_T)
    for i, lp in enumerate(got["layers"]):
        for name in ("wq", "wk", "wv", "wo", "w_gate"):
            w = to_tensor(_np(want["layers"][name][i]))
            assert lp[name].dtype == tdt
            if tdt == torch.float32:
                np.testing.assert_allclose(lp[name].numpy(), w.numpy(), rtol=1e-6, atol=1e-7)
            else:
                ulps = (lp[name].view(torch.int16).int() - w.view(torch.int16).int()).abs()
                assert int(ulps.max()) <= 1, name
    # the base stays as it was; an untargeted weight is shared
    assert got["layers"][0]["w_gate"] is tp["layers"][0]["w_gate"]
    assert torch.equal(tp["layers"][0]["wq"], to_tensor(_np(jp["layers"]["wq"][0])))


def test_merged_forward_matches_the_unmerged_forward():
    _, tp = _base()
    _, ta = _adapters(LORA_J)
    tokens, _ = _batch()
    pos = torch.from_numpy(_positions(tokens).copy())
    tok = torch.from_numpy(tokens)
    unmerged = tl.forward(tp, CFG_T, tok, pos, lora=ta, lora_scale=LORA_T.scale)
    merged = tl.forward(tlora.merge(tp, ta, LORA_T), CFG_T, tok, pos)
    np.testing.assert_allclose(merged.numpy(), unmerged.numpy(), atol=ATOL, rtol=0)


def test_init_lora_params_shapes_and_zero_delta():
    gen = torch.Generator().manual_seed(1)
    ad = tlora.init_lora_params(CFG_T, LORA_T, gen, torch.float32)
    assert len(ad) == CFG_T.num_layers
    assert ad[0]["wq_a"].shape == (CFG_T.hidden_size, 4)
    assert ad[0]["wq_b"].shape == (4, CFG_T.q_dim)
    assert ad[0]["wo_a"].shape == (CFG_T.q_dim, 4)
    assert all(not torch.any(lp[f"{t}_b"]) for lp in ad for t in LORA_T.targets)
    a = torch.cat([lp["wq_a"].reshape(-1) for lp in ad])
    assert abs(float(a.std()) * CFG_T.hidden_size ** 0.5 - 1.0) < 0.25
    _, tp = _base()
    tokens, _ = _batch()
    pos = torch.from_numpy(_positions(tokens).copy())
    tok = torch.from_numpy(tokens)
    base = tl.forward(tp, CFG_T, tok, pos)
    adapted = tl.forward(tp, CFG_T, tok, pos, lora=ad, lora_scale=LORA_T.scale)
    assert torch.equal(base, adapted)


def test_counts_match_jax():
    jp, tp = _base()
    ja, ta = _adapters(LORA_ALL_J)
    assert tl.count_params(tp) == jl.count_params(jp)
    assert tlora.count_lora_params(ta) == jlora.count_lora_params(ja)


def test_unknown_lora_target_rejected():
    with pytest.raises(ValueError, match="Unknown LoRA targets"):
        tlora.LoRAConfig(targets=("wq", "nope"))


def _assert_tree_close(got, want_np, rel=1e-4, where="tree"):
    for i, (g, w) in enumerate(zip(ttrain.tree_leaves(got), want_np)):
        assert _rel(w, g.detach().float().numpy()) <= rel, f"{where} leaf {i}"


def _jax_leaves_like_port(tree):
    """The JAX tree's leaves in the port tree's order (layers split, keys
    in the port dict order)."""
    if "layers" in tree:
        port = params_from_jax(jax.tree.map(_np, tree))
    else:
        port = lora_from_jax(jax.tree.map(_np, tree))
    return [t.float().numpy() for t in ttrain.tree_leaves(port)]


def test_sft_loss_and_gradients_match_jax():
    jp, tp = _base()
    tokens, mask = _batch()
    with _mesh():
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p: jtrain.sft_loss(p, CFG_J, jnp.asarray(tokens), jnp.asarray(mask))))(jp)
    tp = ttrain.trainable(tp)
    loss = ttrain.sft_loss(tp, CFG_T, torch.from_numpy(tokens), torch.from_numpy(mask))
    grads = torch.autograd.grad(loss, ttrain.tree_leaves(tp))
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-4 * abs(float(jloss))
    for i, (g, w) in enumerate(zip(grads, _jax_leaves_like_port(jgrads))):
        assert _rel(w, g.numpy()) <= 1e-4, f"grad leaf {i}"


def test_lora_loss_gradients_match_jax():
    jp, tp = _base()
    ja, ta = _adapters(LORA_ALL_J)
    tokens, mask = _batch()

    def jloss_fn(ad):
        return jtrain.sft_loss(jp, CFG_J, jnp.asarray(tokens), jnp.asarray(mask),
                               lora=ad, lora_scale=LORA_ALL_J.scale)

    with _mesh():
        jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(ja)
    ta = ttrain.trainable(ta)
    loss = ttrain.sft_loss(tp, CFG_T, torch.from_numpy(tokens), torch.from_numpy(mask),
                           lora=ta, lora_scale=LORA_ALL_T.scale)
    grads = torch.autograd.grad(loss, ttrain.tree_leaves(ta))
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-4 * abs(float(jloss))
    for i, (g, w) in enumerate(zip(grads, _jax_leaves_like_port(jgrads))):
        assert _rel(w, g.numpy()) <= 1e-4, f"grad leaf {i}"


@pytest.mark.parametrize("jdt, tdt", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)])
def test_adamw_matches_optax_over_five_steps(jdt, tdt):
    rng = np.random.default_rng(3)
    p0 = {"w": rng.standard_normal((48, 33)).astype(np.float32),
          "b": rng.standard_normal((33,)).astype(np.float32)}
    jopt = optax.adamw(3e-2, b1=0.9, b2=0.95, weight_decay=0.01)
    topt = ttrain.make_optimizer(3e-2)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p0)
    js = jopt.init(jp)
    tp = {k: to_tensor(_np(v)) for k, v in jp.items()}
    ts = topt.init(tp)
    for _ in range(5):
        g = {k: (rng.standard_normal(v.shape) * 10 ** rng.uniform(-3, 1)).astype(np.float32)
             for k, v in p0.items()}
        jg = jax.tree.map(lambda a: jnp.asarray(a, jdt), g)
        ju, js = jopt.update(jg, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update({k: to_tensor(_np(v)) for k, v in jg.items()}, ts, tp)
        tp = ttrain.apply_updates(tp, tu)
    assert int(ts.count) == int(js[0].count) == 5
    for k in p0:
        for got, want in ((tp[k], jp[k]), (ts.mu[k], js[0].mu[k]), (ts.nu[k], js[0].nu[k])):
            want = to_tensor(_np(want))
            assert got.dtype == tdt
            if tdt == torch.float32:
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-12)
            else:
                ulps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
                assert int(ulps.max()) <= 1, k


def test_lora_steps_from_a_carried_jax_state_match_jax():
    jp, tp = _base()
    ja = jlora.init_lora_params(CFG_J, LORA_ALL_J, jax.random.PRNGKey(5), jnp.float32)
    jopt = jtrain.make_optimizer(learning_rate=1e-2)
    jstate = jtrain.TrainState(params=ja, opt_state=jopt.init(ja), step=jnp.zeros((), jnp.int32))
    jstep = jax.jit(jtrain.make_lora_train_step(CFG_J, LORA_ALL_J, jopt))
    tstate = train_state_from_jax(jax.tree.map(_np, jstate))
    tstep = ttrain.make_lora_train_step(CFG_T, LORA_ALL_T, ttrain.make_optimizer(learning_rate=1e-2))
    base_before = [t.clone() for t in ttrain.tree_leaves(tp)]
    for i in range(3):
        tokens, mask = _batch(seed=10 + i)
        batch = {"tokens": jnp.asarray(tokens), "loss_mask": jnp.asarray(mask)}
        with _mesh():
            jstate, jloss = jstep(jstate, jp, batch)
        tstate, tloss = tstep(tstate, tp, {"tokens": torch.from_numpy(tokens),
                                           "loss_mask": torch.from_numpy(mask)})
        assert abs(float(tloss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    assert int(tstate.step) == int(jstate.step) == 3
    for g, w in zip(ttrain.tree_leaves(tstate.params), _jax_leaves_like_port(jstate.params)):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-5, rtol=0)
    # the base never moved and the moments are adapter-sized
    assert all(torch.equal(a, b) for a, b in zip(base_before, ttrain.tree_leaves(tp)))
    assert sum(t.numel() for t in ttrain.tree_leaves(tstate.opt_state.mu)) == \
        tlora.count_lora_params(tstate.params)


def test_sft_steps_from_a_carried_jax_state_match_jax():
    jp, _ = _base()
    jopt = jtrain.make_optimizer(learning_rate=1e-2)
    jstate = jtrain.TrainState(params=jp, opt_state=jopt.init(jp), step=jnp.zeros((), jnp.int32))
    jstep = jax.jit(jtrain.make_train_step(CFG_J, jopt))
    tstate = train_state_from_jax(jax.tree.map(_np, jstate))
    tstep = ttrain.make_train_step(CFG_T, ttrain.make_optimizer(learning_rate=1e-2))
    for i in range(2):
        tokens, mask = _batch(seed=20 + i)
        with _mesh():
            jstate, jloss = jstep(jstate, {"tokens": jnp.asarray(tokens), "loss_mask": jnp.asarray(mask)})
        tstate, tloss = tstep(tstate, {"tokens": torch.from_numpy(tokens),
                                       "loss_mask": torch.from_numpy(mask)})
        assert abs(float(tloss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    # Adam normalizes each element's step by its own gradient: where a
    # gradient is within its rounding error of 0, the two sides' steps can
    # differ by up to lr, so all elements within 2 lr and 99.9 % within 1e-5
    got = np.concatenate([g.detach().numpy().ravel() for g in ttrain.tree_leaves(tstate.params)])
    want = np.concatenate([w.ravel() for w in _jax_leaves_like_port(jstate.params)])
    diff = np.abs(got - want)
    assert diff.max() <= 2e-2
    assert np.mean(diff > 1e-5) <= 1e-3
    for g, w in zip(ttrain.tree_leaves(tstate.opt_state.nu),
                    _jax_leaves_like_port(jstate.opt_state[0].nu)):
        assert _rel(w, g.numpy()) <= 1e-3


# --------------------------------------------------------------------- #
# checkpoint/resume (models/checkpoint.py)


def _lora_state(seed=3, dtype=torch.float32, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    ad = ttrain.trainable(tlora.init_lora_params(CFG_T, LORA_T, gen, dtype, device))
    opt = ttrain.make_optimizer()
    return ttrain.TrainState(params=ad, opt_state=opt.init(ad),
                             step=torch.zeros((), dtype=torch.int32, device=device))


def test_checkpoint_round_trip_onto_the_template(tmp_path):
    from generativeaiexamples_tpu_torch.models.checkpoint import CheckpointManager

    state = _lora_state()
    state.step = torch.tensor(7, dtype=torch.int32)
    state.opt_state.mu[0]["wq_a"].add_(0.5)
    mgr = CheckpointManager(str(tmp_path / "ckpts"))
    mgr.save(7, state, wait=True)
    assert mgr.latest_step() == 7
    template = _lora_state(seed=99, dtype=torch.bfloat16)
    restored = mgr.restore(template)
    mgr.close()
    assert int(restored.step) == 7 and restored.step.dtype == torch.int32
    # leaves take the template's dtype and requires_grad; values the saved ones
    leaf = restored.params[1]["wv_a"]
    assert leaf.dtype == torch.bfloat16 and leaf.requires_grad
    assert torch.equal(leaf, state.params[1]["wv_a"].detach().to(torch.bfloat16))
    assert torch.equal(restored.opt_state.mu[0]["wq_a"],
                       state.opt_state.mu[0]["wq_a"].to(torch.bfloat16))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(ttrain.TrainState(
            params=tlora.init_lora_params(CFG_T, tlora.LoRAConfig(rank=8), torch.Generator()),
            opt_state=template.opt_state, step=template.step))


def test_checkpoint_keeps_the_newest_n_and_survives_a_cut_save(tmp_path):
    from generativeaiexamples_tpu_torch.models.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore(_lora_state())
    for step in (1, 2, 3, 4):
        state = _lora_state()
        state.step = torch.tensor(step, dtype=torch.int32)
        mgr.save(step, state)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    # a save cut short leaves its temporary directory, never a step
    os_dir = tmp_path / ".5.tmp-1"
    os_dir.mkdir()
    (os_dir / "state.pt").write_bytes(b"partial")
    (tmp_path / "6").mkdir()  # a step directory without its state file
    assert mgr.latest_step() == 4
    assert int(mgr.restore(_lora_state()).step) == 4
    assert int(mgr.restore(_lora_state(), step=3).step) == 3
    with pytest.raises(FileNotFoundError):
        mgr.restore(_lora_state(), step=2)


def test_resume_continues_bitwise_as_the_uninterrupted_run(tmp_path):
    """LoRA steps 1-4 uninterrupted, against 1-2, save, restore into a
    fresh state, 3-4: the adapters and moments equal bit for bit."""
    from generativeaiexamples_tpu_torch.models.checkpoint import CheckpointManager

    _, base = _base()
    step = ttrain.make_lora_train_step(CFG_T, LORA_T, ttrain.make_optimizer(learning_rate=1e-2))
    batches = []
    for i in range(4):
        tokens, mask = _batch(seed=30 + i)
        batches.append({"tokens": torch.from_numpy(tokens), "loss_mask": torch.from_numpy(mask)})
    full = _lora_state()
    for b in batches:
        full, _ = step(full, base, b)
    part = _lora_state()
    for b in batches[:2]:
        part, _ = step(part, base, b)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, part)
    resumed = mgr.restore(_lora_state(seed=123))
    for b in batches[2:]:
        resumed, _ = step(resumed, base, b)
    assert int(resumed.step) == 4
    for a, b in zip(ttrain.tree_leaves(resumed.params) + ttrain.tree_leaves(resumed.opt_state.nu),
                    ttrain.tree_leaves(full.params) + ttrain.tree_leaves(full.opt_state.nu)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# the finetune CLI (generativeaiexamples_tpu_torch/tools/finetune.py)


def _data(tmp_path, n=8):
    data = tmp_path / "data.jsonl"
    with open(data, "w", encoding="utf-8") as fh:
        for i in range(n):
            fh.write(json.dumps({"prompt": f"q{i}: what is a gpu?", "response": "a card of SMs"}) + "\n")
        fh.write(json.dumps({"text": "hopper tiles ride the tensor cores"}) + "\n")
    return str(data)


def _last_json(capsys):
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    return json.loads(lines[-1])


def test_finetune_rows_and_batches_are_jax_s(tmp_path):
    from generativeaiexamples_tpu.engine.tokenizer import load_tokenizer as jload
    from generativeaiexamples_tpu_torch.engine.tokenizer import load_tokenizer as tload
    from generativeaiexamples_tpu_torch.tools import finetune as tft
    from tools import finetune as jft

    examples = jft.load_examples(_data(tmp_path))
    assert tft.load_examples(_data(tmp_path)) == examples
    jrows = jft.tokenize_examples(examples, jload(None), 24)
    trows = tft.tokenize_examples(examples, tload(None), 24)
    assert len(trows) == len(jrows) == 9
    for a, b in zip(trows, jrows):
        assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)
    for bs, seed in ((3, 0), (4, 5), (16, 1)):
        jit_, tit = jft.batches(jrows, bs, seed), tft.batches(trows, bs, seed)
        for _ in range(7):
            a, b = next(tit), next(jit_)
            assert all(np.array_equal(a[k], b[k]) for k in a)


def test_finetune_cli_lora_end_to_end_and_resume(tmp_path, capsys):
    from generativeaiexamples_tpu_torch.tools import finetune

    data, merged_out, ck = _data(tmp_path), tmp_path / "merged.npz", str(tmp_path / "ck")
    rc = finetune.main([
        "--model", "debug", "--data", data, "--mode", "lora", "--device", "cpu",
        "--rank", "2", "--steps", "3", "--batch-size", "2", "--seq-len", "32",
        "--tp", "1", "--ckpt-dir", ck, "--save-every", "2", "--merge-out", str(merged_out),
        "--log-every", "1",
    ])
    assert rc == 0 and merged_out.exists()
    out = _last_json(capsys)
    assert out["steps"] == 3 and np.isfinite(out["final_loss"])
    params = finetune.load_merged(str(merged_out))
    assert len(params["layers"]) == CFG_T.num_layers
    assert params["layers"][0]["wq"].shape == (CFG_T.hidden_size, CFG_T.q_dim)
    # resume: the remaining step from the saved checkpoint
    rc = finetune.main([
        "--model", "debug", "--data", data, "--mode", "lora", "--device", "cpu",
        "--rank", "2", "--steps", "4", "--batch-size", "2", "--seq-len", "32",
        "--tp", "1", "--ckpt-dir", ck, "--resume", "--log-every", "1",
    ])
    captured = capsys.readouterr()
    assert rc == 0 and json.loads(captured.out.splitlines()[-1])["steps"] == 4
    assert "resumed from step 3" in captured.err
    from generativeaiexamples_tpu_torch.models.checkpoint import CheckpointManager

    assert CheckpointManager(ck).latest_step() == 4


def test_finetune_cli_sft_smoke(tmp_path, capsys):
    from generativeaiexamples_tpu_torch.tools import finetune

    data = tmp_path / "data.jsonl"
    data.write_text(json.dumps({"text": "tensor cores ride sm90a"}) + "\n")
    rc = finetune.main([
        "--model", "debug", "--data", str(data), "--mode", "sft", "--device", "cpu",
        "--steps", "2", "--batch-size", "2", "--seq-len", "16", "--tp", "1", "--log-every", "1",
    ])
    assert rc == 0 and _last_json(capsys)["steps"] == 2


def test_each_package_reads_the_other_s_merged_npz(tmp_path):
    from generativeaiexamples_tpu_torch.tools import finetune as tft
    from tools import finetune as jft

    jp = jl.init_params(CFG_J, jax.random.PRNGKey(0), jnp.float32)
    jft.save_merged(str(tmp_path / "jax.npz"), jp)
    got = tft.load_merged(str(tmp_path / "jax.npz"), torch.float32)
    want = params_from_jax(jax.tree.map(_np, jp))
    assert all(torch.equal(got[k], want[k]) for k in ("embed", "final_norm", "lm_head"))
    assert all(torch.equal(a[k], b[k]) for a, b in zip(got["layers"], want["layers"]) for k in b)
    tft.save_merged(str(tmp_path / "port.npz"), want)
    back = jft.load_merged(str(tmp_path / "port.npz"), jnp.float32)
    assert jax.tree.all(jax.tree.map(lambda a, b: bool(np.array_equal(_np(a), _np(b))), back, jp))


@pytest.mark.parametrize("flag", ["--tp", "--dp", "--sp"])
def test_finetune_refuses_more_than_one_device_naming_item_15(tmp_path, flag):
    from generativeaiexamples_tpu_torch.tools import finetune

    with pytest.raises(SystemExit, match="queue 1 item 15"):
        finetune.main(["--model", "debug", "--data", _data(tmp_path), "--device", "cpu",
                       flag, "2", "--steps", "1"])
