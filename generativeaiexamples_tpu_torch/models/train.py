"""Supervised fine-tuning (SFT) and LoRA train steps, on one device.

Counterpart of generativeaiexamples_tpu/models/train.py: next-token cross
entropy over the supervised positions, AdamW, per-layer
rematerialization. The training path is the JAX package's plain path:
dense weights, ``torch.matmul`` and the einsum attention of
models/llama.py under autograd; no kernel of ops/ runs here (JAX trains
through XLA's matmuls, and no Pallas kernel of it has a backward).

The optimizer is optax's ``adamw`` written out (the GPU machine has no
optax) in optax's order of operations, each one in the parameter's dtype
as optax computes it (``mu_dtype=None``): the moments' EMAs, bias
correction with the incremented count (``1 - b**count`` in f32, cast to
the moment's dtype), ``mu_hat / (sqrt(nu_hat + eps_root) + eps)``, the
decay ``+ wd * p`` added before the ``-lr`` scale, then ``p + u`` cast
back to ``p``'s dtype. ``torch.optim.AdamW`` orders and rounds these
otherwise in bf16.

Parameter trees are nested dicts and lists of tensors (the model's
layered tree, or models/lora.py's adapters); a train step returns a new
:class:`TrainState` and never writes the tensors it was given.

On a (``data``, ``seq``, ``model``) mesh (``mesh=``, parallel/mesh.py),
JAX's sharded step:

- the state lives cut on the ``model`` axis of this process's first
  replica (``sharding.model_mesh``): dense weights Megatron-style
  (``sharding.shard_params``), adapters by ``lora.shard_lora_params``;
  AdamW is elementwise, so each shard updates its own piece;
- each data replica takes its rows of the batch (``token_spec``), and
  under ``seq_sharded`` each of its ``seq`` shards its own positions
  (``llama.forward_seq``); every (replica, seq shard) position gets the
  trained leaves placed on its devices each step (``.to``, no copy on the
  same device) as autograd leaves of its own (the broadcast of the
  update, which JAX's replicas apply each in place); a LoRA step's frozen
  base is placed on each position once, when the step is first given it,
  and stays there while the step is given the same base, as JAX's
  replicas stay resident;
- the loss is JAX's global masked mean, ``sum(nll * mask) / max(sum(mask),
  1)``: the numerator and the mask count are summed over every replica
  and seq shard, and across processes, before the division (not a mean
  of shard means); a shard's last position is supervised by the next
  shard's first token (``targets = tokens[:, 1:]``);
- the gradients of the positions are summed in f32 in (replica, seq
  shard) order onto the state's devices, then across processes with one
  ``all_reduce`` of the flattened f32 gradients (and the loss), then cast
  to each parameter's dtype; every process then takes the same update,
  so every data replica's parameters stay equal.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.parallel import multihost, sharding, tp_kernels
from generativeaiexamples_tpu_torch.parallel.mesh import SEQ_AXIS, Mesh
from generativeaiexamples_tpu_torch.parallel.sharding import Shards


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict/list tree, in :func:`tree_map`'s order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    raise TypeError(f"not a tensor tree leaf: {type(tree).__name__}")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the corresponding tensors of trees of one structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, Shards):
        return tree.like(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    raise TypeError(f"not a tensor tree leaf: {type(tree).__name__}")


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the step count (int32) and the first
    and second moments, trees like the parameters, in their dtypes."""

    count: torch.Tensor
    mu: Any
    nu: Any


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: AdamState
    step: torch.Tensor  # int32, 0-dim


class AdamW:
    """``optax.adamw(learning_rate, b1, b2, eps, eps_root, weight_decay)``
    with optax's ``init(params)`` / ``update(grads, state, params)`` pair;
    ``apply_updates`` adds the updates."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0, weight_decay: float = 1e-4):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.weight_decay = weight_decay

    def init(self, params) -> AdamState:
        first = tree_leaves(params)[0]
        zeros = lambda p: torch.zeros_like(p, requires_grad=False)  # noqa: E731
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=first.device),
            mu=tree_map(zeros, params), nu=tree_map(zeros, params),
        )

    @torch.no_grad()
    def update(self, grads, state: AdamState, params) -> Tuple[Any, AdamState]:
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        # 1 - b ** count in f32 (optax's tree_bias_correction), then each
        # moment's dtype
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=count.device) ** count
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=count.device) ** count

        def c(value, like):  # a Python scalar in the leaf's dtype, as JAX's weak types
            return torch.tensor(value, dtype=like.dtype, device=like.device)

        mu = tree_map(lambda g, m: c(1 - b1, g) * g + c(b1, g) * m, grads, state.mu)
        nu = tree_map(lambda g, v: c(1 - b2, g) * (g * g) + c(b2, g) * v, grads, state.nu)

        def step(m, v, p):
            m_hat = m / bc1.to(m.device, m.dtype)  # a shard's own card
            v_hat = v / bc2.to(v.device, v.dtype)
            u = m_hat / (torch.sqrt(v_hat + c(self.eps_root, v)) + c(self.eps, v))
            u = u + c(self.weight_decay, p) * p.detach()
            return c(-self.learning_rate, u) * u

        return tree_map(step, mu, nu, params), AdamState(count=count, mu=mu, nu=nu)


def apply_updates(params, updates):
    """``p + u`` cast to ``p``'s dtype, as new leaf tensors that keep
    ``p``'s ``requires_grad``."""
    with torch.no_grad():
        return tree_map(
            lambda p, u: (p.detach() + u).to(p.dtype).requires_grad_(p.requires_grad),
            params, updates,
        )


def make_optimizer(
    learning_rate: float = 1e-5, weight_decay: float = 0.01, b1: float = 0.9, b2: float = 0.95
) -> AdamW:
    return AdamW(learning_rate, b1=b1, b2=b2, weight_decay=weight_decay)


def init_train_state(
    cfg: llama.LlamaConfig,
    seed: int,
    optimizer: AdamW,
    dtype=torch.bfloat16,
    device="cpu",
) -> TrainState:
    params = trainable(llama.init_params(cfg, seed, dtype, device))
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=torch.device(device)))


def trainable(params):
    """The tree's tensors as leaves that require grad."""
    return tree_map(lambda t: t.detach().requires_grad_(True), params)


def frozen(params):
    """The tree's tensors as leaves that do not."""
    return tree_map(lambda t: t.detach(), params)


def sft_loss(
    params: llama.Params,
    cfg: llama.LlamaConfig,
    tokens: torch.Tensor,  # [B, T] int
    loss_mask: torch.Tensor,  # [B, T] 1.0 where the target token is supervised
    seq_sharded: bool = False,
    lora=None,
    lora_scale: float = 1.0,
    remat: bool = True,
) -> torch.Tensor:
    """Mean next-token cross entropy over masked positions (f32), on one
    device (``seq_sharded`` is JAX's layout hint, which changes nothing
    on one device; the steps on a mesh sum the loss over its shards)."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    logits = llama.forward(params, cfg, tokens, positions, remat=remat, lora=lora,
                           lora_scale=lora_scale)
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = loss_mask[:, 1:].float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _value_and_grad(loss_fn: Callable[[], torch.Tensor], params):
    loss = loss_fn()
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(grads)

    def grad_of(p):  # a leaf the loss never reads gets zeros, as from jax.grad
        g = next(it)
        return torch.zeros_like(p) if g is None else g

    return loss.detach(), tree_map(grad_of, params)


def make_train_step(
    cfg: llama.LlamaConfig, optimizer: AdamW, seq_sharded: bool = False,
    mesh: Optional[Mesh] = None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, torch.Tensor]]:
    """The SFT step over every weight of ``state.params`` (leaves that
    require grad, ``trainable``); on ``mesh`` (more than one device or
    process) the sharded step, ``state.params`` cut by
    ``sharding.shard_params(..., mesh)``."""
    on_mesh = _on_mesh(mesh)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Tuple[TrainState, torch.Tensor]:
        if on_mesh:
            loss, grads = mesh_value_and_grad(cfg, mesh, seq_sharded, state.params, None, batch)
        else:
            loss, grads = _value_and_grad(
                lambda: sft_loss(state.params, cfg, batch["tokens"], batch["loss_mask"]),
                state.params,
            )
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = apply_updates(state.params, updates)
        return TrainState(params=params, opt_state=opt_state, step=state.step + 1), loss

    return train_step


def make_lora_train_step(
    cfg: llama.LlamaConfig,
    lora_cfg: Any,  # models.lora.LoRAConfig
    optimizer: AdamW,
    seq_sharded: bool = False,
    mesh: Optional[Mesh] = None,
) -> Callable[[TrainState, llama.Params, Dict[str, torch.Tensor]], Tuple[TrainState, torch.Tensor]]:
    """LoRA fine-tune step: the base params are a frozen input (no grad,
    never updated), ``state.params`` holds only the adapters, so the
    optimizer's moments stay adapter-sized. On ``mesh`` the sharded step:
    the base cut by ``sharding.shard_params(..., mesh)``, the adapters by
    ``lora.shard_lora_params(..., mesh)``."""
    on_mesh = _on_mesh(mesh)
    resident = _Resident()

    def train_step(
        state: TrainState, base_params: llama.Params, batch: Dict[str, torch.Tensor]
    ) -> Tuple[TrainState, torch.Tensor]:
        if on_mesh:
            loss, grads = mesh_value_and_grad(cfg, mesh, seq_sharded, state.params,
                                              resident.of(base_params), batch, lora_cfg.scale)
        else:
            base = frozen(base_params)
            loss, grads = _value_and_grad(
                lambda: sft_loss(base, cfg, batch["tokens"], batch["loss_mask"],
                                 lora=state.params, lora_scale=lora_cfg.scale),
                state.params,
            )
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = apply_updates(state.params, updates)
        return TrainState(params=params, opt_state=opt_state, step=state.step + 1), loss

    return train_step


# --------------------------------------------------------------------- #
# the step on a mesh


def _on_mesh(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and (mesh.size > 1 or mesh.processes > 1)


def _place(tree, tp_mesh: Mesh, leaf: bool):
    """The state's tree on a (replica, seq shard) position: piece ``i`` of
    a :class:`Shards` on ``tp_mesh.devices[i]``, a whole tensor on its
    first device (``.to``: no copy on the same device); under ``leaf``
    each tensor a fresh autograd leaf of this position's own."""
    def put(t: torch.Tensor, dev) -> torch.Tensor:
        t = t.detach().to(dev)
        return t.requires_grad_(True) if leaf else t

    def walk(x):
        if isinstance(x, Shards):
            return x.like(put(p, d) for p, d in zip(x, tp_mesh.devices))
        if isinstance(x, torch.Tensor):
            return put(x, tp_mesh.home)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return [walk(v) for v in x]

    return walk(tree)


class _Resident:
    """A LoRA step's frozen base, placed on each (replica, seq shard)
    position the first time a step asks for it there and kept while the
    step is given the same base (the same tree object)."""

    def __init__(self):
        self.base = None
        self.placed: Dict[Tuple[str, ...], Any] = {}

    def of(self, base):
        if base is not self.base:
            self.base, self.placed = base, {}
        return self

    def at(self, tp_mesh: Mesh):
        key = tuple(str(torch.device(d)) for d in tp_mesh.devices)
        if key not in self.placed:
            self.placed[key] = _place(self.base, tp_mesh, leaf=False)
        return self.placed[key]


def _tp(tp_mesh: Mesh):
    return tp_kernels.TPContext(tp_mesh, tp_mesh.size) if tp_mesh.size > 1 else None


def _replica_numerator(cfg, mesh: Mesh, d: int, n_seq: int, params, base, tokens, loss_mask,
                       lora_scale: float) -> torch.Tensor:
    """Replica ``d``'s ``sum(nll * mask)`` over its rows (f32, on its first
    device), its sequence cut over ``n_seq`` shards."""
    B, T = tokens.shape
    if T % n_seq:
        raise ValueError(f"sequence of {T} not divisible by {n_seq} seq shards")
    tl = T // n_seq
    meshes = [mesh.tp_mesh(d, s) for s in range(n_seq)]
    weights = base if base is not None else params
    toks = [tokens[:, s * tl:(s + 1) * tl].to(m.home) for s, m in enumerate(meshes)]
    pos = [torch.arange(s * tl, (s + 1) * tl, device=m.home).expand(B, tl)
           for s, m in enumerate(meshes)]
    logits = llama.forward_seq(weights, cfg, toks, pos, remat=True,
                               lora=params if base is not None else None,
                               lora_scale=lora_scale, tps=[_tp(m) for m in meshes])
    total = None
    for s, m in enumerate(meshes):
        # the targets of shard s's positions: the next token, the first of
        # shard s + 1 for its last position (none for the last shard's)
        targets = tokens[:, s * tl + 1:(s + 1) * tl + 1].long().to(m.home)
        mask = loss_mask[:, s * tl + 1:(s + 1) * tl + 1].float().to(m.home)
        logp = torch.log_softmax(logits[s][:, :targets.shape[1]].float(), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        part = torch.sum(nll * mask).to(meshes[0].home)
        total = part if total is None else total + part
    return total


def mesh_value_and_grad(cfg: llama.LlamaConfig, mesh: Mesh, seq_sharded: bool, params,
                        base, batch: Dict[str, torch.Tensor], lora_scale: float = 1.0):
    """JAX's sharded ``value_and_grad`` of ``sft_loss`` on ``mesh``: this
    process's rows (``batch``, cut on ``data`` over its replicas), the
    global masked mean, the gradients summed over every position and
    process (module docstring). ``params`` are the trained leaves (the
    model for SFT, the adapters for LoRA over the frozen ``base``: a tree
    cut as the state is, or a step's :class:`_Resident` placements of
    it); returns ``(loss, grads)`` on the state's devices."""
    replicas = mesh.process_replicas(multihost.process_index())
    # JAX's token_spec: the batch on data, the sequence on seq when sharded
    n_seq = mesh.seq if sharding.token_spec(seq_sharded)[1] == SEQ_AXIS else 1
    tokens, loss_mask = batch["tokens"], batch["loss_mask"]
    if tokens.shape[0] % len(replicas):
        raise ValueError(f"batch of {tokens.shape[0]} rows not divisible by "
                         f"{len(replicas)} data replicas")
    b = tokens.shape[0] // len(replicas)
    if base is not None and not isinstance(base, _Resident):
        base = _Resident().of(base)
    home = sharding.model_mesh(mesh).home
    count = multihost.all_reduce_sum(loss_mask[:, 1:].float().sum().to(home))
    denom = torch.clamp(count, min=1.0)
    acc = loss = None
    for j, d in enumerate(replicas):
        rows = slice(j * b, (j + 1) * b)
        placed = [_place(params, mesh.tp_mesh(d, s), leaf=True) for s in range(n_seq)]
        bases = None if base is None else [base.at(mesh.tp_mesh(d, s)) for s in range(n_seq)]
        part = _replica_numerator(cfg, mesh, d, n_seq, placed, bases, tokens[rows],
                                  loss_mask[rows], lora_scale) / denom.to(mesh.tp_mesh(d, 0).home)
        leaves = [t for tree in placed for t in tree_leaves(tree)]
        grads = iter(torch.autograd.grad(part, leaves, allow_unused=True))
        for tree in placed:  # (replica, seq shard) order, in f32 on the state's devices
            g = tree_map(lambda p: _grad_or_zeros(next(grads), p), tree)
            acc = (tree_map(lambda c, x: x.to(c.device, torch.float32), params, g) if acc is None
                   else tree_map(lambda a, x: a + x.to(a.device, torch.float32), acc, g))
        part = part.detach().to(home, torch.float32)
        loss = part if loss is None else loss + part
    if mesh.processes > 1:
        acc, loss = _all_reduce_tree(acc, loss)
    return loss, tree_map(lambda g, p: g.to(p.dtype), acc, params)


def _grad_or_zeros(g: Optional[torch.Tensor], p: torch.Tensor) -> torch.Tensor:
    # a leaf the loss never reads gets zeros, as from jax.grad
    return torch.zeros_like(p) if g is None else g


def _all_reduce_tree(grads, loss: torch.Tensor):
    """The f32 gradients and the loss summed across processes, in one
    ``all_reduce`` of them flattened on the loss's device."""
    leaves = tree_leaves(grads)
    flat = torch.cat([t.reshape(-1).to(loss.device) for t in leaves] + [loss.reshape(1)])
    flat = multihost.all_reduce_sum(flat)
    out, at = [], 0
    for t in leaves:
        out.append(flat[at:at + t.numel()].view_as(t).to(t.device))
        at += t.numel()
    it = iter(out)
    return tree_map(lambda _: next(it), grads), flat[at]
