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
:class:`TrainState` and never writes the tensors it was given. Sharding a
train step over a (data, seq, model) mesh is ROADMAP queue 1 item 15.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

from generativeaiexamples_tpu_torch.models import llama


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
            m_hat = m / bc1.to(m.dtype)
            v_hat = v / bc2.to(v.dtype)
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
    lora=None,
    lora_scale: float = 1.0,
    remat: bool = True,
) -> torch.Tensor:
    """Mean next-token cross entropy over masked positions (f32)."""
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
    cfg: llama.LlamaConfig, optimizer: AdamW,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, torch.Tensor]]:
    """The SFT step over every weight of ``state.params`` (leaves that
    require grad, ``trainable``)."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Tuple[TrainState, torch.Tensor]:
        loss, grads = _value_and_grad(
            lambda: sft_loss(state.params, cfg, batch["tokens"], batch["loss_mask"]), state.params
        )
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = apply_updates(state.params, updates)
        return TrainState(params=params, opt_state=opt_state, step=state.step + 1), loss

    return train_step


def make_lora_train_step(
    cfg: llama.LlamaConfig,
    lora_cfg: Any,  # models.lora.LoRAConfig
    optimizer: AdamW,
) -> Callable[[TrainState, llama.Params, Dict[str, torch.Tensor]], Tuple[TrainState, torch.Tensor]]:
    """LoRA fine-tune step: the base params are a frozen input (no grad,
    never updated), ``state.params`` holds only the adapters, so the
    optimizer's moments stay adapter-sized."""

    def train_step(
        state: TrainState, base_params: llama.Params, batch: Dict[str, torch.Tensor]
    ) -> Tuple[TrainState, torch.Tensor]:
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
