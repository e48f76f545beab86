"""Save and resume training state: step-numbered directories, keep-N.

Counterpart of generativeaiexamples_tpu/models/checkpoint.py, in the
port's own format (the GPU machine has no orbax, and reading JAX's orbax
directories is not a goal): ``<directory>/<step>/state.pt`` holds the
state as nested dicts and lists of tensors (dataclasses such as
``train.TrainState`` become dicts of their fields), written by
``torch.save`` and read by ``torch.load(weights_only=True)``.

A save writes a temporary directory and renames it into place, so a save
cut short leaves ``latest_step`` at the last whole one; the oldest steps
beyond ``max_to_keep`` are deleted after each save. ``restore`` reads
onto a template of the same structure (for example a freshly initialized
state): every restored tensor takes the template's device, dtype and
``requires_grad``, so one checkpoint resumes on the CPU or on the card.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import shutil
from typing import Any, List, Optional

import torch

logger = logging.getLogger(__name__)

_STATE = "state.pt"


def _to_tree(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _to_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_tree(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach()
    return obj


def _onto(template, saved, where: str = "state"):
    """``saved`` laid onto ``template``'s structure, devices and dtypes."""
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return type(template)(**{
            f.name: _onto(getattr(template, f.name), saved[f.name], f"{where}.{f.name}")
            for f in dataclasses.fields(template)
        })
    if isinstance(template, dict):
        if set(template) != set(saved):
            raise ValueError(f"{where}: keys {sorted(saved)} do not match the template's {sorted(template)}")
        return {k: _onto(v, saved[k], f"{where}.{k}") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(template) != len(saved):
            raise ValueError(f"{where}: {len(saved)} entries, the template has {len(template)}")
        return [_onto(v, s, f"{where}[{i}]") for i, (v, s) in enumerate(zip(template, saved))]
    if isinstance(template, torch.Tensor):
        if tuple(saved.shape) != tuple(template.shape):
            raise ValueError(f"{where}: shape {tuple(saved.shape)}, the template's is {tuple(template.shape)}")
        out = saved.to(device=template.device, dtype=template.dtype)
        return out.requires_grad_(template.requires_grad) if out.is_floating_point() else out
    return saved


class CheckpointManager:
    """Step-numbered training checkpoints under ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self._keep = max(1, int(max_to_keep))
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, str(int(step)))

    def all_steps(self) -> List[int]:
        """Steps with a whole checkpoint, ascending."""
        steps = []
        for name in os.listdir(self._dir):
            if name.isdigit() and os.path.exists(os.path.join(self._dir, name, _STATE)):
                steps.append(int(name))
        return sorted(steps)

    def save(self, step: int, state: Any, wait: bool = False) -> None:
        """Write ``state`` as step ``step`` (synchronously; ``wait`` is
        accepted for the JAX manager's signature)."""
        final = self._path(step)
        tmp = os.path.join(self._dir, f".{int(step)}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(_to_tree(state), os.path.join(tmp, _STATE))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self._keep]:
            shutil.rmtree(self._path(old), ignore_errors=True)
        logger.info("Saved checkpoint step=%d to %s", step, self._dir)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_template: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure, devices and dtypes of
        ``state_template``; the latest step unless ``step`` is given."""
        step = self.latest_step() if step is None else step
        if step is None or not os.path.exists(os.path.join(self._path(step), _STATE)):
            raise FileNotFoundError(f"No checkpoints under {self._dir}"
                                    + ("" if step is None else f" at step {step}"))
        saved = torch.load(os.path.join(self._path(step), _STATE), map_location="cpu",
                           weights_only=True)
        return _onto(state_template, saved)

    def close(self) -> None:
        return None
