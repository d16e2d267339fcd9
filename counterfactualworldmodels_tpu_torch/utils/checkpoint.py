"""Checkpoint save / load / resume. Port of
counterfactualworldmodels_tpu/utils/checkpoint.py, with ``torch.save`` in
place of orbax.

``save_params`` writes a state dict; ``save_train_state`` a training state
(the step, the model's state dict and the optimizer's, whose moments keep
their dtypes: a bf16 first moment stays bf16). ``restore_train_state``
loads into a template state (a freshly initialised one: the model and
optimizer to fill) and returns it. ``CheckpointManager`` keeps step
directories ``step_000000123/`` under one directory, drops all but the
newest ``max_to_keep`` and restores the latest. Every write goes to a
temporary file that is renamed into place, so an interrupted save leaves
no checkpoint that looks whole.

Under tensor parallelism (a model with a ``tp_plan``, parallel/tensor.py)
a training state holds this rank's shards: saving gathers the full
reference-layout state dict and the full AdamW moments over the tp group
(JAX's ``jax.device_get`` of the sharded arrays), so every rank of that
group calls it and rank 0 alone writes. A trainer restores into its
unsharded state and then shards it, so a checkpoint resumes at any tp
size.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..parallel.tensor import full_optimizer_state_dict, full_state_dict

STATE_FILE = 'train_state.pt'


def _save(obj, path: str) -> None:
    path = os.path.abspath(path)
    tmp = f'{path}.{os.getpid()}.tmp'
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu(sd: Dict) -> Dict:
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
            for k, v in sd.items()}


def save_params(path: str, params: Dict[str, torch.Tensor]) -> None:
    """Save a state dict to the file ``path``."""
    _save(_cpu(params), path)


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """The state dict saved by :func:`save_params`, on the CPU."""
    return torch.load(os.path.abspath(path), map_location='cpu',
                      weights_only=True)


def _is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def gathers_for_rank0(model) -> bool:
    """Whether this rank joins rank 0's checkpoint gathers: it is in rank
    0's tp group of a tensor-parallel model."""
    plan = getattr(model, 'tp_plan', None)
    return plan is not None and 0 in dist.get_process_group_ranks(plan.group)


def _payload(state) -> Dict:
    return {'step': int(state.step),
            'model': _cpu(full_state_dict(state.model)),
            'opt_state': full_optimizer_state_dict(state.opt_state,
                                                   state.model)}


def save_train_state(path: str, state) -> None:
    """Save a training.TrainState (step, model, optimizer) to ``path``, at
    full size: under tensor parallelism every rank of rank 0's tp group
    calls this (the gather) and rank 0 alone writes."""
    payload = _payload(state)
    if _is_rank0():
        _save(payload, path)


def restore_train_state(path: str, template):
    """Load a state saved by :func:`save_train_state` into ``template``'s
    model and optimizer (in place, on their device) and return the
    template with the saved step. The template is unsharded: a trainer
    restores, then shards (training/train.py's shard_state), so a
    checkpoint resumes at any tp."""
    saved = torch.load(os.path.abspath(path), map_location='cpu',
                       weights_only=True)
    template.model.load_state_dict(saved['model'], strict=True)
    template.opt_state.load_state_dict(saved['opt_state'])
    template.step = int(saved['step'])
    return template


class CheckpointManager:
    """Rolling checkpoint directory with step-indexed saves and resume."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f'step_{step:09d}')

    def all_steps(self):
        """The steps with a whole checkpoint, in order."""
        steps = []
        for name in os.listdir(self.directory):
            if not name.startswith('step_'):
                continue
            try:
                step = int(name.split('_')[1])
            except ValueError:
                continue
            if os.path.exists(os.path.join(self.directory, name,
                                           STATE_FILE)):
                steps.append(step)
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> None:
        """Checkpoint ``state`` as step ``step`` (every rank of rank 0's tp
        group calls this under tensor parallelism; rank 0 writes)."""
        payload = _payload(state)
        if not _is_rank0():
            return
        d = self._step_dir(step)
        os.makedirs(d, exist_ok=True)
        _save(payload, os.path.join(d, STATE_FILE))
        steps = self.all_steps()
        # keep at least the checkpoint just written
        drop = (steps[:-self.max_to_keep] if self.max_to_keep > 0
                else steps[:-1])
        for old in drop:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def restore_latest(self, template):
        """The template restored from the latest checkpoint, or None when
        there is none."""
        step = self.latest_step()
        if step is None:
            return None
        return restore_train_state(os.path.join(self._step_dir(step),
                                                STATE_FILE), template)
