"""Checkpoints of the port's training loops.

A checkpoint is a directory, as the JAX drivers' orbax checkpoints are
(``<run>/checkpoints/best``, ``.../last``), holding one ``state.pt``: a
nested dict of ``state_dict``s, optimizer state, steps and losses, written
with ``torch.save`` and read with ``torch.load(weights_only=True)``. The
port reads no orbax checkpoint and no reference ``.pth`` (ROADMAP Queue 1).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

FILE = "state.pt"


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Write ``state`` to ``path/state.pt``, replacing an earlier one whole
    (written beside it, then renamed)."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, FILE))


def restore_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    return torch.load(os.path.join(path, FILE), map_location=map_location, weights_only=True)
