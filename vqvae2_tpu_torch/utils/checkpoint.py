"""Checkpoints (port of ``vqvae2_tpu/utils/checkpoint.py``; the part code
extraction needs).

Layout: ``<dir>/<name>.pt`` written with ``torch.save`` (``last`` for now;
periodic and best checkpoints come with the training slice), and
``<dir>/config.json`` holding the model's configuration beside the state, so a
checkpoint can rebuild its model.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch


class CheckpointManager:
    """``last`` checkpoint and the model configuration under one directory."""

    def __init__(self, directory: str, config: Optional[Dict[str, Any]] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        if config is not None:
            with open(os.path.join(self.directory, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def save_last(self, state: Dict[str, Any]) -> None:
        """Write ``state`` (a ``state_dict``, or any dict of tensors and plain
        values) as ``last``; the file appears whole or not at all."""
        tmp = self._path("last") + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path("last"))

    def restore(self, name: str = "last", map_location="cpu") -> Dict[str, Any]:
        """Load the checkpoint ``name`` ('last') onto ``map_location``."""
        path = self._path(name)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return torch.load(path, map_location=map_location, weights_only=True)

    def load_config(self) -> Optional[Dict[str, Any]]:
        p = os.path.join(self.directory, "config.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return None
