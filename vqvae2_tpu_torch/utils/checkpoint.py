"""Checkpoints (port of ``vqvae2_tpu/utils/checkpoint.py``): periodic, last
and best, as the JAX package keeps them.

Layout under one directory: ``step_<N>.pt`` (periodic, ``N`` in seven
digits), ``last.pt``, ``best.pt`` with ``best_metric.json``, each written
whole by ``torch.save``, and ``config.json`` holding the configuration that
rebuilds the model.  The trainers save ``{"model": state_dict, "optimizer":
state_dict, "step": int}``; readers take ``state.get("model", state)``.

Under a process group (``parallel``) every rank holds the same state: the
primary rank alone writes, and every rank waits for the write to finish
(``synchronize``) before it goes on, so a rank that reads next finds the file
whole.  Every rank reads, onto its own device (``map_location``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from vqvae2_tpu_torch import parallel as par


class CheckpointManager:
    """Periodic, last and best checkpoints and the model configuration under
    one directory."""

    def __init__(self, directory: str, config: Optional[Dict[str, Any]] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.best_metric = -float("inf")
        if config is not None and par.is_primary():
            with open(os.path.join(self.directory, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)
        par.synchronize()

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def _save(self, name: str, state: Dict[str, Any]) -> None:
        """Write ``state`` (a ``state_dict``, or any dict of tensors and plain
        values) as ``name``; the file appears whole or not at all.  The primary
        rank writes; every rank returns once it is written."""
        if par.is_primary():
            tmp = self._path(name) + ".tmp"
            torch.save(state, tmp)
            os.replace(tmp, self._path(name))
        par.synchronize()

    def save_periodic(self, step: int, state: Dict[str, Any]) -> None:
        self._save(f"step_{step:07d}", state)

    def save_last(self, state: Dict[str, Any]) -> None:
        self._save("last", state)

    def save_best(self, metric: float, state: Dict[str, Any]) -> bool:
        """Keep the checkpoint of the best ``metric`` so far (higher is
        better); returns whether this one was it."""
        if metric > self.best_metric:
            self.best_metric = metric
            if par.is_primary():
                with open(os.path.join(self.directory, "best_metric.json"), "w") as f:
                    json.dump({"metric": float(metric)}, f)
            self._save("best", state)
            return True
        return False

    def restore(self, name: str = "last", map_location="cpu") -> Dict[str, Any]:
        """Load the checkpoint ``name`` ('last', 'best', 'step_0000010') onto
        ``map_location``."""
        path = self._path(name)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return torch.load(path, map_location=map_location, weights_only=True)

    def restore_latest(self, target=None, map_location="cpu") -> Tuple[Any, Optional[str]]:
        """The newest periodic checkpoint, else ``last``, as ``(state, name)``;
        ``(target, None)`` when the directory holds neither, so a trainer can
        pass ``--resume`` on its first launch."""
        latest = self.latest_step()
        name = f"step_{latest:07d}" if latest is not None else "last"
        if not os.path.exists(self._path(name)):
            return target, None
        return self.restore(name, map_location), name

    def load_config(self) -> Optional[Dict[str, Any]]:
        p = os.path.join(self.directory, "config.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return None

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name.endswith(".pt"):
                try:
                    steps.append(int(name[len("step_"):-len(".pt")]))
                except ValueError:
                    pass
        return max(steps) if steps else None
