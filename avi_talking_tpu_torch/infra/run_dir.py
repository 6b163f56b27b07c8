"""Run-directory management, config snapshots, early stopping (a copy of
``avi_talking_tpu/infra/run_dir.py``: plain Python).

Equivalent of the reference training apps' run management
(inferno_apps/TalkingHead/training/train_talking_head.py:432-453: timestamped
``<time>_<random_id>_<experiment>`` run dirs; :503-509: cfg.yaml snapshot
with .bak backup of a pre-existing one) and the Lightning EarlyStopping
callback wiring (training_pass.py:309-315: monitor val loss, mode min,
configurable patience).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import secrets
from pathlib import Path
from typing import Any, Dict, Optional


def create_run_dir(
    output_dir: os.PathLike,
    experiment_name: str,
    config: Any = None,
    resume_from: Optional[os.PathLike] = None,
) -> Path:
    """Create ``<output_dir>/<timestamp>_<id>_<experiment>`` and snapshot the
    config into it (cfg.json; an existing one is backed up to cfg.json.bak).

    ``resume_from`` reuses an existing run dir instead (recording the
    previous location like the reference's ``previous_run_dir``).
    """
    if resume_from is not None:
        run_dir = Path(resume_from)
        run_dir.mkdir(parents=True, exist_ok=True)
    else:
        stamp = datetime.datetime.now().strftime("%Y_%m_%d_%H-%M-%S")
        run_dir = Path(output_dir) / f"{stamp}_{secrets.token_hex(4)}_{experiment_name}"
        run_dir.mkdir(parents=True, exist_ok=False)
    (run_dir / "checkpoints").mkdir(exist_ok=True)
    if config is not None:
        snapshot_config(run_dir, config)
    return run_dir


def snapshot_config(run_dir: os.PathLike, config: Any) -> Path:
    """Write cfg.json (backing up any existing snapshot to cfg.json.bak)."""
    run_dir = Path(run_dir)
    cfg_file = run_dir / "cfg.json"
    if cfg_file.exists():
        cfg_file.rename(cfg_file.with_name(cfg_file.name + ".bak"))
    cfg_file.write_text(json.dumps(_to_jsonable(config), indent=2, sort_keys=True))
    return cfg_file


def load_config_snapshot(run_dir: os.PathLike) -> Dict[str, Any]:
    return json.loads((Path(run_dir) / "cfg.json").read_text())


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "item") and getattr(obj, "ndim", 1) == 0:
        return obj.item()
    return repr(obj)


@dataclasses.dataclass
class EarlyStopping:
    """Min-mode early stopping on a monitored metric (Lightning semantics:
    stop after ``patience`` consecutive evaluations without an improvement
    of at least ``min_delta``)."""

    patience: int = 3
    min_delta: float = 0.0

    best: float = float("inf")
    bad_evals: int = 0
    stopped: bool = False

    def update(self, value: float) -> bool:
        """Record one evaluation; returns True when training should stop."""
        if value < self.best - self.min_delta:
            self.best = value
            self.bad_evals = 0
        else:
            self.bad_evals += 1
            if self.bad_evals >= self.patience:
                self.stopped = True
        return self.stopped
