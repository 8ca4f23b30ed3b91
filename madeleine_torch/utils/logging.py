"""Metrics logging: ``metrics.jsonl`` always, wandb only when asked for.

Port of `madeleine_tpu/utils/logging.py` (ref observability:
bin/pretrain.py:57-58, setup_components.py:60-83). `MetricsLogger` appends
one JSON object per `log` call, with a wall-clock time, to
``<results_dir>/metrics.jsonl``. With ``use_wandb`` it mirrors each record to
a wandb run whose id persists in ``wandbID.txt``, so that a resumed run
continues the same wandb run; without the wandb package that is an error.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, results_dir: str, use_wandb: bool = False, project: str = "MADELEINE",
                 run_name: Optional[str] = None, config: Optional[Dict[str, Any]] = None,
                 tags=None):
        os.makedirs(results_dir, exist_ok=True)
        self.path = os.path.join(results_dir, "metrics.jsonl")
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError as e:
                raise RuntimeError("--log_ml needs the wandb package, which is not "
                                   "installed; drop --log_ml to log to metrics.jsonl only") from e
            id_path = os.path.join(results_dir, "wandbID.txt")
            resume = None
            run_id = str(uuid.uuid4())
            if os.path.exists(id_path):
                with open(id_path) as f:
                    run_id, resume = f.read().strip(), "allow"
            self._wandb = wandb.init(project=project, name=run_name, id=run_id, config=config,
                                     tags=tags or [], resume=resume)
            with open(id_path, "w") as f:
                f.write(run_id)
        self._f = open(self.path, "a")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        rec = {"time": time.time(), **metrics}
        if step is not None:
            rec["step"] = step
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def summary(self, key: str, value: Any) -> None:
        self.log({f"summary/{key}": value})
        if self._wandb is not None:
            self._wandb.run.summary[key] = value

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
