"""Experiment metrics tracker.

Port of ``cnn_quantization_tpu/utils/tracker.py`` (reference utils/mllog.py:
an mlflow run plus weighted meters): a context manager that always writes the
run's params and metrics as JSON/JSONL under a runs directory, forwards them
to mlflow only where mlflow imports, and keeps the weighted-average meters of
entropy-rate reporting (mllog.py:53-55).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

from .meters import AverageMeter


class MetricsTracker:
    def __init__(self, root: str, experiment: str, args: Any = None, name: str = 'run'):
        self.dir = os.path.join(os.path.expanduser(root), experiment,
                                f'{name}_{int(time.time())}')
        self.meters: dict[str, AverageMeter] = {}
        self.steps: dict[str, int] = {}
        self._args = args
        self._mlflow = None
        self._fh = None

    def __enter__(self):
        os.makedirs(self.dir, exist_ok=True)
        self._fh = open(os.path.join(self.dir, 'metrics.jsonl'), 'a')
        params = {}
        if self._args is not None:
            params = {k: str(v) for k, v in sorted(vars(self._args).items())}
            with open(os.path.join(self.dir, 'params.json'), 'w') as f:
                json.dump(params, f, indent=1)
        try:
            import mlflow
        except ImportError:
            mlflow = None
        if mlflow is not None:
            mlflow.set_tracking_uri(f'file://{os.path.dirname(self.dir)}/mlruns')
            mlflow.start_run()
            if params:
                mlflow.log_params(params)
            self._mlflow = mlflow
        return self

    def log_metric(self, key: str, value: float, step: int | str | None = None,
                   meter_id: str | None = None, weight: float = 1.0):
        if step == 'auto':
            step = self.steps.get(key, 0)
            self.steps[key] = step + 1
        rec = {'key': key, 'value': float(value), 'step': step, 't': time.time()}
        self._fh.write(json.dumps(rec) + '\n')
        if meter_id is not None:
            self.meters.setdefault(meter_id, AverageMeter()).update(value, weight)
        if self._mlflow is not None:
            self._mlflow.log_metric(key.replace('/', '.'), float(value),
                                    step=step if isinstance(step, int) else None)

    def __exit__(self, *exc):
        try:
            for mid, meter in self.meters.items():
                self._fh.write(json.dumps({'key': f'avg.{mid}', 'value': meter.avg}) + '\n')
        finally:
            self._fh.close()
            if self._mlflow is not None:
                self._mlflow.end_run()
        return False
