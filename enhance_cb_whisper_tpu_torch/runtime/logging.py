"""Metrics logging: stdout + MLflow-compatible file layout + optional real
MLflow client (a copy of enhance_cb_whisper_tpu/runtime/logging.py).

The reference logs through MLFlowLogger with a ``tracking_uri``
(configs/train.yaml:9-15, ``log_model: true``).  The same information is
always written locally —
``<dir>/metrics.jsonl`` (one record per log call: step, epoch, metrics) and
``params.json``, which an MLflow importer can ingest — and, when a
``tracking_uri`` is given AND the ``mlflow`` package is importable, mirror
every call to a real MLflow run (networked deployments).  Logging failures
are swallowed like the reference's NewConnectionError catches
(src/efficient_kws/model.py:293-294)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, directory: Optional[str] = None, run_name: str = "run",
                 experiment_name: str = "default", tags: Optional[dict] = None,
                 verbose: bool = True, tracking_uri: Optional[str] = None,
                 mlflow_module=None, log_model: bool = False):
        self.directory = directory
        self.verbose = verbose
        self.log_model = log_model  # MLFlowLogger(log_model=True) surface:
        # engines pass newly saved checkpoint dirs to log_artifact
        self._fh = None
        if directory is not None:
            os.makedirs(directory, exist_ok=True)
            self._fh = open(os.path.join(directory, "metrics.jsonl"), "a")
            with open(os.path.join(directory, "run.json"), "w") as f:
                json.dump(
                    {"run_name": run_name, "experiment_name": experiment_name,
                     "tags": tags or {}, "start_time": time.time(),
                     "tracking_uri": tracking_uri},
                    f,
                )

        # optional real MLflow client (reference MLFlowLogger surface);
        # import-guarded — the local file layout above is always written
        self._mlflow = None
        if tracking_uri is not None:
            try:
                mlflow = mlflow_module
                if mlflow is None:
                    import mlflow  # noqa: F811
                mlflow.set_tracking_uri(tracking_uri)
                mlflow.set_experiment(experiment_name)
                mlflow.start_run(run_name=run_name, tags=tags or {})
                self._mlflow = mlflow
            except Exception as e:  # unreachable server / missing package
                print(f"mlflow client unavailable ({e}); file logging only")

    def log_params(self, params: dict) -> None:
        if self.directory is not None:
            try:
                with open(os.path.join(self.directory, "params.json"), "w") as f:
                    json.dump(params, f, indent=2, default=str)
            except OSError:
                pass
        if self._mlflow is not None:
            try:
                self._mlflow.log_params(params)
            except Exception:
                pass

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None,
                    epoch: Optional[int] = None) -> None:
        record = {"time": time.time(), "step": step, "epoch": epoch,
                  "metrics": {k: float(v) for k, v in metrics.items()}}
        if self._fh is not None:
            try:
                self._fh.write(json.dumps(record) + "\n")
                self._fh.flush()
            except OSError:
                pass
        if self._mlflow is not None:
            try:
                self._mlflow.log_metrics(
                    {k: float(v) for k, v in metrics.items()}, step=step
                )
            except Exception:
                pass
        if self.verbose:
            parts = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
            prefix = f"[epoch {epoch}]" if epoch is not None else ""
            print(f"{prefix} {parts}")

    def log_artifact(self, path: str) -> None:
        """Record a checkpoint/artifact path (reference
        ``MLFlowLogger(log_model=true)``, configs/train.yaml:14): appended to
        ``artifacts.jsonl`` locally and mirrored via ``mlflow.log_artifacts``
        when the client is live."""
        if self.directory is not None:
            try:
                with open(os.path.join(self.directory, "artifacts.jsonl"), "a") as f:
                    f.write(json.dumps({"time": time.time(), "path": path}) + "\n")
            except OSError:
                pass
        if self._mlflow is not None:
            try:
                if os.path.isdir(path):
                    self._mlflow.log_artifacts(path, artifact_path=os.path.basename(path))
                else:
                    self._mlflow.log_artifact(path)
            except Exception:
                pass

    def close(self):
        if self._fh is not None:
            self._fh.close()
        if self._mlflow is not None:
            try:
                self._mlflow.end_run()
            except Exception:
                pass
