"""Metric loggers: CSV, console, and the optional tracking backends.

Counterpart of ``pita_tpu/io/logging.py``: one interface,
``log_metrics(dict, step)`` and ``log_image(name, images, step)``, with the
backends of the reference's ``configs/logger/*.yaml``. CSV and console are
always there; TensorBoard (through ``torch.utils.tensorboard``), wandb,
MLflow, Neptune, Comet and Aim import their package when built, and
``make_logger`` skips one whose package is missing with a printed line, as
``pita_tpu`` does.
"""

import csv
import os
from typing import Optional


class CSVLogger:
    """One row per ``log_metrics`` call in ``out_dir/metrics.csv``, columns
    ``step``, ``launch`` and every metric name seen so far."""

    def __init__(self, out_dir: str, filename: str = "metrics.csv", resume: bool = False):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, filename)
        self._fieldnames = ["step", "launch"]
        self._rows = []
        # a resumed run appends to the existing history; a fresh run on a
        # reused out_dir starts clean
        if resume and os.path.exists(self.path):
            with open(self.path, newline="") as f:
                reader = csv.DictReader(f)
                if reader.fieldnames:
                    self._fieldnames = list(reader.fieldnames)
                    if "launch" not in self._fieldnames:
                        self._fieldnames.insert(1, "launch")
                    self._rows = [{k: v for k, v in row.items() if v not in (None, "")}
                                  for row in reader]
        # a new id per process, so that rows repeated by a restarted run are
        # told apart from progress
        prev = [int(float(r["launch"])) for r in self._rows if r.get("launch")]
        self.launch_id = (max(prev) + 1) if prev else (1 if self._rows else 0)

    def log_metrics(self, metrics: dict, step: int = 0):
        row = {"step": step, "launch": self.launch_id,
               **{k: float(v) for k, v in metrics.items()}}
        self._rows.append(row)
        for k in row:
            if k not in self._fieldnames:
                self._fieldnames.append(k)
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames)
            w.writeheader()
            w.writerows(self._rows)

    def log_image(self, name: str, images, step: int = 0):
        pass  # the plotting module saves the figures itself


class ConsoleLogger:
    def __init__(self, every: int = 1):
        self.every = every

    def log_metrics(self, metrics: dict, step: int = 0):
        if step % self.every == 0:
            parts = " ".join(f"{k}={float(v):.4g}" for k, v in metrics.items())
            print(f"[step {step}] {parts}")

    def log_image(self, name, images, step=0):
        pass


class WandbLogger:
    """Needs the wandb package (configs/logger/wandb.yaml)."""

    def __init__(self, project: str, name: Optional[str] = None, config: Optional[dict] = None):
        import wandb

        self._wandb = wandb
        self.run = wandb.init(project=project, name=name, config=config)

    def log_metrics(self, metrics: dict, step: int = 0):
        self._wandb.log(dict(metrics), step=step)

    def log_image(self, name, images, step: int = 0):
        self._wandb.log({name: [self._wandb.Image(im) for im in images]}, step=step)


class TensorBoardLogger:
    """Event files under ``out_dir/tb`` (configs/logger/tensorboard.yaml);
    needs the tensorboard package."""

    def __init__(self, out_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir=os.path.join(out_dir, "tb"))

    def log_metrics(self, metrics: dict, step: int = 0):
        for k, v in metrics.items():
            self.writer.add_scalar(k, float(v), global_step=step)
        self.writer.flush()

    def log_image(self, name, images, step: int = 0):
        import numpy as np

        for i, im in enumerate(images):
            arr = np.asarray(im)
            if arr.ndim == 3 and arr.shape[-1] in (3, 4):
                self.writer.add_image(f"{name}/{i}", arr[..., :3], global_step=step,
                                      dataformats="HWC")


class MLflowLogger:
    """A file store under ``out_dir/mlruns`` (configs/logger/mlflow.yaml);
    needs the mlflow package."""

    def __init__(self, out_dir: str, experiment: str = "pita_tpu"):
        import mlflow

        self._mlflow = mlflow
        mlflow.set_tracking_uri(f"file:{os.path.join(out_dir, 'mlruns')}")
        mlflow.set_experiment(experiment)
        self._run = mlflow.start_run()

    def log_metrics(self, metrics: dict, step: int = 0):
        self._mlflow.log_metrics({k.replace("/", "_"): float(v) for k, v in metrics.items()},
                                 step=step)

    def log_image(self, name, images, step: int = 0):
        pass


class NeptuneLogger:
    """configs/logger/neptune.yaml; needs the neptune package."""

    def __init__(self, project: str = "pita_tpu", **kw):
        import neptune

        self._run = neptune.init_run(project=project, **kw)

    def log_metrics(self, metrics: dict, step: int = 0):
        for k, v in metrics.items():
            self._run[k].append(float(v), step=step)

    def log_image(self, name, images, step: int = 0):
        pass


class CometLogger:
    """configs/logger/comet.yaml; needs the comet_ml package."""

    def __init__(self, project: str = "pita_tpu", **kw):
        import comet_ml

        self._exp = comet_ml.Experiment(project_name=project, **kw)

    def log_metrics(self, metrics: dict, step: int = 0):
        self._exp.log_metrics({k: float(v) for k, v in metrics.items()}, step=step)

    def log_image(self, name, images, step: int = 0):
        for im in images:
            self._exp.log_image(im, name=name, step=step)


class AimLogger:
    """A repository under ``out_dir`` (configs/logger/aim.yaml); needs the aim package."""

    def __init__(self, out_dir: str, experiment: str = "pita_tpu"):
        from aim import Run

        self._run = Run(repo=out_dir, experiment=experiment)

    def log_metrics(self, metrics: dict, step: int = 0):
        for k, v in metrics.items():
            self._run.track(float(v), name=k, step=step)

    def log_image(self, name, images, step: int = 0):
        pass


class MultiLogger:
    def __init__(self, loggers):
        self.loggers = list(loggers)

    def log_metrics(self, metrics, step=0):
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def log_image(self, name, images, step=0):
        for lg in self.loggers:
            lg.log_image(name, images, step)


def make_logger(out_dir: str, kinds=("csv",), resume: bool = False, **kw) -> MultiLogger:
    """A MultiLogger of the named backends (logging.py:199-231); ``kw`` go
    to the optional backends' constructors. A backend whose package is
    missing is skipped with a printed line."""
    backends = []
    for kind in kinds:
        if kind == "csv":
            backends.append(CSVLogger(out_dir, resume=resume))
        elif kind == "console":
            backends.append(ConsoleLogger())
        elif kind in ("tensorboard", "wandb", "mlflow", "neptune", "comet", "aim"):
            try:
                if kind == "tensorboard":
                    backends.append(TensorBoardLogger(out_dir))
                elif kind in ("mlflow", "aim"):
                    cls = MLflowLogger if kind == "mlflow" else AimLogger
                    backends.append(cls(out_dir, **kw))
                else:
                    cls = {"wandb": WandbLogger, "neptune": NeptuneLogger,
                           "comet": CometLogger}[kind]
                    backends.append(cls(**kw))
            except ImportError:
                print(f"{kind} not available; skipping")
        else:
            raise ValueError(f"unknown logger kind {kind}")
    return MultiLogger(backends)
