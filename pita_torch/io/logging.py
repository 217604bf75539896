"""Metric loggers: CSV and console.

Counterpart of ``pita_tpu/io/logging.py:14-70,207-231`` (``CSVLogger``,
``ConsoleLogger``, ``MultiLogger``, ``make_logger``). The other backends
(wandb, tensorboard, mlflow, neptune, comet, aim) are not ported;
``make_logger`` raises on their names.
"""

import csv
import os


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


class ConsoleLogger:
    def __init__(self, every: int = 1):
        self.every = every

    def log_metrics(self, metrics: dict, step: int = 0):
        if step % self.every == 0:
            parts = " ".join(f"{k}={float(v):.4g}" for k, v in metrics.items())
            print(f"[step {step}] {parts}")


class MultiLogger:
    def __init__(self, loggers):
        self.loggers = list(loggers)

    def log_metrics(self, metrics, step=0):
        for lg in self.loggers:
            lg.log_metrics(metrics, step)


def make_logger(out_dir: str, kinds=("csv",), resume: bool = False) -> MultiLogger:
    backends = []
    for kind in kinds:
        if kind == "csv":
            backends.append(CSVLogger(out_dir, resume=resume))
        elif kind == "console":
            backends.append(ConsoleLogger())
        else:
            raise ValueError(f"logger {kind!r} is not ported (csv and console are)")
    return MultiLogger(backends)
