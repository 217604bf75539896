"""Atomic checkpoints of a trainer's whole state.

Counterpart of ``pita_tpu/io/checkpoint.py``: one state (the score and
energy weights, their EMA shadows with ``num_updates``, Adam's ``count``,
``mu`` and ``nu``, the stacked per-rung buffers, the generator's state and
the epoch; ``EnergyTempTrainer.state_dict``), and the wall-clock
``TimeIntervalCheckpointer`` (:86-101).

A save never leaves the file at ``path`` half written: the state goes to a
temporary file beside it, is flushed to disk, and ``os.replace`` moves it
over ``path`` in one step, so the previous checkpoint stays whole and
readable until the new one is complete. (``pita_tpu`` saves with orbax's
``force=True``, which deletes the old checkpoint first.) The format is
``torch.save``; restoring reads tensors only (``weights_only``).
"""

import os
import time

import torch


def _write(state, path):
    with open(path, "wb") as f:
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(trainer, path: str):
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        _write(trainer.state_dict(), tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    dir_fd = os.open(os.path.dirname(path), os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def restore_checkpoint(trainer, path: str):
    """Restore in place; a missing path starts from scratch (train.py:99-104)."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        print(f"checkpoint {path} not found — starting from scratch")
        return trainer
    trainer.load_state_dict(torch.load(path, map_location=trainer.device, weights_only=True))
    return trainer


class TimeIntervalCheckpointer:
    """Wall-clock checkpointing for preemptible runs
    (configs/callbacks/time_checkpoint.yaml: every 2h50m)."""

    def __init__(self, trainer, path: str, interval_seconds: float = 2 * 3600 + 50 * 60):
        self.trainer = trainer
        self.path = path
        self.interval = interval_seconds
        self._last = time.time()

    def maybe_save(self):
        if time.time() - self._last >= self.interval:
            save_checkpoint(self.trainer, self.path)
            self._last = time.time()
            return True
        return False
