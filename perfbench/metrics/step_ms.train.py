"""step_ms.train (ms): the median duration of the program's `train.step` spans
in the traced window, one an optimizer step (2 jobs x 10 steps: too few for a
percentile above the median with ten beyond it). Layer: the training step
(pita_torch/train/trainer.py:train_step)."""

from perfbench import spans


def read(ctx):
    return spans.step_ms(ctx, "train.step")
