"""idle_ms.train.optimizer (ms): the card's idle time inside the program's
`train.optimizer` spans (the gradient clip, Adam and the update), per optimizer
step: each gap between device operations in the traced window, split by its
overlap with those spans, summed, over the number of `train.step` spans. Layer:
the training step (pita_torch/train/trainer.py)."""

from perfbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "train.optimizer", "train.step")
