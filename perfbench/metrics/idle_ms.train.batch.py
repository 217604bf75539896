"""idle_ms.train.batch (ms): the card's idle time inside the program's
`train.batch` spans (draw_step, buffer_sample and the augments), per optimizer
step: each gap between device operations in the traced window, split by its
overlap with those spans, summed, over the number of `train.step` spans. Layer:
the training step (pita_torch/train/trainer.py)."""

from perfbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "train.batch", "train.step")
