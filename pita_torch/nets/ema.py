"""Exponential moving average of a backbone's weights.

Counterpart of ``pita_tpu/nets/ema.py:21-29``: shadow weights with the
warmup decay ``min(decay, (1+n)/(10+n))``, updated after every optimizer
step and used for evaluation. The shadow is a backbone of its own on the
route the backbone's sampler uses (``sampler_route``: ``"kernels"`` for a
3-D EGNN, so the sampler runs it through the CUDA kernels); the update
writes its weights in place, which bumps their versions and makes the
layers repack their kernel buffers (``EGCL.packed``) at the next use.
"""

import numpy as np
import torch


class EMA:
    """Shadow weights (``module``) and the number of updates so far."""

    def __init__(self, net, num_updates: int = 0):
        self.module = net.with_route(net.sampler_route)
        self.num_updates = num_updates

    def decay_at(self, n: int, decay: float) -> float:
        """The decay of update n, rounded to f32 as pita_tpu computes it."""
        return float(np.minimum(np.float32(decay), np.float32(1.0 + n) / np.float32(10.0 + n)))

    @torch.no_grad()
    def update(self, net, decay: float):
        """shadow ← shadow·d + weights·(1−d) (ema.py:25-29)."""
        n = self.num_updates + 1
        d = self.decay_at(n, decay)
        keep = float(np.float32(1.0) - np.float32(d))
        for s, p in zip(self.module.parameters(), net.parameters()):
            s.mul_(d).add_(p.detach() * keep)
        self.num_updates = n
