"""The products of PITA's DiT3D, fixed by the algorithm and the widths,
frozen for the aldp cell's ``mfu_pct.aldp``.

A forward at S tokens (atoms), hidden F, condition C, L blocks, MLP ratio
r, frequency width Q and n_s coordinates an atom, in multiply-adds a chain:

- a block: per token the q, k, v projection (3F²), the output projection
  (F²) and the MLP (2rF²); attention's two contractions (2S²F); the
  modulation (6CF) once a chain;
- the embedding of the coordinates (S·n_s·F); the t and temperature
  embedders, each Q·C + C²; the final modulation (2CF) and map (S·F·n_s).

At aldp's widths (S 22, F 128, C 128, L 6, r 4, Q 256, n_s 3): a block
4,547,584 (22 × 196,608 + 123,904 + 98,304), the rest 147,968, a forward
27,433,472. A chain·step of the sampler with the exact trace by D VJPs is
1 + 2 + 2D forward-equivalents: the score's forward, the energy's forward
and its input gradient, and D VJPs of a forward and a backward each; 135
at D = 66.
"""

from perfbench.frozen.bounds import PEAK_BF16  # noqa: F401  (the mfu's peak)


def dit_forward_macs(n_tokens=22, hidden=128, cond=128, n_blocks=6, mlp_ratio=4, freq_dim=256,
                     n_spatial=3, temperature=True):
    """Multiply-adds of one DiT3D forward, a chain."""
    block = (n_tokens * (4 * hidden * hidden + 2 * mlp_ratio * hidden * hidden)
             + 2 * n_tokens * n_tokens * hidden + 6 * cond * hidden)
    embedders = (2 if temperature else 1) * (freq_dim * cond + cond * cond)
    ends = 2 * n_tokens * n_spatial * hidden + 2 * cond * hidden  # embedding, final layer
    return n_blocks * block + embedders + ends


def forwards_per_chain_step(dim):
    """Forward-equivalents a chain·step with the exact trace by ``dim`` VJPs."""
    return 1 + 2 + 2 * dim


def flops_per_chain_step(cfg):
    """Two operations a multiply-add, over a chain·step at the
    configuration's widths."""
    macs = dit_forward_macs(cfg["n_particles"], cfg["hidden_size"], cfg["cond_dim"],
                            cfg["n_blocks"], cfg["mlp_ratio"], cfg["freq_dim"], 3,
                            cfg["condition_on_temperature"])
    return 2 * macs * forwards_per_chain_step(3 * cfg["n_particles"])
