"""Chirality detection and correction for molecular samples (numpy).

Counterpart of ``pita_tpu/utils/chirality.py``: the bond graph from
element-pair distance cutoffs, chirality centres (carbons with four
substituents whose branches all differ), the sign of each sample's signed
substituent volume, and the mirroring of samples whose chirality flipped.
``pita_tpu`` finds the branches with networkx; here the branch fingerprints
(breadth-first depths from each neighbour with the centre removed) come from
a plain breadth-first search over an adjacency list, with the nodes and
neighbours in networkx's order (first appearance in the bond list), so the
centres and their neighbour order come out the same.
"""

from collections import deque
from typing import List, Sequence, Tuple

import numpy as np

# covalent distance cutoffs [nm] by element pair
_CUTOFF = {("C", "C"): 0.18, ("C", "N"): 0.17, ("C", "O"): 0.16, ("C", "H"): 0.13,
           ("N", "H"): 0.12, ("O", "H"): 0.11, ("N", "N"): 0.16, ("N", "O"): 0.16}


def bonds_from_distances(x: np.ndarray, elements: Sequence[str]) -> List[Tuple[int, int]]:
    """Infer the bond graph from one structure by element-pair cutoffs."""
    n = len(elements)
    bonds = []
    for i in range(n):
        for j in range(i + 1, n):
            cut = _CUTOFF.get(tuple(sorted((elements[i][0], elements[j][0]))), 0.0)
            if cut and np.linalg.norm(x[i] - x[j]) < cut:
                bonds.append((i, j))
    return bonds


def _graph(bonds):
    """Adjacency lists keyed by node, nodes and neighbours in order of first
    appearance in ``bonds``, without repeated edges."""
    adj = {}
    for a, b in bonds:
        adj.setdefault(a, [])
        adj.setdefault(b, [])
        if b not in adj[a]:
            adj[a].append(b)
            adj[b].append(a)
    return adj


def _depths(adj, src, removed):
    """Breadth-first depths from ``src`` in the graph without ``removed``."""
    depth = {src: 0}
    q = deque([src])
    while q:
        a = q.popleft()
        for b in adj[a]:
            if b != removed and b not in depth:
                depth[b] = depth[a] + 1
                q.append(b)
    return depth


def find_chirality_centers(bonds: Sequence[Tuple[int, int]], elements: Sequence[str]):
    """Carbons with 4 substituents whose branches are all distinct, each with
    its neighbours in the order of their branch fingerprints."""
    adj = _graph(bonds)
    centers = []
    for c, nbs in adj.items():
        if elements[c][0] != "C" or len(nbs) != 4:
            continue
        fingerprints = []
        for nb in nbs:
            # depth-annotated element fingerprint of the branch
            fp = tuple(sorted((d, elements[a][0]) for a, d in _depths(adj, nb, c).items()))
            fingerprints.append((fp, nb))
        if len({f for f, _ in fingerprints}) == 4:
            centers.append((c, tuple(nb for _, nb in sorted(fingerprints))))
    return centers


def chirality_sign(x: np.ndarray, center: int, nbrs: Sequence[int]) -> np.ndarray:
    """Sign of the signed volume of the substituent frame; x: (..., N, 3)."""
    v1 = x[..., nbrs[0], :] - x[..., center, :]
    v2 = x[..., nbrs[1], :] - x[..., center, :]
    v3 = x[..., nbrs[2], :] - x[..., center, :]
    return np.sign(np.sum(np.cross(v1, v2) * v3, axis=-1))


def check_and_fix_chirality(x: np.ndarray, centers, reference_signs: Sequence[float]):
    """Mirror (z → −z) the samples whose chirality sign flipped at any
    centre. Returns (fixed samples, mask of the mirrored samples)."""
    x = np.asarray(x)
    flipped = np.zeros(x.shape[0], bool)
    for (c, nbrs), ref in zip(centers, reference_signs):
        flipped |= chirality_sign(x, c, nbrs) != ref
    x_fixed = x.copy()
    x_fixed[flipped, :, 2] *= -1.0
    return x_fixed, flipped
