"""Per-particle atom-type features for molecule-aware backbones.

Counterpart of ``pita_tpu/nets/atom_features.py``: every atom of a peptide
gets a type of its own, except the hydrogens bonded to one parent atom (the
methyl groups' symmetric hydrogens), which share one type per parent. The
topology is ``pita_torch.targets.alp.build_peptide_topology``'s dict.
"""

from typing import Tuple


def peptide_atom_types(topology) -> Tuple[int, ...]:
    """Integer type per atom; hydrogens of one parent atom share a type."""
    types = topology["types"]
    parent = {}
    for a, b in topology["bonds"]:
        if types[a].startswith("H"):
            parent[a] = b
        if types[b].startswith("H"):
            parent[b] = a
    out, group_of_parent, next_type = [], {}, 0
    for i in range(len(topology["names"])):
        if types[i].startswith("H") and i in parent:
            if parent[i] not in group_of_parent:
                group_of_parent[parent[i]] = next_type
                next_type += 1
            out.append(group_of_parent[parent[i]])
        else:
            out.append(next_type)
            next_type += 1
    return tuple(out)
