from pita_torch.nets.egnn import EGCL, EGNNBackbone
from pita_torch.nets.precondition import EnergyWrapper, ScoreWrapper

__all__ = ["EGCL", "EGNNBackbone", "EnergyWrapper", "ScoreWrapper"]
