from pita_torch.nets.dit import DiT3DBackbone
from pita_torch.nets.egnn import EGCL, EGNNBackbone
from pita_torch.nets.precondition import EnergyWrapper, ScoreWrapper

__all__ = ["DiT3DBackbone", "EGCL", "EGNNBackbone", "EnergyWrapper", "ScoreWrapper"]
