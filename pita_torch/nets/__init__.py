from pita_torch.nets.dit import DiT3DBackbone
from pita_torch.nets.egnn import EGCL, EGNNBackbone
from pita_torch.nets.mlp import MLPBackbone
from pita_torch.nets.precondition import EnergyWrapper, ScoreWrapper
from pita_torch.nets.torchmd_et import TorchMDETBackbone

__all__ = ["DiT3DBackbone", "EGCL", "EGNNBackbone", "EnergyWrapper", "MLPBackbone",
           "ScoreWrapper", "TorchMDETBackbone"]
