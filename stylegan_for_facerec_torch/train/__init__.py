from .optim import RAdam, Ranger, Stage3Schedule, radam_torch
from .stage1 import Stage1Trainer
from .stage2 import Stage2Coach, Stage2Config
from .stage2_e4e import E4eCoach, E4eConfig
from .stage3 import Stage3Config, Stage3Trainer

__all__ = ["E4eCoach", "E4eConfig", "RAdam", "Ranger", "Stage1Trainer",
           "Stage2Coach", "Stage2Config", "Stage3Config", "Stage3Schedule",
           "Stage3Trainer", "radam_torch"]
