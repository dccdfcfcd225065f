from .optim import Ranger
from .stage2 import Stage2Coach, Stage2Config

__all__ = ["Ranger", "Stage2Coach", "Stage2Config"]
