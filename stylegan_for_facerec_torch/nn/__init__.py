from .initializers import init_weights
from .layers import Subsample

__all__ = ["Subsample", "init_weights"]
