from .initializers import init_weights
from .layers import (BatchNorm1d, BatchNorm2d, Dropout, Flatten,
                     InstanceNorm2d, Subsample)

__all__ = ["BatchNorm1d", "BatchNorm2d", "Dropout", "Flatten",
           "InstanceNorm2d", "Subsample", "init_weights"]
