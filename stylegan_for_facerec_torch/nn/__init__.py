from .initializers import init_weights
from .layers import BatchNorm1d, BatchNorm2d, Dropout, Flatten, Subsample

__all__ = ["BatchNorm1d", "BatchNorm2d", "Dropout", "Flatten", "Subsample",
           "init_weights"]
