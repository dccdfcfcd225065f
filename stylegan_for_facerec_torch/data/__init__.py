from .images_dataset import InferenceDataset

__all__ = ["InferenceDataset"]
