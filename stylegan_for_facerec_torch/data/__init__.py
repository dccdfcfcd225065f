from .images_dataset import ImagesDataset, InferenceDataset, list_images

__all__ = ["ImagesDataset", "InferenceDataset", "list_images"]
