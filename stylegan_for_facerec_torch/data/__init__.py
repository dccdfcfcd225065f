from .dataset import DataLoader, FacesDataset
from .images_dataset import (GTResDataset, ImagesDataset, InferenceDataset,
                             list_images)
from .packed import (PackedLoader, PackedTrainDataset, device_prefetch,
                     is_packed_dir, write_packed)

__all__ = ["DataLoader", "FacesDataset", "GTResDataset", "ImagesDataset",
           "InferenceDataset",
           "PackedLoader", "PackedTrainDataset", "device_prefetch",
           "is_packed_dir", "list_images", "write_packed"]
