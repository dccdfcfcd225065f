from .dataset import DataLoader, FacesDataset, device_augment
from .images_dataset import (GTResDataset, ImagesDataset, InferenceDataset,
                             list_images)
from .native_loader import NativeDataLoader, make_loader
from .packed import (PackedLoader, PackedTrainDataset, device_prefetch,
                     is_packed_dir, pack_dataset, save_packed_meta,
                     write_packed)
from .randaugment import RandAugment

__all__ = ["DataLoader", "FacesDataset", "GTResDataset", "ImagesDataset",
           "InferenceDataset", "NativeDataLoader", "make_loader",
           "PackedLoader", "PackedTrainDataset", "RandAugment",
           "device_augment", "device_prefetch", "is_packed_dir",
           "list_images", "pack_dataset", "save_packed_meta",
           "write_packed"]
