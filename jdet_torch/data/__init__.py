"""Host-side data pipeline: PNG, JPEG and TIFF decode, transforms, datasets,
devkits."""
from .coco import COCODataset
from .custom import CustomDataset
from .dota import DOTADataset, FAIR1M_1_5_Dataset, FAIRDataset, ImageDataset, SSDDDataset
from .transforms import (
    Compose, Normalize, Pad, RandomFlip, RandomRotateAug, Resize, RotatedRandomFlip,
    RotatedResize,
)
