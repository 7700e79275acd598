"""Dataset class-name tables.

Copy of `jdet_tpu/config/constants.py` (the DOTA, FAIR1M, SSDD, VOC, COCO
and Cityscapes vocabularies and `get_classes_by_name` :86), kept in the
port so that it imports nothing of the JAX package.
"""
from __future__ import annotations

DOTA1_CLASSES = [
    "plane", "baseball-diamond", "bridge", "ground-track-field",
    "small-vehicle", "large-vehicle", "ship", "tennis-court",
    "basketball-court", "storage-tank", "soccer-ball-field",
    "roundabout", "harbor", "swimming-pool", "helicopter",
]

DOTA1_5_CLASSES = DOTA1_CLASSES + ["container-crane"]

DOTA2_CLASSES = DOTA1_5_CLASSES + ["airport", "helipad"]

FAIR_CLASSES = [
    "Boeing737", "Boeing747", "Boeing777", "Boeing787", "C919",
    "A220", "A321", "A330", "A350", "ARJ21", "other-airplane",
    "Passenger_Ship", "Motorboat", "Fishing_Boat", "Tugboat",
    "Engineering_Ship", "Liquid_Cargo_Ship", "Dry_Cargo_Ship", "Warship",
    "other-ship", "Small_Car", "Bus", "Cargo_Truck", "Dump_Truck", "Van",
    "Trailer", "Tractor", "Excavator", "Truck_Tractor", "other-vehicle",
    "Basketball_Court", "Tennis_Court", "Football_Field", "Baseball_Field",
    "Intersection", "Roundabout", "Bridge",
]

FAIR_CLASSES_SPACED = [c.replace("_", " ") for c in FAIR_CLASSES]

FAIR1M_1_5_CLASSES = [
    "Airplane", "Ship", "Vehicle", "Basketball_Court", "Tennis_Court",
    "Football_Field", "Baseball_Field", "Intersection", "Roundabout",
    "Bridge",
]

SSDD_CLASSES = ["ship"]

VOC_CLASSES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]

COCO_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep",
    "cow", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]

CITYSCAPE_CLASSES = [
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
]

_NAME_TABLE = {
    "VOC": VOC_CLASSES,
    "COCO": COCO_CLASSES,
    "CITYSCAPE": CITYSCAPE_CLASSES,
    "DOTA": DOTA1_CLASSES,
    "DOTA1": DOTA1_CLASSES,
    "DOTA1_5": DOTA1_5_CLASSES,
    "DOTA2": DOTA2_CLASSES,
    "FAIR": FAIR_CLASSES,
    "FAIR1M_1_5": FAIR1M_1_5_CLASSES,
    "SSDD": SSDD_CLASSES,
    "SSDD+": SSDD_CLASSES,
}


def get_classes_by_name(name):
    """The class list of a dataset type (`DOTA`, `FAIR`, `SSDD+`, ...)."""
    if name not in _NAME_TABLE:
        raise KeyError(f"unknown dataset class table: {name}")
    return _NAME_TABLE[name]
