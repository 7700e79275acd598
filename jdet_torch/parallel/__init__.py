"""Device-side input pipeline and the train step."""
from .spmd import build_train_step, make_device_augmenter, make_device_normalizer
