"""The Runner (train, val and test from a config) and checkpoints."""
from .checkpoint import load_checkpoint, save_checkpoint
from .runner import Runner
