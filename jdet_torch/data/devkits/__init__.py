"""Evaluation and tile-merge devkits (numpy), copied from jdet_tpu.data.devkits."""
