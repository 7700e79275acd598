"""Framework-free helpers copied from jdet_tpu.utils."""
