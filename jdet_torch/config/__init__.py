"""Config loading, copied from jdet_tpu.config."""
from .config import load_cfg_file, merge_dict_b2a
