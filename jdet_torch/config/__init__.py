"""Config loading and the global config, copied from jdet_tpu.config."""
from .config import (get_cfg, init_cfg, load_cfg_file, merge_dict_b2a, print_cfg, save_cfg,
                     update_cfg)
