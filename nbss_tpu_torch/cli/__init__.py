from nbss_tpu_torch.cli.config import instantiate, load_configs, parse_argv, save_config
from nbss_tpu_torch.cli.main import run

__all__ = ["instantiate", "load_configs", "parse_argv", "save_config", "run"]
