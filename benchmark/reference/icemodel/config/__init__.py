from .config import Config, load_config, parse_namelist

__all__ = ["Config", "load_config", "parse_namelist"]
