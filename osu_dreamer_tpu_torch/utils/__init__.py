from .config import dataclass_from_dict, load_yaml_config

__all__ = ["dataclass_from_dict", "load_yaml_config"]
