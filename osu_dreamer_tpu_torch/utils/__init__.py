from .config import dataclass_from_dict

__all__ = ["dataclass_from_dict"]
