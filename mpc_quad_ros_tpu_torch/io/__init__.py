from .checkpoint import load_checkpoint, save_checkpoint
from .config import SimConfig
from .logger import Logger, load_dict, save_dict

__all__ = ["Logger", "save_dict", "load_dict", "SimConfig", "save_checkpoint", "load_checkpoint"]
