"""Host-side utilities of the port: checkpoints and training logs."""

from .checkpoint import load_params, read_msgpack, save_params, write_msgpack
from .metrics import TRAIN_LOG_HEADER, CSVLogger, JSONLLogger

__all__ = [
    "CSVLogger",
    "JSONLLogger",
    "TRAIN_LOG_HEADER",
    "load_params",
    "read_msgpack",
    "save_params",
    "write_msgpack",
]
