"""Shared utilities of the port: checkpoints, training logs, timing and
memory introspection."""

from .checkpoint import load_params, read_msgpack, save_params, write_msgpack
from .memdebug import device_memory_stats, live_array_summary
from .metrics import TRAIN_LOG_HEADER, CSVLogger, JSONLLogger
from .timing import Timer

__all__ = [
    "CSVLogger",
    "JSONLLogger",
    "TRAIN_LOG_HEADER",
    "Timer",
    "device_memory_stats",
    "live_array_summary",
    "load_params",
    "read_msgpack",
    "save_params",
    "write_msgpack",
]
