from .config import (
    AgentConfig,
    Config,
    EpsilonConfig,
    FlowConfig,
    OptimizerConfig,
)
from .jsonlog import JsonLogger, read_jsonl
from .profiling import device_busy

__all__ = [
    "AgentConfig",
    "Config",
    "EpsilonConfig",
    "FlowConfig",
    "JsonLogger",
    "OptimizerConfig",
    "device_busy",
    "read_jsonl",
]
