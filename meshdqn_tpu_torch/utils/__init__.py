from .config import (
    AgentConfig,
    Config,
    EpsilonConfig,
    FlowConfig,
    OptimizerConfig,
)
from .jsonlog import JsonLogger, read_jsonl
from .profiling import (
    Span,
    count,
    device_busy,
    span,
    take_trace,
    trace_off,
    trace_on,
    tracing,
)

__all__ = [
    "AgentConfig",
    "Config",
    "EpsilonConfig",
    "FlowConfig",
    "JsonLogger",
    "OptimizerConfig",
    "Span",
    "count",
    "device_busy",
    "read_jsonl",
    "span",
    "take_trace",
    "trace_off",
    "trace_on",
    "tracing",
]
