from dgll_tpu.utils.compile_cache import enable_compile_cache
from dgll_tpu.utils.config import TrainConfig, add_train_flags, parse_train_config
from dgll_tpu.utils.logging import get_logger
from dgll_tpu.utils.profiling import PhaseTimer, device_trace

__all__ = [
    "enable_compile_cache",
    "get_logger",
    "PhaseTimer",
    "device_trace",
    "TrainConfig",
    "add_train_flags",
    "parse_train_config",
]
