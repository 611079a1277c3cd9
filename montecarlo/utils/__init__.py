"""Utilities: profiling/tracing hooks and timing helpers."""

from montecarlo.utils.compile_cache import (  # noqa: F401
    cache_dir,
    enable_persistent_cache,
)
from montecarlo.utils.profiling import (  # noqa: F401
    Timer,
    throughput_path_steps,
    trace,
)
