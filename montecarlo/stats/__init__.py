"""Mergeable statistics: moments, quantiles, risk metrics."""

from montecarlo.stats.welford import (  # noqa: F401
    MomentState,
    moments_from_array,
    moments_merge,
    moments_reduce,
    moments_zero,
    std,
    std_error,
    variance,
)
from montecarlo.stats.quantiles import (  # noqa: F401
    HistogramSketch,
    percentile_linear,
    sketch_add,
    sketch_empty,
    sketch_from_array,
    sketch_merge,
    sketch_quantile,
    sketch_quantile_std_err,
    sketch_tail_mean_below,
)
from montecarlo.stats.risk import (  # noqa: F401
    PATH_PERCENTILES,
    TERMINAL_PERCENTILES,
    path_percentiles,
    terminal_statistics,
)
