"""ML layer: scaler, time-series splits, JAX histogram-GBT, forecast model."""

from montecarlo.ml.scaler import (  # noqa: F401
    ScalerState,
    scaler_fit,
    scaler_fit_transform,
    scaler_transform,
)
from montecarlo.ml.splits import split_bounds, time_series_split  # noqa: F401
from montecarlo.ml.gbt import (  # noqa: F401
    GBTConfig,
    GBTModel,
    gbt_feature_importance,
    gbt_fit,
    gbt_predict,
)
from montecarlo.ml.model import (  # noqa: F401
    FEATURE_COLS,
    ForecastModel,
    make_target,
)
