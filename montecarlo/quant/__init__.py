"""Feature engineering in JAX (reference app.py:183-395 parity)."""

from montecarlo.quant.features import (  # noqa: F401
    DROPPED_INTERMEDIATES,
    compute_features,
    features_to_numpy,
    finalize,
)
from montecarlo.quant.indicators import (  # noqa: F401
    atr,
    bollinger,
    keltner,
    macd,
    rsi,
    stochastic,
)
