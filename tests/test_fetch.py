"""Data-acquisition layer: featurize-through contract and mask alignment."""

import numpy as np

from montecarlo.data.fetch import _featurize
from montecarlo.data.synthetic import generate_ohlcv
from montecarlo.quant.features import features_to_numpy


def _ohlcv_with_dates(n=400, seed=3):
    ohlcv = dict(generate_ohlcv(n_days=n, seed=seed))
    ohlcv["Date"] = np.arange(n)  # passthrough column to track alignment
    return ohlcv


def test_featurize_prefix_drop_alignment():
    ohlcv = _ohlcv_with_dates()
    out = _featurize(ohlcv)
    # Dates must point at the rows that survived dropna.
    _, mask = features_to_numpy(
        ohlcv["Open"], ohlcv["High"], ohlcv["Low"], ohlcv["Close"],
        ohlcv["Volume"], return_mask=True)
    np.testing.assert_array_equal(out["Date"], np.arange(len(mask))[mask])
    assert len(out["Date"]) == len(out["Close"])


def test_featurize_mid_series_nan_alignment():
    """A mid-series NaN (halted ticker) drops interior rows; passthrough
    columns must follow the exact dropna mask, not a prefix slice —
    otherwise dates silently misalign against prices in trade logs."""
    ohlcv = _ohlcv_with_dates()
    close = np.array(ohlcv["Close"], np.float64)
    close[250] = np.nan  # one bad interior row
    ohlcv["Close"] = close

    out = _featurize(ohlcv)
    _, mask = features_to_numpy(
        ohlcv["Open"], ohlcv["High"], ohlcv["Low"], ohlcv["Close"],
        ohlcv["Volume"], return_mask=True)
    # The mask is genuinely non-prefix (interior rows dropped) — the case
    # the old `v[n_dropped:]` slicing got wrong.
    first_valid = int(np.argmax(mask))
    assert not mask[first_valid:].all()

    expected_dates = np.arange(len(mask))[mask]
    np.testing.assert_array_equal(out["Date"], expected_dates)
    # Every surviving (Date, Close) pair is the original pair.
    np.testing.assert_allclose(out["Close"], close[mask])
