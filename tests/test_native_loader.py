"""Native C++ CSV loader vs pandas, and the csv provider path."""

import numpy as np
import pandas as pd
import pytest

from montecarlo.data._native import get_lib, load_ohlcv_csv
from montecarlo.data.fetch import get_stock_data
from montecarlo.data.synthetic import generate_ohlcv


@pytest.fixture(scope="module")
def csv_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("csv")
    ohlcv = generate_ohlcv(n_days=600, seed=9)
    df = pd.DataFrame({"Date": np.arange(600), **ohlcv})
    path = d / "TEST.csv"
    df.to_csv(path, index=False)
    return str(path), ohlcv


def test_native_toolchain_builds():
    assert get_lib() is not None, "g++ toolchain expected in this image"


def test_native_matches_pandas(csv_file):
    path, ohlcv = csv_file
    native = load_ohlcv_csv(path)
    assert native is not None
    ref = pd.read_csv(path)
    for col in ("Open", "High", "Low", "Close", "Volume"):
        np.testing.assert_allclose(native[col], ref[col].to_numpy(),
                                   rtol=1e-15, err_msg=col)


def test_native_rejects_missing_columns(tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text("a,b,c\n1,2,3\n")
    assert load_ohlcv_csv(str(bad)) is None


def test_native_missing_file():
    assert load_ohlcv_csv("/nonexistent/file.csv") is None


def test_csv_provider_end_to_end(csv_file):
    path, _ = csv_file
    import os
    data = get_stock_data("TEST", provider="csv",
                          data_dir=os.path.dirname(path))
    assert data is not None
    assert "rvol_20" in data and len(data["Close"]) > 300


def test_quoted_fields_and_no_trailing_newline(tmp_path):
    """Commas inside quoted cells must not shift columns, and a file whose
    last line lacks a trailing newline must still parse (the raw-mmap
    strtod could scan past the mapping)."""
    from montecarlo.data._native import load_ohlcv_csv

    p = tmp_path / "quoted.csv"
    p.write_bytes(
        b"Symbol,Name,Open,High,Low,Close,Volume\n"
        b'AAPL,"Apple, Inc.",10,11,9,10.5,1000\n'
        b'MSFT,"Micro, soft",20,21,19,20.5,2000')  # no trailing newline
    out = load_ohlcv_csv(str(p))
    if out is None:
        import pytest
        pytest.skip("native toolchain unavailable")
    np.testing.assert_allclose(out["Open"], [10.0, 20.0])
    np.testing.assert_allclose(out["Close"], [10.5, 20.5])
    np.testing.assert_allclose(out["Volume"], [1000.0, 2000.0])
