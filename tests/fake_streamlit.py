"""Minimal fake streamlit/plotly modules for smoke-testing app.py.

Records every call so tests can assert which UI elements rendered; widget
functions return their declared defaults, overridable per label, so page
code runs its real pipeline (reference app.py:901-1120, 1182-1532 parity
surface) without the streamlit dependency.
"""

from __future__ import annotations

import sys
import types
from typing import Any, Dict, List, Tuple


class Recorder:
    """Stands in for the st module, st.sidebar, columns, tabs, empties..."""

    def __init__(self, calls: List[Tuple[str, Any]],
                 overrides: Dict[str, Any]):
        self._calls = calls
        self._overrides = overrides
        self.sidebar = self  # st.sidebar.<widget> behaves like st.<widget>

    # -- context-manager protocol (tabs, expanders, columns) --------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _record(self, method: str, label: Any = None):
        self._calls.append((method, label))

    def _value(self, label, default):
        if label in self._overrides:
            return self._overrides[label]
        return default

    # -- widgets returning values ------------------------------------------
    def slider(self, label, min_value=None, max_value=None, value=None,
               step=None, **kw):
        self._record("slider", label)
        return self._value(label, value if value is not None else min_value)

    def select_slider(self, label, options=(), value=None, **kw):
        self._record("select_slider", label)
        return self._value(label, value if value is not None else options[0])

    def selectbox(self, label, options=(), index=0, **kw):
        self._record("selectbox", label)
        return self._value(label, list(options)[index])

    def radio(self, label, options=(), index=0, **kw):
        self._record("radio", label)
        return self._value(label, list(options)[index])

    def text_input(self, label, value="", **kw):
        self._record("text_input", label)
        return self._value(label, value)

    def text_area(self, label, value="", **kw):
        self._record("text_area", label)
        return self._value(label, value)

    def checkbox(self, label, value=False, **kw):
        self._record("checkbox", label)
        return self._value(label, value)

    def button(self, label, **kw):
        self._record("button", label)
        return self._value(label, True)

    # -- layout -------------------------------------------------------------
    def columns(self, n, **kw):
        self._record("columns", n)
        n = n if isinstance(n, int) else len(n)
        return [Recorder(self._calls, self._overrides) for _ in range(n)]

    def tabs(self, labels, **kw):
        self._record("tabs", tuple(labels))
        return [Recorder(self._calls, self._overrides) for _ in labels]

    def expander(self, label, **kw):
        self._record("expander", label)
        return Recorder(self._calls, self._overrides)

    def empty(self):
        self._record("empty")
        return Recorder(self._calls, self._overrides)

    def progress(self, v, **kw):
        self._record("progress", v)
        return Recorder(self._calls, self._overrides)

    # -- output sinks ---------------------------------------------------------
    def _sink(method):  # noqa: N805 - tiny metaprogramming helper
        def f(self, *a, **kw):
            self._record(method, a[0] if a else None)
        return f

    set_page_config = _sink("set_page_config")
    title = _sink("title")
    header = _sink("header")
    subheader = _sink("subheader")
    markdown = _sink("markdown")
    caption = _sink("caption")
    text = _sink("text")
    write = _sink("write")
    info = _sink("info")
    success = _sink("success")
    warning = _sink("warning")
    error = _sink("error")
    metric = _sink("metric")
    table = _sink("table")
    dataframe = _sink("dataframe")
    plotly_chart = _sink("plotly_chart")
    line_chart = _sink("line_chart")
    del _sink


class _FigureStub:
    def __init__(self, *a, **kw):
        self.traces = []

    def add_trace(self, tr, **kw):
        self.traces.append(tr)
        return self

    def update_layout(self, **kw):
        return self


def install(overrides: Dict[str, Any] | None = None):
    """Install fake streamlit+plotly into sys.modules.

    Returns ``(calls, overrides)``; callers import/reload app.py afterwards.
    """
    calls: List[Tuple[str, Any]] = []
    overrides = dict(overrides or {})

    st = types.ModuleType("streamlit")
    rec = Recorder(calls, overrides)
    for name in dir(Recorder):
        if not name.startswith("_"):
            setattr(st, name, getattr(rec, name))
    st.sidebar = rec

    plotly = types.ModuleType("plotly")
    go = types.ModuleType("plotly.graph_objects")
    go.Figure = _FigureStub
    go.Scatter = lambda *a, **kw: ("scatter", kw.get("name"))
    subplots = types.ModuleType("plotly.subplots")
    subplots.make_subplots = lambda *a, **kw: _FigureStub()
    plotly.graph_objects = go
    plotly.subplots = subplots

    sys.modules["streamlit"] = st
    sys.modules["plotly"] = plotly
    sys.modules["plotly.graph_objects"] = go
    sys.modules["plotly.subplots"] = subplots
    return calls, overrides


def uninstall():
    for m in ("streamlit", "plotly", "plotly.graph_objects",
              "plotly.subplots", "montecarlo.app"):
        sys.modules.pop(m, None)
