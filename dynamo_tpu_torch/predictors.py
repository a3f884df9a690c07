"""Load predictors for the planner (the port's copy of the JAX package's
predictors.py; reference
components/planner/src/dynamo/planner/utils/load_predictor.py:159).

The reference offers constant / ARIMA / Prophet predictors that forecast
the next-interval load so the planner scales ahead of demand instead of
reacting to it. statsmodels/prophet aren't in this image, so the ARIMA
slot is filled by an honest numpy autoregressive model (least-squares AR(p)
on an optionally once-differenced window) — the same job: trend-following
forecasts with noise rejection.

All predictors share the reference's surface: ``add_data_point(value)`` /
``predict_next()`` / ``get_last_value()``.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np


class BasePredictor:
    """Sliding-window load predictor."""

    def __init__(self, window_size: int = 60):
        if window_size < 1:
            raise ValueError("window_size must be >= 1")
        self.window_size = window_size
        self.data: deque[float] = deque(maxlen=window_size)

    def add_data_point(self, value: float) -> None:
        v = float(value)
        if not np.isfinite(v):
            return  # a NaN observation must not poison the window
        self.data.append(v)

    def get_last_value(self) -> float:
        return self.data[-1] if self.data else 0.0

    def predict_next(self) -> float:
        raise NotImplementedError


class ConstantPredictor(BasePredictor):
    """Next == last (the reference's default; reactive planner behavior)."""

    def predict_next(self) -> float:
        return self.get_last_value()


class MovingAveragePredictor(BasePredictor):
    """Mean of the window — maximal noise rejection, no trend following."""

    def __init__(self, window_size: int = 12):
        super().__init__(window_size)

    def predict_next(self) -> float:
        if not self.data:
            return 0.0
        return float(np.mean(self.data))


class ARPredictor(BasePredictor):
    """Autoregressive one-step forecast (the ARIMA(p,d,0) slot).

    Fits AR(p) by least squares on the window each call (windows are tiny —
    tens of points — so the solve is microseconds). ``d=1`` differences the
    series first, which follows linear trends exactly. Falls back to the
    window mean until enough points exist, never extrapolates negative
    load, and clamps the forecast to a multiple of the observed range so a
    poorly-conditioned fit can't command a runaway scale-up.
    """

    def __init__(self, window_size: int = 30, order: int = 4, d: int = 1):
        super().__init__(window_size)
        if order < 1:
            raise ValueError("order must be >= 1")
        if d not in (0, 1):
            raise ValueError("d must be 0 or 1")
        self.order = order
        self.d = d

    def predict_next(self) -> float:
        n = len(self.data)
        if n == 0:
            return 0.0
        series = np.asarray(self.data, np.float64)
        work = np.diff(series) if self.d else series
        p = min(self.order, max(1, len(work) - 2))
        if len(work) < p + 2:
            return float(np.mean(series))
        # rows: work[i-p:i] -> work[i]
        X = np.stack([work[i - p: i] for i in range(p, len(work))])
        y = work[p:]
        X1 = np.concatenate([X, np.ones((len(X), 1))], axis=1)
        try:
            coef, *_ = np.linalg.lstsq(X1, y, rcond=None)
        except np.linalg.LinAlgError:
            return float(np.mean(series))
        nxt = float(work[-p:] @ coef[:-1] + coef[-1])
        pred = series[-1] + nxt if self.d else nxt
        lo, hi = float(series.min()), float(series.max())
        span = max(hi - lo, abs(hi), 1.0)
        return float(np.clip(pred, max(0.0, lo - span), hi + span))


class SeasonalPredictor(BasePredictor):
    """Seasonal one-step forecast — the Prophet slot
    (load_predictor.py:159). Prophet's job for the planner is "daily /
    weekly traffic has a repeating shape; scale for the next bucket's
    USUAL level plus the current trend". The honest numpy equivalent is
    Holt-Winters-style additive decomposition: level (EWMA) + trend
    (EWMA of first differences) + a per-phase seasonal offset averaged
    across observed cycles.

    ``period`` is in observations (planner adjustment intervals); e.g.
    a 60 s interval and period=1440 tracks a daily cycle. Until one full
    cycle is seen, behaves like trend-following; never predicts
    negative load.
    """

    def __init__(self, window_size: int = 4320, period: int = 1440,
                 alpha: float = 0.4, beta: float = 0.1):
        if period < 2:
            raise ValueError("period must be >= 2")
        super().__init__(max(window_size, 2 * period))
        self.period = period
        self.alpha = alpha
        self.beta = beta

    def predict_next(self) -> float:
        n = len(self.data)
        if n == 0:
            return 0.0
        series = np.asarray(self.data, np.float64)
        if n < self.period + 2:
            # no full cycle yet: level + trend only
            level, trend = series[0], 0.0
            for x in series[1:]:
                prev = level
                level = self.alpha * x + (1 - self.alpha) * (level + trend)
                trend = self.beta * (level - prev) + (1 - self.beta) * trend
            return float(max(0.0, level + trend))
        # per-phase seasonal offsets vs a centered moving level
        phases = np.arange(n) % self.period
        level_series = np.convolve(
            series, np.ones(self.period) / self.period, mode="same"
        )
        resid = series - level_series
        seasonal = np.zeros(self.period)
        for ph in range(self.period):
            vals = resid[phases == ph]
            if len(vals):
                seasonal[ph] = float(vals.mean())
        deseason = series - seasonal[phases]
        level, trend = deseason[0], 0.0
        for x in deseason[1:]:
            prev = level
            level = self.alpha * x + (1 - self.alpha) * (level + trend)
            trend = self.beta * (level - prev) + (1 - self.beta) * trend
        next_phase = n % self.period
        return float(max(0.0, level + trend + seasonal[next_phase]))


def make_predictor(name: str, **kw) -> BasePredictor:
    """Factory used by PlannerConfig.predictor."""
    table = {
        "constant": ConstantPredictor,
        "moving_average": MovingAveragePredictor,
        "ar": ARPredictor,
        "arima": ARPredictor,  # the reference's name for this slot
        "seasonal": SeasonalPredictor,
        "prophet": SeasonalPredictor,  # the reference's name for the slot
    }
    if name not in table:
        raise ValueError(f"unknown predictor {name!r} (have {sorted(table)})")
    return table[name](**kw)
