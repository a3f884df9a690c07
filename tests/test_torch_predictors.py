"""The port's load predictors (dynamo_tpu_torch/predictors.py) against the
JAX package's: the same seeded series fed one point at a time give every
predictor the same forecast after every point (rtol 1e-9), and
``make_predictor`` takes and refuses the same names."""
import numpy as np
import pytest

from dynamo_tpu import predictors as rp
from dynamo_tpu_torch import predictors as pp

RTOL = 1e-9


def _series(kind: str, n: int, seed: int) -> list[float]:
    rng = np.random.RandomState(seed)
    t = np.arange(n, dtype=np.float64)
    if kind == "noise":
        return (0.5 + 0.2 * rng.randn(n)).tolist()
    if kind == "trend":
        return (3.0 + 0.7 * t + rng.randn(n)).tolist()
    if kind == "seasonal":
        return (10 + 4 * np.sin(2 * np.pi * t / 12) + rng.randn(n)).tolist()
    if kind == "steps":
        return np.repeat(rng.randint(0, 30, size=n // 6 + 1), 6)[:n].tolist()
    raise AssertionError(kind)


# (name, kwargs): every predictor class, at its defaults and at a short
# window or period, so the window slides and the seasonal path runs
CASES = [
    ("constant", {}),
    ("moving_average", {}),
    ("moving_average", {"window_size": 5}),
    ("ar", {}),
    ("arima", {"window_size": 12, "order": 2, "d": 0}),
    ("ar", {"window_size": 20, "order": 6, "d": 1}),
    ("seasonal", {"period": 12, "window_size": 36}),
    ("prophet", {"period": 6, "window_size": 12, "alpha": 0.3,
                 "beta": 0.2}),
]


@pytest.mark.parametrize("kind", ["noise", "trend", "seasonal", "steps"])
@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_forecasts_equal_the_reference(name, kw, kind):
    series = _series(kind, 60, seed=len(name) * 7 + len(kw))
    series[17] = float("nan")   # a NaN observation is dropped by both
    ref, port = rp.make_predictor(name, **kw), pp.make_predictor(name, **kw)
    assert type(port).__name__ == type(ref).__name__
    assert port.predict_next() == ref.predict_next() == 0.0
    for v in series:
        ref.add_data_point(v)
        port.add_data_point(v)
        want = ref.predict_next()
        np.testing.assert_allclose(port.predict_next(), want, rtol=RTOL)
        assert port.get_last_value() == ref.get_last_value()
    assert list(port.data) == list(ref.data)


@pytest.mark.parametrize("name,kw", [
    ("constant", {}), ("moving_average", {}), ("ar", {}), ("arima", {}),
    ("seasonal", {}), ("prophet", {}), ("lstm", {}), ("", {}),
    ("ar", {"order": 0}), ("ar", {"d": 2}), ("seasonal", {"period": 1}),
    ("constant", {"window_size": 0}),
])
def test_make_predictor_accepts_and_refuses_the_same(name, kw):
    try:
        ref = rp.make_predictor(name, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pp.make_predictor(name, **kw)
        assert str(got.value) == str(e)
        return
    port = pp.make_predictor(name, **kw)
    assert type(port).__name__ == type(ref).__name__
    assert vars(port).keys() == vars(ref).keys()
