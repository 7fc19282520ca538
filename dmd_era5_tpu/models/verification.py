"""Forecast verification: weather-standard skill scores.

The reference pipeline stops at the decomposition, leaving forecast
quality unmeasured; a production forecasting system needs the standard
verification suite.  Implements the scores every NWP/ML-weather paper
reports (cf. WeatherBench): latitude-weighted RMSE, anomaly correlation
coefficient (ACC), and mean bias — per lead time, on (space, time)
fields or (level, lat, lon, time) grids.

Latitude weighting: grid cells shrink as cos(latitude); unweighted
means over-count the poles (a 5-degree grid has 36x more area per cell
at the equator than at the pole).  Weights are normalized cos(lat)
clipped at >= 0 (exact poles get zero area on a cell-center grid).

All metrics are jittable jnp ops — they run on device against sharded
forecast/truth arrays; only the per-lead-time scalars come home.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = [
    "latitude_weights",
    "weighted_rmse",
    "weighted_acc",
    "weighted_bias",
    "forecast_scores",
    "ScoreAccumulator",
]


def latitude_weights(latitudes) -> jnp.ndarray:
    """Normalized cos(latitude) area weights (degrees in, mean 1 out)."""
    lat = jnp.asarray(latitudes, dtype=jnp.float32)
    w = jnp.maximum(jnp.cos(jnp.deg2rad(lat)), 0.0)
    return w / jnp.mean(w)


def _space_weights(latitudes, n_space: int) -> jnp.ndarray:
    """Per-row weights for a flattened space axis.

    ``latitudes`` must be PER-ROW (len == n_space) — exactly the
    parallel ``latitude`` coordinate the stage artifacts carry after
    ``space_coord_to_level_lat_lon`` (a bare 1-D grid axis cannot be
    tiled unambiguously without the level/lon counts).
    """
    lat = np.asarray(latitudes, dtype=np.float32)
    if lat.shape[0] != n_space:
        raise ValueError(
            f"need one latitude per space row: got {lat.shape[0]} for "
            f"{n_space} rows (pass the artifact's per-row 'latitude' "
            "coordinate)"
        )
    return latitude_weights(lat)


def weighted_rmse(forecast, truth, weights=None) -> jnp.ndarray:
    """Latitude-weighted RMSE per lead time.

    forecast/truth: (S, L) space x lead; weights: per-row (S,) area
    weights (default uniform).  Returns (L,).
    """
    f = jnp.asarray(forecast, jnp.float32)
    t = jnp.asarray(truth, jnp.float32)
    w = (
        jnp.ones(f.shape[0], jnp.float32)
        if weights is None
        else jnp.asarray(weights, jnp.float32)
    )
    se = jnp.square(f - t) * w[:, None]
    return jnp.sqrt(jnp.sum(se, axis=0) / jnp.sum(w))


def weighted_bias(forecast, truth, weights=None) -> jnp.ndarray:
    """Latitude-weighted mean error per lead time, (L,)."""
    f = jnp.asarray(forecast, jnp.float32)
    t = jnp.asarray(truth, jnp.float32)
    w = (
        jnp.ones(f.shape[0], jnp.float32)
        if weights is None
        else jnp.asarray(weights, jnp.float32)
    )
    return jnp.sum((f - t) * w[:, None], axis=0) / jnp.sum(w)


def weighted_acc(forecast, truth, climatology=None, weights=None) -> jnp.ndarray:
    """Anomaly correlation coefficient per lead time, (L,).

    Anomalies are deviations from ``climatology`` (per-row reference
    state; default: the truth's time mean — the centered-ACC convention
    when no external climatology exists).
    """
    f = jnp.asarray(forecast, jnp.float32)
    t = jnp.asarray(truth, jnp.float32)
    w = (
        jnp.ones(f.shape[0], jnp.float32)
        if weights is None
        else jnp.asarray(weights, jnp.float32)
    )
    clim = (
        jnp.mean(t, axis=1)
        if climatology is None
        else jnp.asarray(climatology, jnp.float32)
    )
    fa = f - clim[:, None]
    ta = t - clim[:, None]
    num = jnp.sum(fa * ta * w[:, None], axis=0)
    den = jnp.sqrt(
        jnp.sum(jnp.square(fa) * w[:, None], axis=0)
        * jnp.sum(jnp.square(ta) * w[:, None], axis=0)
    )
    return num / jnp.maximum(den, 1e-30)


class ScoreAccumulator:
    """Blockwise-exact accumulation of :func:`forecast_scores`.

    Every score is a ratio of latitude-weighted sums over space, so
    row blocks reduce EXACTLY — feeding (S_blk, L) blocks through
    :meth:`update` and calling :meth:`finalize` reproduces the one-shot
    scores bit-for-bit in exact arithmetic (f64 accumulators here make
    the blockwise route at least as accurate as the f32 one-shot).
    This is what lets the DMD/forecast stage score an S = 15.6M-row
    holdout with O(block) residency (review r4 item 2) instead of
    materializing the (S, L) forecast the one-shot functions need.

    ACC climatology: pass per-row ``clim_blk`` to :meth:`update`, or
    omit it for the centered-ACC convention (truth row-mean — computed
    per block, identical to the one-shot default).
    """

    def __init__(self) -> None:
        self._sums: dict[str, np.ndarray] | None = None
        self._wsum = 0.0

    def update(self, f_blk, t_blk, w_blk=None, clim_blk=None) -> None:
        f = np.asarray(f_blk, np.float64)
        t = np.asarray(t_blk, np.float64)
        w = (
            np.ones(f.shape[0], np.float64)
            if w_blk is None
            else np.asarray(w_blk, np.float64)
        )
        clim = (
            t.mean(axis=1) if clim_blk is None else np.asarray(clim_blk, np.float64)
        )
        err = f - t
        fa = f - clim[:, None]
        ta = t - clim[:, None]
        wc = w[:, None]
        upd = {
            "se": np.sum(np.square(err) * wc, axis=0),
            "err": np.sum(err * wc, axis=0),
            "num": np.sum(fa * ta * wc, axis=0),
            "fa2": np.sum(np.square(fa) * wc, axis=0),
            "ta2": np.sum(np.square(ta) * wc, axis=0),
        }
        if self._sums is None:
            self._sums = upd
        else:
            for k, v in upd.items():
                self._sums[k] += v
        self._wsum += float(np.sum(w))

    def finalize(self) -> dict[str, np.ndarray]:
        if self._sums is None:
            raise ValueError("No blocks accumulated")
        s = self._sums
        rmse = np.sqrt(s["se"] / self._wsum)
        bias = s["err"] / self._wsum
        acc = s["num"] / np.maximum(np.sqrt(s["fa2"] * s["ta2"]), 1e-30)
        return {
            "rmse": rmse.astype(np.float32),
            "acc": acc.astype(np.float32),
            "bias": bias.astype(np.float32),
        }


def forecast_scores(
    forecast,
    truth,
    latitudes=None,
    climatology=None,
) -> dict[str, np.ndarray]:
    """All scores at once: {'rmse', 'acc', 'bias'}, each (L,) host numpy.

    forecast/truth: (S, L).  ``latitudes``: per-row degrees or the 1-D
    grid axis (see :func:`_space_weights`); None = unweighted.
    """
    w = (
        None
        if latitudes is None
        else _space_weights(latitudes, int(jnp.asarray(forecast).shape[0]))
    )
    return {
        "rmse": np.asarray(weighted_rmse(forecast, truth, w)),
        "acc": np.asarray(weighted_acc(forecast, truth, climatology, w)),
        "bias": np.asarray(weighted_bias(forecast, truth, w)),
    }
