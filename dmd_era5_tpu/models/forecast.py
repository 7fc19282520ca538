"""Forecast / reconstruction rollout.

X^(t) = Phi diag(b) exp(alpha t): one skinny (S, r) x (r, T') GEMM,
row-sharded over space — the component absent from the reference
(SURVEY.md section 2b, "Forecast/reconstruction rollout").

Handles the inverse preprocessing chain: undo standardization (multiply
by std, add mean) and strip the delay-embedding copies (keep the
delay = 0 block, the undelayed rows — reference coordinate convention at
/root/reference/src/dmd_era5/slice_tools/slice_tools.py:255-274).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from dmd_era5_tpu.models.dmd import DMDResult
from dmd_era5_tpu.models.optdmd import OptDMDResult

HIGHEST = lax.Precision.HIGHEST

__all__ = [
    "rollout",
    "forecast_times",
    "undo_preprocessing",
    "iter_forecast_blocks",
    "streamed_forecast_scores",
]


def rollout(
    result: DMDResult | OptDMDResult,
    t,
) -> jax.Array:
    """Evaluate the fitted linear model at times ``t`` (seconds/hours —
    whatever unit the fit used).  Returns real (S, len(t)).

    Complex arithmetic is kept off the device transfer path: the small
    complex dynamics matrix is built on host, and the S-sized contraction Re(M D) = M_re D_re - M_im D_im
    runs as two real device GEMMs.
    """
    import numpy as np

    alpha, scale, modes = _extract_model(result)
    t_host = np.asarray(jax.device_get(t), dtype=np.float64)

    dynamics = scale[:, None] * np.exp(np.outer(alpha, t_host))  # (r, T')
    m_re = jnp.asarray(modes.real.astype(np.float32))
    m_im = jnp.asarray(modes.imag.astype(np.float32))
    d_re = jnp.asarray(dynamics.real.astype(np.float32))
    d_im = jnp.asarray(dynamics.imag.astype(np.float32))
    return jnp.matmul(m_re, d_re, precision=HIGHEST) - jnp.matmul(
        m_im, d_im, precision=HIGHEST
    )


def forecast_times(n_history: int, n_future: int, dt: float) -> jax.Array:
    """Times covering the training window plus ``n_future`` extra steps."""
    return jnp.arange(n_history + n_future) * dt


def undo_preprocessing(
    x: jax.Array,
    mean: jax.Array | None = None,
    std: jax.Array | None = None,
    delay: int = 1,
) -> jax.Array:
    """Invert standardize + delay-embed on reconstructed snapshots.

    Args:
        x: (S * delay, T') reconstructed embedded snapshots.
        mean/std: (S * delay,) per-row statistics (already tiled across
            delay blocks by the pipeline, matching era5_svd.py:400-414).
        delay: embedding depth d; the last block (delay coordinate 0,
            i.e. the undelayed rows) is returned.
    """
    if std is not None:
        x = x * std[:, None]
    if mean is not None:
        x = x + mean[:, None]
    if delay > 1:
        s = x.shape[0] // delay
        x = x[(delay - 1) * s :, :]
    return x


def _extract_model(result):
    """(alpha, amplitudes, modes) as host numpy, for either result type."""
    import numpy as np

    if isinstance(result, DMDResult):
        alpha = np.asarray(jax.device_get(result.omega))
    else:
        alpha = np.asarray(jax.device_get(result.alpha))
    scale = np.asarray(jax.device_get(result.amplitudes))
    modes = np.asarray(jax.device_get(result.modes))
    return alpha, scale, modes


def iter_forecast_blocks(
    result: DMDResult | OptDMDResult,
    t,
    mean=None,
    std=None,
    delay: int = 1,
    block_rows: int | None = None,
):
    """Yield ``(s0, fields_blk)`` of the physical-unit forecast field,
    streamed in row blocks — the out-of-core rollout (review r4 item 2).

    Equivalent to ``undo_preprocessing(rollout(result, t), mean, std,
    delay)`` but no (S*d, T') array ever materializes: only rows of the
    delay-0 block (the undelayed rows, reference convention at
    /root/reference/src/dmd_era5/slice_tools/slice_tools.py:255-274) go
    through the rollout GEMM, one device-resident block at a time, and
    the inverse standardization applies per block.  Device residency is
    O(block_rows x len(t)); host residency is whatever the caller keeps.
    """
    import numpy as np

    alpha, scale, modes = _extract_model(result)
    t_host = np.asarray(jax.device_get(t), dtype=np.float64)
    dynamics = scale[:, None] * np.exp(np.outer(alpha, t_host))  # (r, T')
    d_re = jnp.asarray(dynamics.real.astype(np.float32))
    d_im = jnp.asarray(dynamics.imag.astype(np.float32))

    n_embedded = modes.shape[0]
    s_out = n_embedded // delay
    offset = (delay - 1) * s_out
    mean_h = None if mean is None else np.asarray(jax.device_get(mean))
    std_h = None if std is None else np.asarray(jax.device_get(std))
    if block_rows is None:
        # ~256 MB f32 device residency per block
        block_rows = max(4096, (1 << 26) // max(len(t_host), 1))

    @jax.jit
    def _block(m_re, m_im, d_re, d_im):
        return jnp.matmul(m_re, d_re, precision=HIGHEST) - jnp.matmul(
            m_im, d_im, precision=HIGHEST
        )

    for s0 in range(0, s_out, block_rows):
        s1 = min(s0 + block_rows, s_out)
        m_blk = modes[offset + s0 : offset + s1]
        blk = np.asarray(
            _block(
                jnp.asarray(m_blk.real.astype(np.float32)),
                jnp.asarray(m_blk.imag.astype(np.float32)),
                d_re,
                d_im,
            )
        )
        if std_h is not None:
            blk = blk * std_h[offset + s0 : offset + s1, None]
        if mean_h is not None:
            blk = blk + mean_h[offset + s0 : offset + s1, None]
        yield s0, blk


def streamed_forecast_scores(
    result: DMDResult | OptDMDResult,
    t_leads,
    truth,
    latitudes=None,
    mean=None,
    std=None,
    delay: int = 1,
    climatology=None,
    block_rows: int | None = None,
) -> dict:
    """Holdout skill scores with O(block) residency.

    Rolls the fitted model out at the lead times only, streams the
    physical-unit forecast blocks straight into the latitude-weighted
    score accumulators (exact blockwise reductions — see
    ``verification.ScoreAccumulator``), and never materializes an
    (S, L) forecast array anywhere.
    """
    import numpy as np

    from dmd_era5_tpu.models.verification import (
        ScoreAccumulator,
        _space_weights,
    )

    truth = np.asarray(truth)
    s_out = truth.shape[0]
    w = (
        None
        if latitudes is None
        else np.asarray(_space_weights(latitudes, s_out))
    )
    clim = None if climatology is None else np.asarray(climatology)
    acc = ScoreAccumulator()
    for s0, blk in iter_forecast_blocks(
        result, t_leads, mean, std, delay, block_rows
    ):
        s1 = s0 + blk.shape[0]
        acc.update(
            blk,
            truth[s0:s1],
            None if w is None else w[s0:s1],
            None if clim is None else clim[s0:s1],
        )
    return acc.finalize()
