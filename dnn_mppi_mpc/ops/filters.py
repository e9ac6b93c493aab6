"""Control-sequence smoothing filters, exact to the reference's edge semantics.

Three filters smooth the weighted-noise update of the control sequence:

* :func:`moving_average_edge` — np.convolve 'same' with the reference's edge
  rescaling loop, including its quirks (controllers/mppi_differential_drive.py:257-271).
* :func:`moving_average_padded` — head/tail-slice padded convolution
  (controllers/mppi_race_car_obstacle.py:228-239).
* :func:`savgol_filter` — Savitzky-Golay with polynomial edge interpolation,
  matching scipy.signal.savgol_filter(mode='interp') as used by
  test/test_mppi_diff_obs.py:275-300.

All operate on (T, d) sequences along axis 0 and are jit/vmap friendly
(window sizes are static).
"""

from __future__ import annotations

import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


def _convolve_same_cols(x: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """np.convolve(mode='same') applied independently to each column of (T, d)."""
    conv = jax.vmap(lambda col: jnp.convolve(col, kernel, mode="same"), 1, 1)
    return conv(x)


def moving_average_edge(x: jnp.ndarray, window_size: int) -> jnp.ndarray:
    """Moving average with the reference's edge rescaling.

    Bit-matches controllers/mppi_differential_drive.py:257-271, including the
    quirk that the *last* element's scale is a cumulative product over the
    rescaling loop (the ``xx_mean[-1, d] *=`` line executes once per loop
    iteration) while elements -2..-n_conv are never rescaled.
    """
    T = x.shape[0]
    w = min(window_size, T)  # reference configs always satisfy w ≤ T
    kernel = jnp.ones((w,), dtype=x.dtype) / w
    out = _convolve_same_cols(x, kernel)

    n_conv = math.ceil(w / 2)
    scale = np.ones((T,), dtype=np.float64)
    scale[0] = w / n_conv
    last = 1.0
    for i in range(1, n_conv):
        scale[i] = w / (i + n_conv)
        last *= w / (i + n_conv - (w % 2))
    scale[-1] *= last
    return out * jnp.asarray(scale, dtype=x.dtype)[:, None]


def moving_average_padded(x: jnp.ndarray, window_size: int) -> jnp.ndarray:
    """Head/tail-slice padded moving average.

    Bit-matches controllers/mppi_race_car_obstacle.py:228-239: the left pad is
    the *first* w//2 samples and the right pad the *last* w//2 samples (copied,
    not reflected), then a 'same' convolution with the pad stripped.
    """
    w = min(window_size, x.shape[0])
    if w <= 1:
        # identity — and the generic slicing below breaks at w == 1:
        # x[-(0):] is the WHOLE array, not an empty pad (round-2 review)
        return x
    kernel = jnp.ones((w,), dtype=x.dtype) / w
    padded = jnp.concatenate([x[: w // 2], x, x[-(w // 2):]], axis=0)
    out = _convolve_same_cols(padded, kernel)
    return out[w // 2 : -(w // 2)] if w // 2 else out


def savgol_coefficients(window_size: int, polyorder: int) -> np.ndarray:
    """Center-point Savitzky-Golay coefficients (host-side, static).

    Same construction as test/test_mppi_diff_obs.py:154-160: pseudo-inverse of
    the Vandermonde design matrix over the centered window; row 0 gives the
    smoothing (0th-derivative) coefficients.
    """
    half = (window_size - 1) // 2
    j = np.arange(-half, half + 1, dtype=np.float64)
    b = np.stack([j**i for i in range(polyorder + 1)], axis=1)  # (w, p+1)
    m = np.linalg.pinv(b)  # (p+1, w)
    return m[0]


def savgol_filter(x: jnp.ndarray, window_size: int, polyorder: int) -> jnp.ndarray:
    """Savitzky-Golay smoothing along axis 0 with polynomial edge interpolation.

    Matches scipy.signal.savgol_filter(..., mode='interp') semantics (the filter
    used at test/test_mppi_diff_obs.py:293): interior points are the windowed
    least-squares fit evaluated at the center; the first/last half-windows are a
    single polynomial fit to the first/last ``window_size`` samples evaluated at
    their positions. Window/polyorder are clamped the way smooth_control_input
    does (window ≤ T, odd; polyorder < window).
    """
    T = x.shape[0]
    w = min(window_size, T)
    if w % 2 == 0:
        w -= 1
    p = min(polyorder, w - 1)
    if w <= 1:
        return x

    half = (w - 1) // 2
    coeffs = jnp.asarray(savgol_coefficients(w, p)[::-1].copy(), dtype=x.dtype)
    interior = _convolve_same_cols(x, coeffs)

    # Edge handling: polynomial LSQ fit to the first/last w samples, evaluated
    # at positions 0..half-1 (head) and T-half..T-1 (tail).
    j = np.arange(w, dtype=np.float64)
    design = np.stack([j**i for i in range(p + 1)], axis=1)  # (w, p+1)
    pinv = np.linalg.pinv(design)  # (p+1, w)
    head_eval = np.stack([np.arange(half) ** i for i in range(p + 1)], axis=1)
    tail_pos = np.arange(w - half, w, dtype=np.float64)
    tail_eval = np.stack([tail_pos**i for i in range(p + 1)], axis=1)
    head_mat = jnp.asarray(head_eval @ pinv, dtype=x.dtype)  # (half, w)
    tail_mat = jnp.asarray(tail_eval @ pinv, dtype=x.dtype)  # (half, w)

    head = head_mat @ x[:w]  # (half, d)
    tail = tail_mat @ x[-w:]
    out = interior
    out = out.at[:half].set(head)
    out = out.at[T - half :].set(tail)
    return out


def filter_matrix(
    kind_value: str, T: int, window: int, polyorder: int = 3
) -> np.ndarray:
    """The (T, T) matrix F of a smoothing filter: ``filter(x) == F @ x``.

    All three filters are linear in x with static shape parameters, so each is
    exactly one precomputed matrix. ``apply_filter`` uses this as its hot path:
    one (T, T)@(T, d) product in place of a chain of conv and edge-scatter
    ops.
    Host-side float64 numpy, mirroring the op implementations above
    column-by-column (equivalence pinned by tests/test_ops.py at 1e-12).
    """
    return _filter_matrix_cached(kind_value, T, window, polyorder)


@lru_cache(maxsize=None)
def _filter_matrix_cached(kind_value: str, T: int, window: int, polyorder: int):
    from ..config import SmoothingFilter

    kind = SmoothingFilter(kind_value)
    eye = np.eye(T, dtype=np.float64)

    def conv_same_cols(x, kernel):
        return np.stack(
            [np.convolve(x[:, j], kernel, mode="same") for j in range(x.shape[1])],
            axis=1,
        )

    if kind == SmoothingFilter.MOVING_AVERAGE_EDGE:
        w = min(window, T)
        out = conv_same_cols(eye, np.ones(w) / w)
        n_conv = math.ceil(w / 2)
        scale = np.ones((T,), dtype=np.float64)
        scale[0] = w / n_conv
        last = 1.0
        for i in range(1, n_conv):
            scale[i] = w / (i + n_conv)
            last *= w / (i + n_conv - (w % 2))
        scale[-1] *= last
        return out * scale[:, None]

    if kind == SmoothingFilter.MOVING_AVERAGE_PADDED:
        w = min(window, T)
        if w <= 1:
            return eye  # identity; eye[-(0):] below would double the rows
        padded = np.concatenate([eye[: w // 2], eye, eye[-(w // 2):]], axis=0)
        out = conv_same_cols(padded, np.ones(w) / w)
        return out[w // 2 : -(w // 2)] if w // 2 else out

    if kind == SmoothingFilter.SAVGOL:
        w = min(window, T)
        if w % 2 == 0:
            w -= 1
        p = min(polyorder, w - 1)
        if w <= 1:
            return eye
        half = (w - 1) // 2
        coeffs = savgol_coefficients(w, p)[::-1]
        out = conv_same_cols(eye, coeffs)
        j = np.arange(w, dtype=np.float64)
        design = np.stack([j**i for i in range(p + 1)], axis=1)
        pinv = np.linalg.pinv(design)
        head_eval = np.stack([np.arange(half) ** i for i in range(p + 1)], axis=1)
        tail_pos = np.arange(w - half, w, dtype=np.float64)
        tail_eval = np.stack([tail_pos**i for i in range(p + 1)], axis=1)
        out[:half] = (head_eval @ pinv) @ eye[:w]
        out[T - half :] = (tail_eval @ pinv) @ eye[-w:]
        return out

    raise ValueError(f"no matrix form for filter: {kind!r}")


def apply_filter(x: jnp.ndarray, kind, window: int, polyorder: int = 3) -> jnp.ndarray:
    """Dispatch on config.SmoothingFilter (string value or enum).

    Applies the filter as one precomputed (T, T) matmul (``filter_matrix``) —
    numerically equivalent to the op implementations above (which remain the
    tested semantic definition) but one matrix product instead of a conv +
    edge-fixup chain.
    """
    from ..config import SmoothingFilter

    kind = SmoothingFilter(kind) if not isinstance(kind, SmoothingFilter) else kind
    if kind == SmoothingFilter.NONE:
        return x
    F = jnp.asarray(filter_matrix(kind.value, x.shape[0], window, polyorder), x.dtype)
    return jnp.matmul(F, x, precision=jax.lax.Precision.HIGHEST)


__all__ = [
    "filter_matrix",
    "moving_average_edge",
    "moving_average_padded",
    "savgol_coefficients",
    "savgol_filter",
    "apply_filter",
]
