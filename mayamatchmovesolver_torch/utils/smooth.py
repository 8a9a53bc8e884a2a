"""Signal smoothing: average, gaussian and fourier (windowed convolve).

Vectorized re-implementation of the reference's smoothing utilities
(ref: python/mmSolver/utils/smooth.py:69-483): same semantics —
width <= 1.0 is a no-op, gaussian sigma = (width-1)/2, fourier smoothing
convolves with a gaussian/triangle/box window over a reflected-edge
signal.

Port of mayamatchmovesolver_tpu/utils/smooth.py: a copy of the
reference's host code.
"""

import numpy as np

SMOOTH_TYPE_AVERAGE = "average"
SMOOTH_TYPE_GAUSSIAN = "gaussian"
SMOOTH_TYPE_FOURIER = "fourier"
SMOOTH_TYPES = (
    SMOOTH_TYPE_AVERAGE,
    SMOOTH_TYPE_GAUSSIAN,
    SMOOTH_TYPE_FOURIER,
)


def smooth(smooth_type, value_array, width, filtr=None):
    """(ref: smooth.py:69-97.)"""
    if smooth_type == SMOOTH_TYPE_AVERAGE:
        return average_smooth(value_array, width)
    if smooth_type == SMOOTH_TYPE_GAUSSIAN:
        return gaussian_smooth(value_array, width)
    if smooth_type == SMOOTH_TYPE_FOURIER:
        return fourier_smooth(value_array, width, filtr=filtr)
    raise ValueError(
        "smoothType argument is invalid; must be one of %r"
        % (SMOOTH_TYPES,)
    )


def average_smooth(value_array, width):
    """Box average over a window of +-(width-1) frames
    (ref: smooth.py:99-147)."""
    sigma = width - 1.0
    values = np.asarray(value_array, dtype=float)
    if sigma <= 0.0:
        return list(values)
    n = values.size
    out = np.empty(n)
    half = int(sigma)
    for i in range(n):
        start = max(i - half, 0)
        end = min(i + half + 1, n)
        out[i] = values[start:end].mean()
    return list(out)


def gaussian_smooth(value_array, width):
    """Full-signal gaussian-weighted average
    (ref: smooth.py:167-209)."""
    sigma = (width - 1.0) * 0.5
    values = np.asarray(value_array, dtype=float)
    if sigma <= 0.0:
        return list(values)
    n = values.size
    idx = np.arange(n)
    # weights[i, j] = gaussian(sigma, i, j)
    w = np.exp(-((idx[:, None] - idx[None, :]) ** 2) / (2.0 * sigma**2))
    w /= w.sum(axis=1, keepdims=True)
    return list(w @ values)


def _generate_window(n, filtr=None):
    """(ref: smooth.py:348-396.)"""
    filtr = filtr or "gaussian"
    window = np.zeros(n)
    if filtr == "gaussian":
        mean = 1.0
        std = float(n - 1) / 2.0
        idx = np.arange(n)
        window = np.exp(-((idx - std) ** 2) / (2.0 * mean**2))
    elif filtr == "triangle":
        half_n = (n - 1) // 2
        window[half_n] = n
        for i in range(half_n):
            window[i] = half_n - i
            window[n - i - 1] = half_n - i
    elif filtr == "box":
        window[:] = 1.0
    else:
        raise ValueError("invalid filter: %r" % filtr)
    return window / window.sum()


def fourier_smooth(value_array, width, filtr=None):
    """Windowed convolution with reflected edges
    (ref: smooth.py:398-483)."""
    sigma = (width - 1.0) * 0.5
    data = np.asarray(value_array, dtype=float)
    if sigma <= 0.0:
        return list(data)
    n = ((int(width) - 1) * 2) + 1
    window = _generate_window(n, filtr=filtr)
    s = np.r_[data[n - 1:0:-1], data, data[-2:-n - 1:-1]]
    x = np.convolve(s, window, mode="valid")
    if n % 2 == 1:
        x = x[n // 2: -(n // 2)]
    else:
        x = x[(n // 2) - 1: -(n // 2)]
    assert len(x) == len(data)
    return list(x)
