"""Inputs for the int8 row quantizer's tests, made from a seed with numpy."""
import numpy as np


def quant_input(shape, values, seed=0):
    """f32 rows: gaussian × 3; ``zeros``: a quarter zero rows and a quarter
    below the 1e-8 scale floor; ``ties``: 127·m and odd multiples of m/2
    with m a power of two, so x / scale lands on exact .5 steps;
    ``nonfinite``: gaussian × 3 with a NaN in every fourth row and an inf
    of either sign in the row after it."""
    rng = np.random.default_rng(seed)
    r, c = shape
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    if values == "zeros":
        x[: r // 4] = 0.0
        x[r // 4: r // 2] *= 1e-10
    elif values == "ties":
        m = 2.0 ** rng.integers(-3, 4, size=(r, 1))
        x = ((rng.integers(-127, 127, size=shape) + 0.5) * m).astype(np.float32)
        x[:, 0] = 127.0 * m[:, 0]
    elif values == "nonfinite":
        cols = rng.integers(0, c, size=r)
        x[0::4, :][np.arange(len(x[0::4])), cols[0::4]] = np.nan
        x[1::4, :][np.arange(len(x[1::4])), cols[1::4]] = np.inf * rng.choice([-1, 1], len(x[1::4]))
    return x
