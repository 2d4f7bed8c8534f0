"""Input validation helpers.

Mirrors the behavioral contract of the reference implementation
(``rrmpg/utils/array_checks.py:15-73``): list / ndarray / pandas.Series
inputs are accepted, cast to a flat 1-D numpy array of the requested dtype,
and typed errors with the same messages are raised for bad input.

Unlike the reference (which JIT-compiles an early-exit scan with numba for
``check_for_negatives``), the negativity check here is a single vectorized
reduction -- on CPUs and accelerators alike a branch-free ``min < 0`` reduction over a
contiguous array is faster than an element-wise early-exit loop for all but
adversarially constructed inputs, and it is trivially batchable.
"""

import numpy as np


def check_for_negatives(arr) -> bool:
    """Return True if ``arr`` contains at least one negative value.

    Semantics follow the reference ``check_for_negatives``
    (``rrmpg/utils/array_checks.py:15-32``).
    """
    arr = np.asarray(arr)
    if arr.size == 0:
        return False
    return bool(np.min(arr) < 0)


def validate_array_input(arr, dtype, arr_name: str) -> np.ndarray:
    """Check that ``arr`` is numerical and return it as a flat numpy array.

    Accepts lists, tuples, numpy arrays, jax arrays and pandas Series;
    casts to ``dtype`` and flattens to 1-D.  Raises ``ValueError`` for non-numerical content and
    ``TypeError`` for unsupported container types (error taxonomy follows
    the reference, ``rrmpg/utils/array_checks.py:35-73``).
    """
    # Imported lazily so the core package does not hard-require pandas.
    import jax
    try:
        import pandas as pd
        series_types = (list, tuple, np.ndarray, jax.Array, pd.Series)
    except ImportError:  # pragma: no cover - pandas is normally available
        series_types = (list, tuple, np.ndarray, jax.Array)

    if isinstance(arr, series_types):
        try:
            arr = np.array(arr, dtype=dtype).flatten()
        except (ValueError, TypeError):
            raise ValueError(
                f"Could not cast '{arr_name}' to {np.dtype(dtype).name}: "
                "it contains non-numeric entries.")
    else:
        raise TypeError(
            f"'{arr_name}' has unsupported type {type(arr).__name__}; pass "
            "a list, tuple, numpy array or pandas Series.")

    return arr
