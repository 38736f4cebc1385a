"""
General-purpose helpers (counterpart of dedalus_tpu/tools/general.py).
"""

import numpy as np


def is_complex_dtype(dtype):
    return np.issubdtype(np.dtype(dtype), np.complexfloating)
