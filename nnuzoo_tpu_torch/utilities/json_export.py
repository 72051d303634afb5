"""Make nested structures JSON-serializable (reference: `nnunetv2/utilities/json_export.py`).

This package's copy of ``nnuzoo_tpu/utilities/json_export.py``; the port imports nothing of
the JAX package.
"""

import numpy as np


def recursive_fix_for_json_export(obj):
    """Recursively convert numpy scalars/arrays and tuples to JSON-compatible types."""
    if isinstance(obj, dict):
        # json keys must be str
        return {str(k) if not isinstance(k, (str, int, float, bool)) or isinstance(k, tuple)
                else k: recursive_fix_for_json_export(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [recursive_fix_for_json_export(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return recursive_fix_for_json_export(obj.tolist())
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj
