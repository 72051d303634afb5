"""Seeded 5-fold cross-validation splits (reference: `nnunetv2/utilities/crossval_split.py`).

Same semantics as sklearn KFold(n_splits, shuffle=True, random_state=seed) which the
reference uses, implemented with numpy so we don't depend on sklearn.
"""

from typing import List

import numpy as np


def generate_crossval_split(train_identifiers: List[str], seed: int = 12345,
                            n_splits: int = 5) -> List[dict]:
    ids = np.array(sorted(train_identifiers))
    n = len(ids)
    rng = np.random.RandomState(seed)
    idx = np.arange(n)
    rng.shuffle(idx)
    fold_sizes = np.full(n_splits, n // n_splits, dtype=int)
    fold_sizes[: n % n_splits] += 1
    splits = []
    current = 0
    for fs in fold_sizes:
        val_idx = idx[current:current + fs]
        train_idx = np.setdiff1d(idx, val_idx)
        splits.append({
            "train": [str(i) for i in ids[train_idx]],
            "val": [str(i) for i in ids[val_idx]],
        })
        current += fs
    return splits
