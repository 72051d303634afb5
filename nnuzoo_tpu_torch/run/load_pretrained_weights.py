"""Pretrained-weight transfer (port of ``nnuzoo_tpu/run/load_pretrained_weights.py``;
reference: `nnunetv2/run/load_pretrained_weights.py:7-95`): name- and
shape-matched parameter copy between checkpoints, skipping segmentation heads
(``seg``/``side``/``out`` layers), so encoders pretrained on one dataset can
initialize another.

The checkpoint is this package's (a ``state_dict``) or the JAX package's
(flax msgpack bytes, read with ``utilities.flax_msgpack`` and brought to this
package's names and layouts with ``convert.convert_params_by_name``). The
heads are matched on the flax form of each name (``params/a/b/leaf``), so the
same parameters transfer as in the JAX package. A library function, as in
the JAX package: ``run_training`` does not call it.
"""

from typing import Dict, Mapping, Tuple, Union

import torch
import torch.nn as nn

from ..convert import convert_params_by_name
from ..utilities.flax_msgpack import msgpack_restore
from ..utilities.io import load_pickle

_SKIP_SUBSTRINGS = (".seg_layers.", "side", "outconv", "/seg/", "/out/")


def _flax_key(name: str) -> str:
    return "params/" + name.replace(".", "/")


def load_pretrained_weights(target: Union[nn.Module, Mapping[str, torch.Tensor]],
                            pretrained_checkpoint_path: str,
                            verbose: bool = False
                            ) -> Tuple[Dict[str, torch.Tensor], int]:
    """``target`` is a model or its ``state_dict``. Returns (the new
    ``state_dict``, the number of transferred arrays)."""
    target_state = target.state_dict() if isinstance(target, nn.Module) else target
    weights = load_pickle(pretrained_checkpoint_path)["network_weights"]
    if isinstance(weights, (bytes, bytearray)):
        source = convert_params_by_name(msgpack_restore(weights))
    else:
        source = {k: torch.as_tensor(v) for k, v in weights.items()}

    transferred = 0
    new_state = {}
    for key, value in target_state.items():
        src = source.get(key)
        skip = any(s in _flax_key(key) for s in _SKIP_SUBSTRINGS)
        if src is not None and not skip and tuple(src.shape) == tuple(value.shape):
            new_state[key] = src.to(dtype=value.dtype)
            transferred += 1
            if verbose:
                print(f"transferred {key} {tuple(src.shape)}")
        else:
            new_state[key] = value
            if verbose and src is not None and not skip:
                print(f"shape mismatch {key}: {tuple(src.shape)} vs "
                      f"{tuple(value.shape)}")
    return new_state, transferred
