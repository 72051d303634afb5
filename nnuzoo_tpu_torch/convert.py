"""JAX package parameters -> this package's ``state_dict``, and back.

The port's submodule names mirror the flax names, so conversion is a walk over
the flattened flax tree:

- a conv ``kernel`` (k..., in, out), 2d or 3d, becomes ``weight`` (out, in,
  k...); a depthwise one (kh, kw, 1, C) becomes (C, 1, kh, kw) by the same
  permutation;
- a transposed conv's ``kernel`` (a module named ``transpconv``; flax's
  ``ConvTranspose``, k..., in, out) becomes ``weight`` (in, out, k...) with
  every spatial axis flipped: flax's transposed conv applies its kernel
  mirrored against torch's;
- a dense ``kernel`` (in, out) becomes ``weight`` (out, in);
- a LayerNorm/GroupNorm ``scale`` becomes ``weight``;
- everything else passes through: biases, the raw SS2D and SSND
  parameters (``x_proj_weight`` (K, R+2N, D), ``dt_projs_weight``,
  ``dt_projs_bias``, ``A_logs`` (K*D, N), ``Ds``, with K = 4 directions, or
  6 for a 3d SSND), a Mamba scan branch's (``conv1d_weight`` (d_conv, d_inner),
  ``conv1d_bias``, ``dt_proj_weight`` (d_inner, R), ``dt_proj_bias``,
  ``A_log`` (d_inner, N), ``D``), a Mamba2Block's (``conv1d_weight``
  (d_conv, d_inner + 2N), ``conv1d_bias``, ``A_log``, ``dt_bias`` and ``D``
  (nheads,), ``norm_weight`` (d_inner,)), ``skip_scale``, UNETR's ``pos_embed`` (1,
  tokens, hidden), a window attention's ``relative_position_bias_table``
  (prod(2w-1), heads), and RMSNorm's ``weight``, whose flax name is
  ``weight``; norms without scale or bias (SegMamba's and
  LightMUNet's per-channel GroupNorms, the GSCs of SSND2Net's mixers) have
  no leaf on either side. An SSND's depthwise ``conv`` kernel (3, 3, 3, 1,
  D) at 3d and its LayerNorms (``out_norm``, a mixer's ``ln{i}``, a mini's
  ``patch_norm``) follow the rules above.

Any key left over on either side, or any shape that disagrees, raises.
:func:`adamw_state_from_optax` maps the JAX trainer's optax AdamW moments the
same way, and :func:`sgd_state_from_optax` its SGD momentum.
:func:`params_from_state_dict` is the reverse walk (a 1-d ``weight`` is a
norm's ``scale``, but an RMSNorm's, which it finds through the model it is
given); it also takes a dict of gradients by parameter name.
"""

from collections.abc import Mapping
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from .models.mamba import RMSNorm


def flatten_params(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mapping of arrays -> {"a.b.c": array}."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(flatten_params(value, name))
        else:
            out[name] = np.asarray(value)
    return out


def _convert_leaf(path, leaf: str, value: np.ndarray):
    if leaf == "kernel":
        nd = value.ndim
        if nd == 2:
            return "weight", value.T
        if path and path[-1] == "transpconv":
            return "weight", np.flip(value.transpose(nd - 2, nd - 1, *range(nd - 2)),
                                     axis=tuple(range(2, nd)))
        if nd in (3, 4, 5):
            return "weight", value.transpose(nd - 1, nd - 2, *range(nd - 2))
        raise ValueError(f"no rule for a {nd}-d kernel")
    if leaf == "scale":
        return "weight", value
    return leaf, value


def convert_params_by_name(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's params (``{"params": {...}}`` or the inner tree, a
    nested dict of arrays) under this package's names and layouts, on the
    CPU, checked against no model."""
    if set(params.keys()) == {"params"}:
        params = params["params"]
    converted = {}
    for key, value in flatten_params(params).items():
        *path, leaf = key.split(".")
        name, array = _convert_leaf(path, leaf, value)
        # a copy: arrays decoded from msgpack are read-only views
        converted[".".join(path + [name])] = torch.from_numpy(
            np.array(array, dtype=np.float32, order="C"))
    return converted


def convert_params(params: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The JAX package's params (``{"params": {...}}`` or the inner tree, a
    nested dict of arrays) as a ``state_dict`` for ``model``, on the CPU."""
    converted = convert_params_by_name(params)
    target = model.state_dict()
    missing = sorted(set(target) - set(converted))
    unused = sorted(set(converted) - set(target))
    if missing or unused:
        raise KeyError(f"parameter trees disagree: missing in the JAX params "
                       f"{missing[:10]} ({len(missing)}), unused JAX params "
                       f"{unused[:10]} ({len(unused)})")
    bad = [(k, tuple(converted[k].shape), tuple(v.shape))
           for k, v in target.items() if converted[k].shape != v.shape]
    if bad:
        raise ValueError(f"shape mismatches (JAX, torch): {bad[:10]}")
    return converted


def adamw_state_from_optax(opt_state: Mapping, model: nn.Module) -> Dict[int, dict]:
    """The JAX package's optimizer state of ``optax.chain(clip_by_global_norm,
    adamw)`` (the nested dict that ``utilities.flax_msgpack.msgpack_restore``
    makes of it) as the per-parameter ``state`` of ``torch.optim.AdamW`` over
    ``model.parameters()``. optax's ``count`` and AdamW's ``step`` both count
    the updates taken; ``mu`` and ``nu`` have the params' tree and layouts
    and become ``exp_avg`` and ``exp_avg_sq`` through :func:`convert_params`.
    Any other state (SGD's trace, another chain) raises."""
    chain = opt_state.get("1") if set(opt_state) == {"0", "1"} else None
    if not (opt_state.get("0") == {} and isinstance(chain, Mapping)
            and set(chain) == {"0", "1", "2"} and chain["1"] == {}
            and isinstance(chain["0"], Mapping)
            and set(chain["0"]) == {"count", "mu", "nu"}
            and set(chain["2"]) <= {"count"}):
        raise NotImplementedError(
            "only the optax state of chain(clip_by_global_norm, adamw) maps onto "
            "this package's optimizer; the JAX checkpoint holds another")
    adam = chain["0"]
    exp_avg = convert_params(adam["mu"], model)
    exp_avg_sq = convert_params(adam["nu"], model)
    step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    return {i: {"step": step.clone(), "exp_avg": exp_avg[name],
                "exp_avg_sq": exp_avg_sq[name]}
            for i, (name, _) in enumerate(model.named_parameters())}


def sgd_state_from_optax(opt_state: Mapping, model: nn.Module) -> Dict[int, dict]:
    """The JAX package's optimizer state of ``optax.chain(clip_by_global_norm,
    add_decayed_weights, sgd(momentum, nesterov))`` (the nested dict that
    ``utilities.flax_msgpack.msgpack_restore`` makes of it) as the
    per-parameter ``state`` of ``torch.optim.SGD`` over ``model.parameters()``:
    optax's ``trace`` (g + momentum * trace, zero at the start) is torch's
    ``momentum_buffer``, which torch starts from the first gradient, the
    same value. The schedule's ``count`` is the Trainer's ``step``. Any
    other state (AdamW's moments, another chain) raises."""
    sgd = opt_state.get("2") if set(opt_state) == {"0", "1", "2"} else None
    if not (isinstance(sgd, Mapping) and opt_state["0"] == {}
            and opt_state["1"] == {} and set(sgd) == {"0", "1"}
            and isinstance(sgd["0"], Mapping) and set(sgd["0"]) == {"trace"}
            and set(sgd["1"]) <= {"count"}):
        raise NotImplementedError(
            "only the optax state of chain(clip_by_global_norm, "
            "add_decayed_weights, sgd) maps onto this package's SGD (AdamW's "
            "onto its AdamW); the JAX checkpoint holds another")
    trace = convert_params(sgd["0"]["trace"], model)
    return {i: {"momentum_buffer": trace[name]}
            for i, (name, _) in enumerate(model.named_parameters())}


def params_from_state_dict(state: Mapping,
                           model: Optional[nn.Module] = None) -> dict:
    """A ``state_dict`` (or any {name: tensor} with its names, such as the
    gradients) as the JAX package's nested dict of numpy arrays, in flax
    names and layouts. ``model``: the module the names are of; its RMSNorms'
    ``weight`` keeps its name (without it, every 1-d ``weight`` becomes a
    norm's ``scale``)."""
    keep = set() if model is None else {
        f"{name}.weight" if name else "weight"
        for name, m in model.named_modules() if isinstance(m, RMSNorm)}
    tree: dict = {}
    for key, tensor in state.items():
        *path, leaf = key.split(".")
        value = tensor.detach().cpu().numpy()
        if leaf == "weight" and key not in keep:
            nd = value.ndim
            if nd == 1:
                leaf = "scale"
            elif nd == 2:
                leaf, value = "kernel", value.T
            elif path and path[-1] == "transpconv":
                leaf, value = "kernel", np.flip(value, axis=tuple(range(2, nd))) \
                    .transpose(*range(2, nd), 0, 1)
            elif nd in (3, 4, 5):
                leaf, value = "kernel", value.transpose(*range(2, nd), 1, 0)
            else:
                raise ValueError(f"no rule for a {nd}-d weight ({key})")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(value)
    return tree
