"""The port's four LM2NetBase variants (LM2Net, LM2NetP, LightMamba2Net,
LightMamba2NetP) against the JAX package's, at a small patch, 2d and 3d
(32x32; 4x16x16 or 8x16x16).

Seeded numpy input and converted parameters (which convert back to the
flax tree exactly), every mini cut to one level in both packages (the
outer network, its stage tables and the bottleneck minis stay; the minis
at depth are in ``test_torch_lm2net.py``, the full-depth parameter counts
and scan tables in ``test_torch_lm2net_tables.py``), in fp32 on both sides:
these widths' depthwise convolutions have no fast fp64 path on the CPU in
either package (torch loops over the 256-512 groups, XLA takes a minute to
compile them). Each direct child of the model (the stages, the patch
mergings and expansions, the concat-back Linears, the side heads, the
fused head) is held to the JAX child on the input the JAX model gave it,
rtol 1e-3 with atol 1e-4 of its largest magnitude; and the port's own
forward, each child replaying the JAX child's output, gives each child the
JAX child's input to 1e-6 of its largest magnitude (the outer network's
pads, concatenations, pools and resizes). LM2Net(P)'s seven outputs also
end to end, to the whole-model limits of ``PERF.md``: rtol 1e-3 with atol
5e-4 of the largest magnitude.

LightMamba2Net(P) are compared child by child only: with random weights a
Mamba2 mini moves its output 20-40 times as much as a change of its input
(``PERF.md``), so across eleven minis rounding of any precision grows past
any tolerance. LM2NetP at 44x40, its minis at two levels, pools its stage-1d
mini by the reference's plan for it (stage 3's).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.models import lm2net as jl  # noqa: E402
from nnuzoo_tpu_torch.convert import flatten_params, params_from_state_dict  # noqa: E402
from nnuzoo_tpu_torch.models import lm2net as tl  # noqa: E402
from nnuzoo_tpu_torch.models.layers import conv_cl  # noqa: E402

from .torch_port_helpers import (assert_close, load_converted,  # noqa: E402
                                 random_flax_params)

NC = 3
VARIANTS = {"LM2Net": (False, False), "LM2NetP": (True, False),
            "LightMamba2Net": (False, True), "LightMamba2NetP": (True, True)}


def one_level_minis(monkeypatch):
    """Every mini of both packages at one level (down0 and the head)."""
    jmini, tmini = jl.MiniLightMUNet, tl.MiniLightMUNet
    monkeypatch.setattr(jl, "MiniLightMUNet", lambda mid, out, n, *a, **k:
                        jmini(mid, out, 1, *a, **k))
    monkeypatch.setattr(tl, "MiniLightMUNet", lambda c, mid, out, n, *a, **k:
                        tmini(c, mid, out, 1, *a, **k))


def jax_children(jmod, params, x):
    """The JAX model: its outputs, and each direct child's first argument
    and output, {name: (input, output)}, as numpy arrays."""
    def run(p, v):
        calls = {}

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            scope = context.module.scope
            if context.method_name == "__call__" and scope is not None \
                    and len(scope.path) == 1:
                calls[scope.path[0]] = (args[0], out)
            return out

        with fnn.intercept_methods(record):
            outs = jmod.apply(p, v)
        return outs, calls

    return jax.tree.map(np.asarray, jax.jit(run)(params, jnp.asarray(x)))


class _Replay(torch.nn.Module):
    """A child that checks the input the port's forward gives it against
    the JAX child's, holds the port's child on the JAX input to the JAX
    output, and returns the JAX output."""

    def __init__(self, name, child, jin, jout, checked):
        super().__init__()
        self.name, self.child, self.jin, self.jout = name, child, jin, jout
        self.checked = checked
        self.channels_first = isinstance(child, (torch.nn.Conv2d, torch.nn.Conv3d))

    def forward(self, x, *rest):
        if self.channels_first:
            x = x.movedim(1, -1)
        listed = isinstance(self.jin, list)
        got = [t.detach().numpy() for t in x] if listed else [x.detach().numpy()]
        want = self.jin if listed else [self.jin]
        assert len(got) == len(want), self.name
        for g, w in zip(got, want):
            assert_close(g, w, rtol=0, atol=1e-6 * float(np.abs(w).max()),
                         what=f"input of {self.name}")
        jin = [torch.from_numpy(w.copy()) for w in want]
        with torch.no_grad():
            if self.channels_first:
                out = conv_cl(self.child, jin[0])
            else:
                out = self.child(jin if listed else jin[0], *rest)
        assert_close(out, self.jout, rtol=1e-3,
                     atol=1e-4 * float(np.abs(self.jout).max()),
                     what=f"output of {self.name}")
        self.checked.append(self.name)
        out = torch.from_numpy(self.jout.copy())
        return out.movedim(-1, 1) if self.channels_first else out


def check_whole_model(name, shape, monkeypatch, end_to_end=True):
    small, m2 = VARIANTS[name]
    patch = shape[1:-1]
    monkeypatch.setenv("NNUZOO_SCAN_BACKEND", "ref")
    side = 3 if (small and m2) else 1
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    jmod = jl.LM2NetBase(NC, len(patch), small=small, use_mamba2=m2,
                         patch_size=patch, side_kernel=side)
    params = random_flax_params(jmod, jnp.asarray(x))
    want, calls = jax_children(jmod, params, x)
    tmod = load_converted(tl.LM2NetBase(shape[-1], NC, patch, small=small,
                                        use_mamba2=m2, side_kernel=side), params)
    # the converter both ways: every leaf back under its flax name and layout
    back = flatten_params(params_from_state_dict(tmod.state_dict(), tmod))
    flat = flatten_params(params["params"])
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert [tuple(o.shape) for o in got] == [w.shape for w in want]
    assert len(got) == 7 and got[0].shape == shape[:-1] + (NC,)
    if end_to_end and not m2:
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, rtol=1e-3, atol=5e-4 * float(np.abs(w).max()),
                         what=f"{name} output {i}")

    names = [n for n, _ in tmod.named_children()]
    assert sorted(names) == sorted(calls)
    checked = []
    for n in names:
        setattr(tmod, n, _Replay(n, getattr(tmod, n), *calls[n], checked))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert sorted(checked) == sorted(names)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    return tmod


@pytest.mark.parametrize("name", list(VARIANTS))
def test_2d_matches_jax(name, monkeypatch):
    one_level_minis(monkeypatch)
    check_whole_model(name, (1, 32, 32, 1), monkeypatch)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_3d_matches_jax(name, monkeypatch):
    """At 4x16x16 (LM2Net(P): their Mamba scans on the CPU grow with the
    tokens) and 8x16x16, anisotropic merges (1, 2, 2) first."""
    one_level_minis(monkeypatch)
    m2 = VARIANTS[name][1]
    check_whole_model(name, (1, 8, 16, 16, 1) if m2 else (1, 4, 16, 16, 1),
                      monkeypatch)


def test_lm2netp_plan_quirk_at_odd_extents(monkeypatch):
    """At 44x40 the stage plans halve to 11x10: LM2NetP's stage-1d mini
    pools its 44x40 map by (1, 2), stage 3's plan, where its own plan would
    pool by (2, 2), and the port follows. The map always has the model's
    patch, so these pools halve even extents and the up path's resizes keep
    integer ratios: the nearest resize's non-integer case arises in a mini
    fed off its plan (``test_torch_lm2net.py``). Child by child only: at
    two levels a mini, fp32 rounding reaches 1.7x the whole-model limit at
    2 of the 5,280 outputs."""
    monkeypatch.setattr(jl, "_N_LAYERS", (2, 2, 2, 2))
    monkeypatch.setattr(tl, "_N_LAYERS", (2, 2, 2, 2))
    model = check_whole_model("LM2NetP", (1, 44, 40, 1), monkeypatch,
                              end_to_end=False)
    # the model's children are the replays now, each holding its own
    assert model.stage1d.child.scales((44, 40)) == [(1, 1), (1, 2)]
    assert model.stage1.child.scales((44, 40)) == [(1, 1), (2, 2)]
