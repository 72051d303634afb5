"""The port's SwinUMamba and SwinUMambaD against the JAX package's.

Seeded numpy inputs and converted parameters, at ``feat_size=(4, 8, 16, 32,
64)`` (the VSSM encoder keeps its published depths and widths), 64x64, drop
path off (eval mode on both sides): every deep-supervision output in fp64
on both sides (``jax_apply_fp64``; the JAX scans stay fp32) to rtol 1e-3
with atol 1e-4 of its largest magnitude (the JAX scans' fp32 rounding, which
SwinUMambaD's last LayerNorm over a one-channel expansion magnifies, reads
up to 5e-4 of an entry), and the port's fp32 output to its own fp64 output within
5e-3 (``assert_model_matches_jax``). ``load_vmamba_pretrained`` on the
synthetic VMamba checkpoint of ``tests/test_zoo_models.py`` gives the tree
that the JAX function gives, exactly. The scan shapes of one forward at
256x224 are fixed on the meta device.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.models import swin_umamba as jsw  # noqa: E402
from nnuzoo_tpu_torch.convert import convert_params  # noqa: E402
from nnuzoo_tpu_torch.models import swin_umamba as tsw  # noqa: E402
from nnuzoo_tpu_torch.models.registry import get_model_builder  # noqa: E402
from nnuzoo_tpu_torch.plans.plans_handler import PlansManager  # noqa: E402

from .test_torch_light_munet import scan_shapes  # noqa: E402
from .torch_port_helpers import (assert_model_matches_jax,  # noqa: E402
                                 random_flax_params)

NC = 3
FEAT = (4, 8, 16, 32, 64)


@pytest.mark.parametrize("decoder", ["unetr", "mamba"])
def test_swin_umamba_matches_jax(decoder):
    jcls, tcls = ((jsw.SwinUMamba, tsw.SwinUMamba) if decoder == "unetr"
                  else (jsw.SwinUMambaD, tsw.SwinUMambaD))
    x = np.random.RandomState(1).randn(1, 64, 64, 1).astype(np.float32)
    got = assert_model_matches_jax(jcls(NC, feat_size=FEAT),
                                   tcls(1, NC, feat_size=FEAT), x, train=False)
    assert [tuple(o.shape) for o in got] == [(1, 64 // 2 ** i, 64 // 2 ** i, NC)
                                             for i in range(4)]


def _vmamba_checkpoint(enc, rng):
    """A VMamba-style torch state dict over the flax shapes, as
    ``tests/test_zoo_models.py::test_vmamba_pretrained_transfer`` makes it,
    with the keys the reference skips."""
    blk = enc["layer0"]["block0"]
    sa = blk["self_attention"]

    def t(*shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32))

    kh, kw, one, d = sa["conv2d"]["kernel"].shape
    return {
        "layers.0.blocks.0.ln_1.weight": t(*blk["ln_1"]["scale"].shape),
        "layers.0.blocks.0.self_attention.in_proj.weight":
            t(*sa["in_proj"]["kernel"].shape[::-1]),
        "layers.0.blocks.0.self_attention.conv2d.weight": t(d, one, kh, kw),
        "layers.0.blocks.0.self_attention.A_logs": t(*sa["A_logs"].shape),
        "layers.0.blocks.0.self_attention.dt_projs_weight":
            t(*sa["dt_projs_weight"].shape),
        "layers.2.blocks.8.self_attention.out_norm.bias":
            t(*enc["layer2"]["block8"]["self_attention"]["out_norm"]["bias"].shape),
        "layers.0.downsample.reduction.weight":
            t(*enc["down0"]["reduction"]["kernel"].shape[::-1]),
        "layers.1.downsample.norm.weight": t(*enc["down1"]["norm"]["scale"].shape),
        "patch_embed.proj.weight": torch.zeros(96, 3, 4, 4),
        "head.weight": torch.zeros(1000, 768),
        "layers.0.blocks.0.no_such_part.weight": torch.zeros(3)}


def test_load_vmamba_pretrained_matches_the_jax_tree(tmp_path):
    params = random_flax_params(jsw.SwinUMamba(NC, feat_size=FEAT),
                                jnp.zeros((1, 64, 64, 1)), seed=2, train=False)
    sd = _vmamba_checkpoint(params["params"]["vssm_encoder"],
                            np.random.RandomState(0))
    path = str(tmp_path / "vmamba_tiny.pth")
    torch.save({"model": sd}, path)
    jnew, jn = jsw.load_vmamba_pretrained(params, path, verbose=False)

    model = tsw.SwinUMamba(1, NC, feat_size=FEAT)
    model.load_state_dict(convert_params(params, model))
    n = tsw.load_vmamba_pretrained(model, torch.load(path), verbose=False)
    assert n == jn == 8
    want = convert_params(jax.tree.map(np.asarray, jnew), model)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    bad = {"layers.0.blocks.0.ln_1.weight": torch.zeros(5)}
    with pytest.raises(ValueError, match="shape"):
        tsw.load_vmamba_pretrained(model, bad)


# one forward at 256x224 (batch 12): (L, K*Dh, K)
SWIN_UMAMBA = {(3584, 768, 4): 2, (896, 1536, 4): 2, (224, 3072, 4): 9,
               (56, 6144, 4): 2}
SWIN_UMAMBA_D = {(3584, 768, 4): 3, (896, 1536, 4): 3, (224, 3072, 4): 10,
                 (56, 6144, 4): 2, (14336, 384, 4): 1}


@pytest.mark.parametrize("cls,want", [(tsw.SwinUMamba, SWIN_UMAMBA),
                                      (tsw.SwinUMambaD, SWIN_UMAMBA_D)])
def test_full_width_forward_scan_shapes(monkeypatch, cls, want):
    with torch.device("meta"):
        model = cls(1, NC).eval()
    assert scan_shapes(monkeypatch, model, (12, 256, 224, 1)) == want


def test_builders_and_deep_supervision_heads():
    dj = {"labels": {"background": 0, "a": 1, "b": 2}}
    pm = PlansManager({"configurations": {"2d": {"patch_size": [64, 64]},
                                          "3d_fullres": {"patch_size": [8, 64, 64]}}})
    for name, cls in (("nnUNetTrainerSwinUMamba", tsw.SwinUMamba),
                      ("nnUNetTrainerSwinUMambaD_50Percent", tsw.SwinUMambaD)):
        build = get_model_builder(name)
        m = build(pm, dj, pm.get_configuration("2d"), 1, deep_supervision=False,
                  device="cpu", feat_size=FEAT)
        assert type(m) is cls and not m.deep_supervision
        assert {f"out{i}.weight" for i in range(4)} <= set(m.state_dict())
        with torch.no_grad():
            assert len(m.eval()(torch.zeros(1, 64, 64, 1))) == 1
        with pytest.raises(ValueError, match="2D-only"):
            build(pm, dj, pm.get_configuration("3d_fullres"), 1, device="cpu")
