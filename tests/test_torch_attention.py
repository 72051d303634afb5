"""The port's attention blocks against the JAX package's
(``nnuzoo_tpu/models/attention.py``).

Seeded numpy inputs and converted parameters (the relative-position bias
tables drawn at 0.5, so that a misplaced entry shows), fp32 on the CPU on
both sides: each block's output to rtol 1e-4 with atol 1e-4 of its largest
magnitude, and the gradient of a seeded projection of it with respect to
the input and to every parameter to 1e-3 of that gradient's largest entry.
The shift masks and the window partitions are held exact. The Swin cases
cover the 2d rule (the window clamped to the map drops the shift; a window
that spans the whole map unclamped keeps it), padding to window multiples,
the N-d rule at 3d (no shift on an axis that the window covers) and the
N-d block at 2d under ``block2d``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.models import attention as ja  # noqa: E402
from nnuzoo_tpu_torch.convert import flatten_params, params_from_state_dict  # noqa: E402
from nnuzoo_tpu_torch.models import attention as ta  # noqa: E402

from .torch_port_helpers import load_converted, random_flax_params  # noqa: E402


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def check_block(jmod, tmod, x, seed=1):
    """Forward and every gradient of ``tmod`` against ``jmod``, fp32."""
    params = random_flax_params(jmod, jnp.asarray(x), seed=seed, train=False)

    @jax.jit
    def forward_backward(p, xx, cotangent):
        out, vjp = jax.vjp(lambda q, y: jmod.apply(q, y, train=False), p, xx)
        return out, vjp(cotangent)

    shape = jax.eval_shape(lambda p, y: jmod.apply(p, y, train=False), params,
                           jnp.asarray(x)).shape
    ct = _x(seed + 7, *shape)
    want, (jg_params, jg_x) = forward_backward(params, jnp.asarray(x),
                                               jnp.asarray(ct))
    want = np.asarray(want)
    tmod = load_converted(tmod, params)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tmod(xt)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    grads = {"input": xt.grad.numpy()}
    grads.update(flatten_params(params_from_state_dict(
        {n: p.grad for n, p in tmod.named_parameters()})))
    wants = {"input": np.asarray(jg_x)}
    wants.update(flatten_params(jg_params["params"]))
    assert sorted(grads) == sorted(wants)
    for k, w in wants.items():
        np.testing.assert_allclose(grads[k], w, rtol=0,
                                   atol=1e-3 * float(np.abs(w).max()), err_msg=k)


BLOCKS = {
    "mlp": (lambda: ja.MLP(24, 8), lambda: ta.MLP(8, 24, 8), (2, 5, 8)),
    "vit_block": (lambda: ja.ViTBlock(2), lambda: ta.ViTBlock(16, 2), (2, 9, 16)),
    "vit_block_qkv_bias": (lambda: ja.ViTBlock(4, mlp_ratio=2.0, qkv_bias=True),
                           lambda: ta.ViTBlock(16, 4, 2.0, qkv_bias=True),
                           (3, 6, 16)),
    # 14x14, window 7, shift 3: two windows an axis, four shift regions
    "swin_14x14_shift3": (lambda: ja.SwinBlock(2, 7, 3),
                          lambda: ta.SwinBlock(8, 2, (14, 14), 7, 3), (2, 14, 14, 8)),
    # 10x12 padded to 14x14 after norm1, shifted over the padded map
    "swin_10x12_padded": (lambda: ja.SwinBlock(2, 7, 3),
                          lambda: ta.SwinBlock(8, 2, (10, 12), 7, 3), (2, 10, 12, 8)),
    # 5x6: the window clamps to 5 and the shift is dropped; W pads to 10
    "swin_clamped": (lambda: ja.SwinBlock(2, 7, 3),
                     lambda: ta.SwinBlock(8, 2, (5, 6), 7, 3), (2, 5, 6, 8)),
    # 7x7: the window spans the map unclamped and keeps its shift
    "swin_window_is_map": (lambda: ja.SwinBlock(2, 7, 3),
                           lambda: ta.SwinBlock(8, 2, (7, 7), 7, 3), (2, 7, 7, 8)),
    # 3x9x8, window 4, shift 2: axis 0 covered (window 3, no shift), 9 pads to 12
    "swin_nd_3d_covered_axis": (lambda: ja.SwinBlockND(2, 4, 2),
                                lambda: ta.SwinBlockND(8, 2, (3, 9, 8), 4, 2),
                                (2, 3, 9, 8, 8)),
    "swin_nd_3d_unshifted": (lambda: ja.SwinBlockND(2, 4, 0),
                             lambda: ta.SwinBlockND(8, 2, (4, 6, 8), 4, 0),
                             (1, 4, 6, 8, 8)),
    # at 2d the N-d block is a SwinBlock named block2d
    "swin_nd_2d": (lambda: ja.SwinBlockND(2, 4, 2),
                   lambda: ta.SwinBlockND(8, 2, (8, 10), 4, 2), (2, 8, 10, 8)),
}


class _Apply:
    """A flax module whose __call__ takes no ``train`` argument, given one."""

    def __init__(self, module):
        self.module = module

    def init(self, key, x, train=False):
        return self.module.init(key, x)

    def apply(self, params, x, train=False):
        return self.module.apply(params, x)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_forward_and_gradients_match_jax(name):
    make_jax, make_torch, shape = BLOCKS[name]
    check_block(make_jax(), make_torch(), _x(2, *shape))


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attention_matches_jax(qkv_bias):
    check_block(_Apply(ja.Attention(2, qkv_bias)), ta.Attention(8, 2, qkv_bias),
                _x(3, 2, 7, 8))


@pytest.mark.parametrize("spatial,window,shift", [
    ((14, 14), (7, 7), (3, 3)), ((14, 21), (7, 7), (3, 3)),
    ((8, 12, 12), (4, 4, 4), (2, 2, 2)), ((3, 12, 8), (3, 4, 4), (0, 2, 2)),
    ((28, 14, 14), (7, 7, 7), (3, 3, 3))])
def test_shift_mask_is_exact(spatial, window, shift):
    want = np.asarray(ja._shift_attn_mask_nd(spatial, window, shift))
    got = ta.shift_attn_mask_nd(spatial, window, shift).numpy()
    assert got.dtype == np.float32 and set(np.unique(got)) <= {0.0, -100.0}
    np.testing.assert_array_equal(got, want)
    if len(spatial) == 2 and spatial[0] == spatial[1]:
        np.testing.assert_array_equal(
            ta.shift_attn_mask(*spatial, window[0], shift[0]).numpy(),
            np.asarray(ja._shift_attn_mask(*spatial, window[0], shift[0])))


@pytest.mark.parametrize("shape,window", [
    ((2, 14, 21, 3), (7, 7)), ((1, 8, 12, 4, 2), (4, 3, 2)), ((2, 6, 6, 6, 1), (3, 3, 3))])
def test_window_partitions_are_exact(shape, window):
    x = _x(4, *shape)
    want = np.asarray(ja.window_partition_nd(jnp.asarray(x), window))
    got = ta.window_partition_nd(torch.from_numpy(x), window)
    np.testing.assert_array_equal(got.numpy(), want)
    back = ta.window_reverse_nd(got, window, shape[1:-1])
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ja.window_reverse_nd(jnp.asarray(want), window,
                                                      shape[1:-1])))
    np.testing.assert_array_equal(back.numpy(), x)
    if len(window) == 2 and window[0] == window[1]:
        w = window[0]
        np.testing.assert_array_equal(
            ta.window_partition(torch.from_numpy(x), w).numpy(),
            np.asarray(ja.window_partition(jnp.asarray(x), w)))
        np.testing.assert_array_equal(
            ta.window_reverse(got, w, *shape[1:3]).numpy(),
            np.asarray(ja.window_reverse(jnp.asarray(want), w, *shape[1:3])))


def test_window_block_refuses_a_map_it_was_not_built_for():
    """A 5x6 map clamps the window to 5; a block built for 14x14 has a
    7x7 window's bias table."""
    block = ta.SwinBlock(8, 2, (14, 14), 7, 3)
    with pytest.raises(ValueError, match="built for"):
        block(torch.zeros(1, 5, 6, 8))
    block(torch.zeros(1, 10, 12, 8))          # still window 7: runs


def test_masks_and_indices_stay_out_of_the_state_dict():
    block = ta.SwinBlockND(8, 2, (3, 9, 8), 4, 2)
    assert sorted(block.state_dict()) == sorted(
        n for n, _ in block.named_parameters())
    assert block.attn.relative_position_bias_table.shape == (5 * 7 * 7, 2)
    assert ta.SwinBlockND(8, 2, (8, 10), 4, 2).block2d.attn \
        .relative_position_bias_table.shape == (49, 2)


def test_a_block_served_in_inference_mode_then_trains():
    """The cached relative-position index and shift regions are made
    outside inference mode: a training step after a prediction (as a
    trainer's final validation and a continued run do) can save them."""
    block = ta.SwinBlockND(8, 2, (3, 11, 10), 5, 2)
    with torch.inference_mode():
        block(torch.zeros(1, 3, 11, 10, 8))
    x = torch.randn(1, 3, 11, 10, 8, requires_grad=True)
    block(x).sum().backward()
    assert x.grad is not None and block.attn.relative_position_bias_table.grad is not None
