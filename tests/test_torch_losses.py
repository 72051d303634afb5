"""The port's losses against the JAX package's (``training/losses.py`` of
both): the same numpy inputs from a seed through each function and its twin,
with and without ignore label and regions. fp32 on both sides with other
orders of the sums: 1e-5 absolute and relative."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.training import losses as jl  # noqa: E402
from nnuzoo_tpu_torch.training import losses as tl  # noqa: E402

B, C, H, W = 2, 4, 12, 10
TOL = dict(rtol=1e-5, atol=1e-5)


def _logits_labels(seed, ignore=None):
    rng = np.random.RandomState(seed)
    logits = (2 * rng.randn(B, C, H, W)).astype(np.float32)
    labels = rng.randint(0, C, (B, 1, H, W)).astype(np.int16)
    if ignore is not None:
        labels[rng.rand(B, 1, H, W) < 0.2] = ignore
    return logits, labels


def _both(jfn, tfn, arrays, **kwargs):
    want = jfn(*(jnp.asarray(a) for a in arrays), **kwargs)
    got = tfn(*(torch.from_numpy(a) for a in arrays), **kwargs)
    return got, want


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("batch_dice", [False, True])
@pytest.mark.parametrize("do_bg", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_soft_dice(batch_dice, do_bg, masked):
    rng = np.random.RandomState(0)
    logits, labels = _logits_labels(1)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=1))
    arrays = [probs, labels]
    kwargs = dict(batch_dice=batch_dice, do_bg=do_bg, smooth=1e-5)
    mask = (rng.rand(B, 1, H, W) < 0.7).astype(np.float32) if masked else None
    want = jl.memory_efficient_soft_dice(
        jnp.asarray(probs), jnp.asarray(labels),
        loss_mask=None if mask is None else jnp.asarray(mask), **kwargs)
    got = tl.memory_efficient_soft_dice(
        torch.from_numpy(probs), torch.from_numpy(labels),
        loss_mask=None if mask is None else torch.from_numpy(mask), **kwargs)
    _close(got, want)
    # a one-hot target of the probabilities' shape is taken as it is
    onehot = np.eye(C, dtype=np.float32)[labels[:, 0].astype(int)].transpose(0, 3, 1, 2)
    _close(tl.memory_efficient_soft_dice(torch.from_numpy(probs),
                                         torch.from_numpy(onehot), **kwargs),
           jl.memory_efficient_soft_dice(jnp.asarray(probs), jnp.asarray(onehot),
                                         **kwargs))


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropies(masked):
    logits, labels = _logits_labels(2)
    mask = (np.random.RandomState(3).rand(B, H, W) < 0.6) if masked else None
    for name, kwargs in (("robust_cross_entropy", {}),
                         ("topk_cross_entropy", {"k_percent": 10.0})):
        want = getattr(jl, name)(jnp.asarray(logits), jnp.asarray(labels[:, 0]),
                                 loss_mask=None if mask is None else jnp.asarray(mask),
                                 **kwargs)
        got = getattr(tl, name)(torch.from_numpy(logits),
                                torch.from_numpy(labels[:, 0]),
                                loss_mask=None if mask is None
                                else torch.from_numpy(mask), **kwargs)
        _close(got, want)


@pytest.mark.parametrize("batch_dice", [False, True])
@pytest.mark.parametrize("ignore", [None, C])
def test_dice_ce_loss_and_its_gradient(batch_dice, ignore):
    logits, labels = _logits_labels(4, ignore)
    kwargs = dict(batch_dice=batch_dice, ignore_label=ignore)
    got, want = _both(jl.dice_ce_loss, tl.dice_ce_loss, [logits, labels], **kwargs)
    _close(got, want)
    g_want = jax.grad(lambda x: jl.dice_ce_loss(x, jnp.asarray(labels), **kwargs))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    tl.dice_ce_loss(x, torch.from_numpy(labels), **kwargs).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_want), rtol=1e-4,
                               atol=1e-5 * float(np.abs(g_want).max()))


def test_dice_ce_loss_with_everything_ignored():
    logits, labels = _logits_labels(5)
    labels[:] = C
    got, want = _both(jl.dice_ce_loss, tl.dice_ce_loss, [logits, labels],
                      batch_dice=True, ignore_label=C)
    _close(got, want)


@pytest.mark.parametrize("batch_dice", [False, True])
@pytest.mark.parametrize("use_ignore", [False, True])
def test_dice_bce_loss(batch_dice, use_ignore):
    rng = np.random.RandomState(6)
    regions = 3
    logits = (2 * rng.randn(B, regions, H, W)).astype(np.float32)
    target = (rng.rand(B, regions + int(use_ignore), H, W) < 0.4).astype(np.float32)
    got, want = _both(jl.dice_bce_loss, tl.dice_bce_loss, [logits, target],
                      batch_dice=batch_dice, use_ignore_label=use_ignore)
    _close(got, want)


@pytest.mark.parametrize("n", [1, 2, 7])
def test_deep_supervision_weights(n):
    np.testing.assert_array_equal(tl.get_deep_supervision_weights(n),
                                  jl.get_deep_supervision_weights(n))


def test_deep_supervision_loss_skips_zero_weights():
    """The last output has weight zero and a target of another shape: it must
    not be evaluated."""
    outs, tgts = [], []
    for i, (h, w) in enumerate([(12, 10), (6, 5), (3, 3)]):
        rng = np.random.RandomState(10 + i)
        outs.append((2 * rng.randn(B, C, h, w)).astype(np.float32))
        tgts.append(rng.randint(0, C, (B, 1, h, w)).astype(np.int16))
    tgts[-1] = tgts[-1][:, :, :2]
    want = jl.deep_supervision_loss(
        lambda o, t: jl.dice_ce_loss(o, t, batch_dice=True),
        [jnp.asarray(o) for o in outs], [jnp.asarray(t) for t in tgts])
    got = tl.deep_supervision_loss(
        lambda o, t: tl.dice_ce_loss(o, t, batch_dice=True),
        [torch.from_numpy(o) for o in outs], [torch.from_numpy(t) for t in tgts])
    _close(got, want)


@pytest.mark.parametrize("has_regions", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_hard_dice_stats(has_regions, masked):
    rng = np.random.RandomState(7)
    logits, labels = _logits_labels(8)
    if has_regions:
        target = (rng.rand(B, C, H, W) < 0.4).astype(np.float32)
    else:
        target = labels
    mask = (rng.rand(B, 1, H, W) < 0.7).astype(np.float32) if masked else None
    want = jl.hard_dice_stats(
        jnp.asarray(logits), jnp.asarray(target), num_classes=C,
        has_regions=has_regions,
        ignore_label_mask=None if mask is None else jnp.asarray(mask))
    got = tl.hard_dice_stats(
        torch.from_numpy(logits), torch.from_numpy(target), num_classes=C,
        has_regions=has_regions,
        ignore_label_mask=None if mask is None else torch.from_numpy(mask))
    for g, w in zip(got, want):
        assert g.shape == (C if has_regions else C - 1,)
        _close(g, w)
