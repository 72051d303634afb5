"""Device-side data augmentation (port of ``nnuzoo_tpu/data/augment.py``).

The same transforms as the JAX package: spatial transform (rotation p=0.2,
scaling 0.7-1.4 p=0.2), Gaussian noise p=0.1, Gaussian blur p=0.2, brightness
p=0.15, contrast p=0.15, simulated low resolution p=0.25, gamma (inverted
p=0.1, plain p=0.3), mirroring, masking, RemoveLabel(-1 -> 0), regions and
deep-supervision downsampling.

Where the JAX package maps a per-sample function over the batch, the functions
here take the whole batch, (B, C, *spatial) data and (B, S, *spatial) seg, as
torch ops on the tensors' device. Every transform is in two parts: a function
that draws the per-sample parameters from an explicit ``torch.Generator`` on
that device, and one that applies given parameters, which is what the tests
hold against the JAX functions (the two packages' random streams differ).
Random gates select between the transformed and the untouched sample with
``torch.where``, so nothing synchronises with the host.

A cascaded configuration moves the previous stage's segmentation (seg
channel 1) into the data as one-hot input channels, one per foreground label;
on the training path these channels are noised first: a random ball
morphology (dilate, erode, close or open) on every channel in a random order
with p=0.4 a sample, then the removal of a random connected component with
p=0.2 a sample. A translation target is a float image: the spatial transform
samples it linearly with fill 0, no label transform touches it, and its
deep-supervision targets come from an antialiased linear resize (JAX's
``jax.image.resize(..., "linear")``).
"""

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch


# --------------------------------------------------------------------- init patch
def rotate_coords_2d(coords, angle):
    rot = np.array([[np.cos(angle), -np.sin(angle)],
                    [np.sin(angle), np.cos(angle)]])
    return rot @ np.asarray(coords, dtype=float)


def rotate_coords_3d(coords, ax, ay, az):
    rx = np.array([[1, 0, 0],
                   [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    ry = np.array([[np.cos(ay), 0, np.sin(ay)],
                   [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]])
    rz = np.array([[np.cos(az), -np.sin(az), 0],
                   [np.sin(az), np.cos(az), 0],
                   [0, 0, 1]])
    return rz @ ry @ rx @ np.asarray(coords, dtype=float)


def get_patch_size(final_patch_size, rot_x, rot_y, rot_z, scale_range) -> np.ndarray:
    """The patch size to sample so that rotation and scaling still fill the
    final patch."""
    if isinstance(rot_x, (tuple, list)):
        rot_x = max(np.abs(rot_x))
    if isinstance(rot_y, (tuple, list)):
        rot_y = max(np.abs(rot_y))
    if isinstance(rot_z, (tuple, list)):
        rot_z = max(np.abs(rot_z))
    rot_x = min(np.pi / 2, rot_x)
    rot_y = min(np.pi / 2, rot_y)
    rot_z = min(np.pi / 2, rot_z)
    coords = np.array(final_patch_size)
    final_shape = np.copy(coords)
    if len(coords) == 3:
        final_shape = np.max(np.vstack(
            (np.abs(rotate_coords_3d(coords, rot_x, 0, 0)), final_shape)), 0)
        final_shape = np.max(np.vstack(
            (np.abs(rotate_coords_3d(coords, 0, rot_y, 0)), final_shape)), 0)
        final_shape = np.max(np.vstack(
            (np.abs(rotate_coords_3d(coords, 0, 0, rot_z)), final_shape)), 0)
    elif len(coords) == 2:
        final_shape = np.max(np.vstack(
            (np.abs(rotate_coords_2d(coords, rot_x)), final_shape)), 0)
    final_shape /= min(scale_range)
    return final_shape.astype(int)


# --------------------------------------------------------------------- config
@dataclass(frozen=True)
class AugmentConfig:
    """Static augmentation configuration (the JAX package's fields)."""
    patch_size: Tuple[int, ...]              # final patch size fed to the network
    initial_patch_size: Tuple[int, ...]      # inflated sampling patch size
    rotation: float                          # max |angle| in radians
    mirror_axes: Tuple[int, ...] = ()
    do_dummy_2d: bool = False                # 3D volume, rotate in-plane only
    use_mask_for_norm: Tuple[bool, ...] = ()
    deep_supervision_scales: Optional[Tuple[Tuple[float, ...], ...]] = None
    regions: Optional[Tuple[Tuple[int, ...], ...]] = None  # incl. ignore as last
    p_rotation: float = 0.2
    p_scaling: float = 0.2
    scale_range: Tuple[float, float] = (0.7, 1.4)
    # cascade: seg channel 1 is the previous stage's segmentation, moved into
    # the data as one-hot foreground channels and, when training, noised
    is_cascaded: bool = False
    p_cascade_binary_op: float = 0.4
    p_cascade_remove_component: float = 0.2
    cascade_strel_max: int = 8
    foreground_labels: Tuple[int, ...] = ()
    # 'segmentation' (integer labels) or 'translation' (a float target)
    target_type: str = "segmentation"

    @property
    def dim(self):
        return len(self.patch_size)


# --------------------------------------------------------------------- random draws
def _uniform(gen, shape, low=0.0, high=1.0):
    return low + (high - low) * torch.rand(shape, generator=gen, device=gen.device)


def _bernoulli(gen, shape, p=0.5):
    return torch.rand(shape, generator=gen, device=gen.device) < p


def _bg_contrast(gen, shape, low, high):
    """50% U(low, 1), 50% U(1, high)."""
    below = _uniform(gen, shape, low, 1.0)
    above = _uniform(gen, shape, 1.0, high)
    return torch.where(_bernoulli(gen, shape), below, above)


def _gate(flags, transformed, original):
    """Per-sample (or per-sample-and-channel) choice between two batches."""
    flags = flags.reshape(flags.shape + (1,) * (original.dim() - flags.dim()))
    return torch.where(flags, transformed, original)


# --------------------------------------------------------------------- spatial
def _round_half_away(x):
    return torch.sign(x) * torch.floor(x.abs() + 0.5)


def _affine_sample(vol, matrix, in_shape, out_shape, order: int, fill: float):
    """Sample vol (B, C, *in_shape) at the out-grid coordinates mapped through
    ``matrix`` (B, d, d), both grids centred; order 0 (nearest, halves rounded
    away from zero) or 1 (linear). A corner outside the volume reads ``fill``,
    as ``map_coordinates(mode="constant", cval=fill)`` has it."""
    dim = len(out_shape)
    dev = vol.device
    B, C = vol.shape[:2]
    grids = torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=dev)
                             - (s - 1) / 2.0 for s in out_shape], indexing="ij")
    flat = torch.stack(grids).reshape(dim, -1)                       # (d, Q)
    in_center = torch.tensor([(s - 1) / 2.0 for s in in_shape],
                             dtype=torch.float32, device=dev)
    mapped = matrix.float() @ flat + in_center[:, None]              # (B, d, Q)
    Q = flat.shape[1]
    src = vol.reshape(B, C, -1)
    strides = [int(np.prod(in_shape[i + 1:])) for i in range(dim)]

    if order == 0:
        nodes = [[(_round_half_away(mapped[:, i]).long(), None)] for i in range(dim)]
    elif order == 1:
        nodes = []
        for i in range(dim):
            lower = torch.floor(mapped[:, i])
            upper_w = mapped[:, i] - lower
            nodes.append([(lower.long(), 1 - upper_w), (lower.long() + 1, upper_w)])
    else:
        raise NotImplementedError("order must be 0 or 1")

    out = None
    for corner in np.ndindex(*[len(n) for n in nodes]):
        index = torch.zeros(B, Q, dtype=torch.long, device=dev)
        valid = torch.ones(B, Q, dtype=torch.bool, device=dev)
        weight = None
        for i, pick in enumerate(corner):
            idx, w = nodes[i][pick]
            valid &= (idx >= 0) & (idx < in_shape[i])
            index += idx.clamp(0, in_shape[i] - 1) * strides[i]
            if w is not None:
                weight = w if weight is None else weight * w
        got = torch.gather(src, 2, index[:, None].expand(B, C, Q))
        got = torch.where(valid[:, None], got, torch.full_like(got, fill))
        if weight is not None:
            got = got * weight[:, None]
        out = got if out is None else out + got
    return out.reshape(B, C, *out_shape)


def _rotation_matrix(cfg: AugmentConfig, gen, batch: int):
    """(B, d, d) rotation matrices with angles U(-rotation, rotation)."""
    dim = cfg.dim
    dev = gen.device

    def plane(angle, a, b, size):
        m = torch.eye(size, device=dev).repeat(batch, 1, 1)
        c, s = torch.cos(angle), torch.sin(angle)
        m[:, a, a], m[:, a, b], m[:, b, a], m[:, b, b] = c, -s, s, c
        return m

    angles = _uniform(gen, (3, batch), -cfg.rotation, cfg.rotation)
    if dim == 2:
        return plane(angles[0], 0, 1, 2)
    if cfg.do_dummy_2d:
        return plane(angles[0], 1, 2, 3)          # in-plane only (around axis 0)
    rx = plane(angles[0], 1, 2, 3)
    ry = plane(-angles[1], 0, 2, 3)               # [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    rz = plane(angles[2], 0, 1, 3)
    return rz @ ry @ rx


def _spatial_matrix(cfg: AugmentConfig, gen, batch: int):
    """(B, d, d) output-coordinate -> input-coordinate matrices: rotate, then
    scale (zoom out for a scale above 1)."""
    dim = cfg.dim
    rot = _rotation_matrix(cfg, gen, batch)
    eye = torch.eye(dim, device=gen.device).expand(batch, dim, dim)
    rot = _gate(_bernoulli(gen, (batch,), cfg.p_rotation), rot, eye)
    scale = _bg_contrast(gen, (batch,), cfg.scale_range[0], cfg.scale_range[1])
    scale = torch.where(_bernoulli(gen, (batch,), cfg.p_scaling), scale,
                        torch.ones_like(scale))
    scale_vec = scale[:, None].repeat(1, dim)
    if cfg.do_dummy_2d:
        scale_vec[:, 0] = 1.0
    return rot * scale_vec[:, None, :]


def _spatial_transform(cfg: AugmentConfig, gen, data, seg):
    """Rotation + scale crop from the initial to the final patch size: data
    (B, C, *ips) linear with fill 0, seg (B, S, *ips) or None nearest with
    fill -1, or for a translation target linear with fill 0 (returned as
    float32)."""
    matrix = _spatial_matrix(cfg, gen, data.shape[0])
    out = _affine_sample(data, matrix, cfg.initial_patch_size, cfg.patch_size,
                         order=1, fill=0.0)
    seg_out = None
    if seg is not None:
        translation = cfg.target_type == "translation"
        seg_out = _affine_sample(seg.float(), matrix, cfg.initial_patch_size,
                                 cfg.patch_size, order=1 if translation else 0,
                                 fill=0.0 if translation else -1.0)
    return out, seg_out


# --------------------------------------------------------------------- intensity
def _gaussian_kernel1d(sigma, radius: int):
    """sigma (...) -> normalised kernels (..., 2*radius+1)."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=sigma.device)
    k = torch.exp(-0.5 * (x / torch.clamp(sigma[..., None], min=1e-8)) ** 2)
    return k / k.sum(-1, keepdim=True)


def _blur_axis(x, kernel, axis: int):
    """x (B, C, *spatial), kernel (B, C, taps): correlation along the spatial
    ``axis`` with edge padding."""
    radius = kernel.shape[-1] // 2
    ax = axis + 2
    n = x.shape[ax]
    idx = torch.arange(-radius, n + radius, device=x.device).clamp(0, n - 1)
    padded = x.index_select(ax, idx)
    out = torch.zeros_like(x)
    for i in range(2 * radius + 1):
        w = kernel[:, :, i].reshape(kernel.shape[:2] + (1,) * (x.dim() - 2))
        out = out + padded.narrow(ax, i, n) * w
    return out


def _blur(data, sigma):
    """sigma (B, C, dim): one Gaussian per sample, channel and axis, radius 3."""
    for ax in range(data.dim() - 2):
        data = _blur_axis(data, _gaussian_kernel1d(sigma[:, :, ax], radius=3), ax)
    return data


def _gaussian_blur(gen, data, p_channel=0.5, sigma_range=(0.5, 1.0)):
    B, C = data.shape[:2]
    apply = _bernoulli(gen, (B, C), p_channel)
    sigma = _uniform(gen, (B, C, data.dim() - 2), *sigma_range)
    return _gate(apply, _blur(data, sigma), data)


def _lowres(data, scale, ignore_axes: Tuple[int, ...] = ()):
    """Nearest downsample by ``scale`` (B, C) and linear upsample back, with
    static shapes; the axes share one scale."""
    B, C = data.shape[:2]
    low = data
    for ax in range(data.dim() - 2):
        if ax in ignore_axes:
            continue
        n = data.shape[ax + 2]
        m = torch.clamp(torch.round(n * scale), min=1.0)[..., None]     # (B, C, 1)
        i = torch.arange(n, dtype=torch.float32, device=data.device)
        v = (i + 0.5) * m / n - 0.5                                      # (B, C, n)
        j0 = torch.minimum(torch.clamp(torch.floor(v), min=0), m - 1)
        j1 = torch.minimum(j0 + 1, m - 1)
        w = torch.clamp(v - j0, 0.0, 1.0)
        src0 = torch.clamp(torch.floor((j0 + 0.5) * n / m), 0, n - 1).long()
        src1 = torch.clamp(torch.floor((j1 + 0.5) * n / m), 0, n - 1).long()
        shape = [B, C] + [1] * (data.dim() - 2)
        shape[ax + 2] = n
        expand = list(low.shape)
        g0 = torch.gather(low, ax + 2, src0.reshape(shape).expand(expand))
        g1 = torch.gather(low, ax + 2, src1.reshape(shape).expand(expand))
        w = w.reshape(shape)
        low = g0 * (1 - w) + g1 * w
    return low


def _simulate_lowres(gen, data, ignore_axes: Tuple[int, ...], p_channel=0.5,
                     scale_range=(0.5, 1.0)):
    B, C = data.shape[:2]
    apply = _bernoulli(gen, (B, C), p_channel)
    scale = _uniform(gen, (B, C), *scale_range)
    return _gate(apply, _lowres(data, scale, ignore_axes), data)


def _spatial_stat(x, fn):
    return fn(x.flatten(2), 2).reshape(x.shape[:2] + (1,) * (x.dim() - 2))


def _gamma_apply(data, g, invert: bool):
    """Gamma g (B, C) per sample and channel, keeping each channel's mean and
    (population) standard deviation."""
    x = -data if invert else data
    g = g.reshape(g.shape + (1,) * (data.dim() - 2))
    mean = _spatial_stat(x, torch.mean)
    std = _spatial_stat(x, lambda t, d: t.std(d, unbiased=False))
    mn = _spatial_stat(x, torch.amin)
    rng = _spatial_stat(x, torch.amax) - mn
    y = torch.pow((x - mn) / torch.clamp(rng, min=1e-7), g) * rng + mn
    y_std = _spatial_stat(y, lambda t, d: t.std(d, unbiased=False))
    y = (y - _spatial_stat(y, torch.mean)) / torch.clamp(y_std, min=1e-8) * std + mean
    return -y if invert else y


def _gamma(gen, data, invert: bool, gamma_range=(0.7, 1.5)):
    return _gamma_apply(data, _bg_contrast(gen, data.shape[:2], *gamma_range), invert)


def _contrast_apply(data, factor):
    """Stretch around each channel's mean by ``factor`` (B, C), clipped to the
    channel's range."""
    factor = factor.reshape(factor.shape + (1,) * (data.dim() - 2))
    mean = _spatial_stat(data, torch.mean)
    stretched = (data - mean) * factor + mean
    return torch.maximum(torch.minimum(stretched, _spatial_stat(data, torch.amax)),
                         _spatial_stat(data, torch.amin))


def _intensity_chain(cfg: AugmentConfig, gen, data):
    B, C = data.shape[:2]
    bshape = (B,) + (1,) * (data.dim() - 1)
    ignore_axes = (0,) if (cfg.do_dummy_2d and cfg.dim == 3) else ()

    # Gaussian noise (one variance per sample, U(0, 0.1))
    variance = _uniform(gen, bshape, 0.0, 0.1)
    noise = torch.randn(data.shape, generator=gen, device=data.device) * variance.sqrt()
    data = _gate(_bernoulli(gen, (B,), 0.1), data + noise, data)

    data = _gate(_bernoulli(gen, (B,), 0.2), _gaussian_blur(gen, data), data)

    # multiplicative brightness, per channel
    mult = _bg_contrast(gen, (B, C), 0.75, 1.25)
    mult = mult.reshape((B, C) + (1,) * (data.dim() - 2))
    data = _gate(_bernoulli(gen, (B,), 0.15), data * mult, data)

    # contrast (preserve range), per channel
    contrasted = _contrast_apply(data, _bg_contrast(gen, (B, C), 0.75, 1.25))
    data = _gate(_bernoulli(gen, (B,), 0.15), contrasted, data)

    data = _gate(_bernoulli(gen, (B,), 0.25),
                 _simulate_lowres(gen, data, ignore_axes), data)

    # gamma, inverted then plain
    data = _gate(_bernoulli(gen, (B,), 0.1), _gamma(gen, data, invert=True), data)
    data = _gate(_bernoulli(gen, (B,), 0.3), _gamma(gen, data, invert=False), data)
    return data


def _mirror(cfg: AugmentConfig, gen, data, seg):
    for ax in cfg.mirror_axes:
        flip = _bernoulli(gen, (data.shape[0],))
        data = _gate(flip, data.flip(ax + 2), data)
        if seg is not None:
            seg = _gate(flip, seg.flip(ax + 2), seg)
    return data, seg


# --------------------------------------------------------------------- seg targets
def _nearest_downsample(seg, out_shape):
    """Nearest-neighbour downsample of (B, S, *spatial) to (B, S, *out_shape):
    the source index of output j is floor(j * n / m)."""
    out = seg
    for ax, (n, m) in enumerate(zip(seg.shape[2:], out_shape)):
        idx = np.floor(np.arange(m) * n / m).astype(np.int64)
        out = out.index_select(ax + 2, torch.as_tensor(idx, device=seg.device))
    return out


def convert_seg_to_regions(seg, regions, ignore_label=None):
    """(B, 1, *spatial) label map -> (B, num_regions, *spatial) binary masks."""
    masks = []
    for region in regions:
        if isinstance(region, (tuple, list)):
            m = torch.zeros_like(seg[:, 0], dtype=torch.bool)
            for r in region:
                m = m | (seg[:, 0] == r)
        else:
            m = seg[:, 0] == region
        masks.append(m)
    return torch.stack(masks, dim=1).to(seg.dtype)


@lru_cache(maxsize=None)
def linear_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of ``jax.image.resize(...,
    "linear")`` along one axis: a triangle kernel, widened by 1/scale when
    shrinking (antialiasing, JAX's default), normalised per output sample,
    zero for a sample outside the input (the scale-and-translate form)."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale \
        - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) \
        / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def linear_resize(x, out_shape):
    """Antialiased linear resize of (B, C, *spatial) to (B, C, *out_shape),
    as ``jax.image.resize(..., "linear")``: one small matmul per axis whose
    size changes."""
    for ax, (n, m) in enumerate(zip(x.shape[2:], out_shape)):
        if n == m:
            continue
        w = torch.as_tensor(linear_resize_weights(n, m), device=x.device)
        x = torch.tensordot(x, w.to(x.dtype), dims=([ax + 2], [0])).movedim(-1, ax + 2)
    return x


def make_seg_targets(cfg: AugmentConfig, seg):
    """RemoveLabel(-1 -> 0), region conversion, deep-supervision downsampling:
    one (B, S', *scaled patch) target per scale. A translation target skips
    the label transforms and is resized linearly."""
    translation = cfg.target_type == "translation"
    if translation:
        seg = seg.float()
    else:
        seg = torch.where(seg == -1, torch.zeros_like(seg), seg)
        if cfg.regions is not None:
            seg = convert_seg_to_regions(seg, cfg.regions, None)
    if cfg.deep_supervision_scales is None:
        return [seg]
    targets = []
    for scale in cfg.deep_supervision_scales:
        if all(s == 1 for s in scale):
            targets.append(seg)
        else:
            out_shape = [int(round(n * s)) for n, s in zip(cfg.patch_size, scale)]
            targets.append(linear_resize(seg, out_shape) if translation
                           else _nearest_downsample(seg, out_shape))
    return targets


# --------------------------------------------------------------------- cascade
def _cascade_move(cfg: AugmentConfig, data, seg, gen=None):
    """Move the previous stage's segmentation (seg channel 1) into the data as
    one one-hot channel per foreground label, leaving seg channel 0 as the
    target; with a generator (the training path) noise the one-hot channels
    first."""
    if not cfg.is_cascaded or seg is None:
        return data, seg
    prev = seg[:, 1]
    onehot = torch.stack([prev == label for label in cfg.foreground_labels],
                         dim=1).to(data.dtype)
    if gen is not None:
        onehot = cascade_onehot_noise(cfg, gen, onehot)
    return torch.cat([data, onehot], dim=1), seg[:, 0:1]


@lru_cache(maxsize=None)
def _ball_distances(radius_max: int, dim: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(
        *([np.arange(-radius_max, radius_max + 1)] * dim), indexing="ij"))
    return np.sqrt((coords.astype(np.float64) ** 2).sum(0)).astype(np.float32)


def ball_mask(radius, radius_max: int, dim: int):
    """radius (N,) -> (N, (2*radius_max+1)^dim) 0/1 float32 ball footprints,
    a voxel inside where its distance from the centre is at most the
    radius."""
    dist = torch.as_tensor(_ball_distances(radius_max, dim), device=radius.device)
    return (dist <= radius.float().reshape((-1,) + (1,) * dim)).float()


def _binary_conv(x, kernels):
    """SAME correlation of each 0/1 volume of x (N, *spatial) with its own
    0/1 kernel (N, *k): the count of neighbours under the footprint (exact in
    fp32, at most (2*radius_max+1)^dim)."""
    conv = {2: torch.nn.functional.conv2d, 3: torch.nn.functional.conv3d}[x.dim() - 1]
    return conv(x[None], kernels[:, None], padding=kernels.shape[-1] // 2,
                groups=x.shape[0])[0]


def binary_operation_apply(x, op, radius, radius_max: int):
    """One binary morphology per 0/1 volume of x (N, *spatial) with a ball of
    the given radius (N,): op (N,) 0 dilate, 1 erode, 2 close, 3 open. Two
    convolutions for all four: a voxel's count of neighbours under the ball
    gives both its dilation (> 0) and its erosion (= the ball's size); the
    second count, of the dilation (close) or the erosion (open), gives the
    second step."""
    dim = x.dim() - 1
    kernels = ball_mask(radius, radius_max, dim)
    full = kernels.flatten(1).sum(1).reshape((-1,) + (1,) * dim)

    def dilate_erode(v):
        counts = _binary_conv(v, kernels)
        return (counts > 0.5).to(x.dtype), (counts > full - 0.5).to(x.dtype)

    dilated, eroded = dilate_erode(x)
    closing = (op == 2).reshape((-1,) + (1,) * dim)
    then_dilated, then_eroded = dilate_erode(torch.where(closing, dilated, eroded))
    return torch.stack([dilated, eroded, then_eroded, then_dilated], dim=1)[
        torch.arange(x.shape[0], device=x.device), op]


def binary_operations_apply(onehot, perm, op, radius, radius_max: int):
    """The morphology of each sample's one-hot channels (B, F, *spatial) in
    the order perm (B, F); step j applies op[:, j] with radius[:, j] to
    channel perm[:, j]. A channel left empty by the steps before is skipped;
    the voxels a channel gains are cleared from every other channel."""
    rows = torch.arange(onehot.shape[0], device=onehot.device)
    for j in range(onehot.shape[1]):
        channel = perm[:, j]
        workon = onehot[rows, channel]
        res = binary_operation_apply(workon, op[:, j], radius[:, j], radius_max)
        res = _gate(workon.flatten(1).sum(1) > 0, res, workon)
        added = (res - workon > 0).to(onehot.dtype)
        onehot = onehot * (1.0 - added[:, None])
        onehot[rows, channel] = res
    return onehot


def draw_seed_voxels(gen, x):
    """A uniform random foreground voxel (flat index) of each volume of x
    (N, *spatial); any voxel for a volume without foreground."""
    flat = x.flatten(1)
    u = torch.rand(flat.shape, generator=gen, device=gen.device)
    return torch.where(flat > 0, u, torch.full_like(u, -1.0)).argmax(1)


def remove_component_apply(x, seed, max_frac: float = 0.15, check_every: int = 8):
    """Remove from each 0/1 volume of x (N, *spatial) the connected component
    (3^dim neighbourhood) of the voxel at flat index seed (N,) if it covers
    less than ``max_frac`` of the volume. The component grows from the seed
    by 0/1 box dilations (a 3^dim max pool) masked by the volume, for every
    volume at once, until it stops changing: exact, however long its
    geodesic radius. The host looks every ``check_every`` dilations."""
    n = x.shape[0]
    pool = {2: torch.nn.functional.max_pool2d,
            3: torch.nn.functional.max_pool3d}[x.dim() - 1]
    comp = torch.zeros_like(x).flatten(1)
    comp[torch.arange(n, device=x.device), seed] = 1.0
    comp = torch.minimum(comp.reshape(x.shape), x)   # no foreground: stays empty
    while True:
        before = comp
        for _ in range(check_every):
            comp = torch.minimum(pool(comp[:, None], 3, 1, 1)[:, 0], x)
        if torch.equal(comp, before):
            break
    small = comp.flatten(1).sum(1) < max_frac * x[0].numel()
    has_fg = x.flatten(1).sum(1) > 0
    return _gate(has_fg & small, x * (1.0 - comp), x)


def cascade_onehot_noise(cfg: AugmentConfig, gen, onehot):
    """The training path's noise on the previous stage's one-hot channels
    (B, F, *spatial): with p=``p_cascade_binary_op`` a sample, a random
    dilate, erode, close or open with a ball of radius U(1, strel_max) on
    every channel in a random order; then with
    p=``p_cascade_remove_component`` a sample, the removal of the component
    of a random foreground voxel from every channel. The gates, orders,
    operations and radii are drawn first and the seed voxels after the
    morphology, for every sample; the morphology and the removal then run
    only on the samples whose gate is open (the host reads the gates)."""
    B, F = onehot.shape[:2]
    dev = gen.device
    do_op = _bernoulli(gen, (B,), cfg.p_cascade_binary_op)
    perm = torch.rand((B, F), generator=gen, device=dev).argsort(1)
    op = torch.randint(0, 4, (B, F), generator=gen, device=dev)
    radius = _uniform(gen, (B, F), 1.0, float(cfg.cascade_strel_max))
    do_cc = _bernoulli(gen, (B,), cfg.p_cascade_remove_component)

    picked = do_op.nonzero()[:, 0]
    if picked.numel():
        onehot = onehot.clone()
        onehot[picked] = binary_operations_apply(
            onehot[picked], perm[picked], op[picked], radius[picked],
            cfg.cascade_strel_max)
    # the seed voxels come from the channels after the morphology
    seed = draw_seed_voxels(gen, onehot.flatten(0, 1)).reshape(B, F)
    picked = do_cc.nonzero()[:, 0]
    if picked.numel():
        sub = onehot[picked]
        onehot = onehot.clone()
        onehot[picked] = remove_component_apply(
            sub.flatten(0, 1), seed[picked].flatten()).reshape(sub.shape)
    return onehot


# --------------------------------------------------------------------- entry points
def augment_train_batch(cfg: AugmentConfig, gen: torch.Generator, data, seg):
    """data (B, C, *initial_patch), seg (B, S, *initial_patch) int16 (float32
    for a translation target) or None, both on ``gen``'s device. Returns (data
    (B, C (+ F for a cascade), *patch), [seg targets (B, S', *scaled_patch)
    float32] or None)."""
    data = data.float()
    data, seg = _spatial_transform(cfg, gen, data, seg)
    data = _intensity_chain(cfg, gen, data)
    data, seg = _mirror(cfg, gen, data, seg)

    if any(cfg.use_mask_for_norm) and seg is not None:
        inside = seg[:, 0] >= 0
        chans = [torch.where(inside, data[:, c], torch.zeros_like(data[:, c]))
                 if cfg.use_mask_for_norm[c] else data[:, c]
                 for c in range(data.shape[1])]
        data = torch.stack(chans, dim=1)

    data, seg = _cascade_move(cfg, data, seg, gen)
    targets = make_seg_targets(cfg, seg) if seg is not None else None
    return data, targets


def prepare_val_batch(cfg: AugmentConfig, data, seg):
    """Validation: no augmentation, only the cascade move (without noise),
    RemoveLabel, regions and the deep-supervision downsampling."""
    data, seg = _cascade_move(cfg, data.float(), seg)
    return data, make_seg_targets(cfg, seg)
