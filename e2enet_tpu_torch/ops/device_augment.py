"""On-device training augmentation: the port's counterpart of
e2enet_tpu/ops/device_augment.py (make_device_augmenter), the trainer's
`device_augment` mode.

The training pipeline queues raw crops at the enlarged generator patch
(data/pipeline.BatchPipeline(raw=True)); this module augments them where
they land, on the card. It computes the JAX package's chain: spatial
(rotation and scaling as one affine of voxel coordinates, trilinear for
data and nearest for the segmentation, constant 0 outside; a sample that
is neither rotated nor scaled takes the center crop), Gaussian noise,
Gaussian blur (a separable 9-tap kernel, edge-padded), multiplicative
brightness, contrast, inverted gamma then gamma (both keeping the
sample's mean and population std), mirroring, and the deep-supervision
targets as strided slices of the segmentation (not pooled).

The work is split in two:
- `sample_params` draws every random choice of a batch on the host from
  an explicit CPU torch.Generator, with the JAX chain's probabilities and
  ranges. The branches are then known before anything runs, so a sample
  computes only the transforms it drew (the JAX chain computes both sides
  of its lax.cond / jnp.where) and nothing waits on the card.
- `apply` runs the drawn transforms on the tensors' device, batched over
  B. Every per-sample scalar reaches the card as a kernel argument (a
  float32 value held in a Python float), never as a copy from pageable
  memory, which would wait for the steps already queued. The Gaussian
  noise tensor is drawn by the caller on the data's device from its own
  generator and passed in, so a CPU and a CUDA run can be held to each
  other on identical inputs.

Interpolation is jax.scipy.ndimage.map_coordinates' in mode 'constant'
(cval 0): order 1 takes the lower corner by floor and each of the 8
corners contributes only where its own index is in range, the weights'
product and the corners' sum in jax's order; order 0 rounds half away
from zero, so -0.5 goes to -1, out of range. F.grid_sample is not used:
its nearest mode rounds half to even and its normalised grid adds float32
error. The coordinates are computed elementwise (affine_coords), so the
card and the CPU compute the same ones to the bit.

Deviations from the host pipeline (data/augment.py), the JAX module's:
data trilinear (order 1), not cubic; segmentation nearest, not per-label
linear and threshold; a fixed-radius blur (radius 4, sigma in [0.5, 1]).
The JAX docstring also lists a linear low-resolution simulation that its
chain does not run; the port runs none either.
"""
import dataclasses
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

ROT_RANGE = (-np.pi / 6, np.pi / 6)
SCALE_RANGE = (0.7, 1.4)
GAMMA_RANGE = (0.7, 1.5)
BLUR_RADIUS = 4


@dataclasses.dataclass
class DeviceAugParams:
    """One batch's draws: arrays over the batch (B,) or over the batch and
    the channels (B, C), float32 values and bool switches, and the network
    patch they produce."""
    patch: Tuple[int, int, int]
    angles: np.ndarray        # (B, 3) about axes 0, 1, 2; 0 where not rotated
    scale: np.ndarray         # (B,) 1 where not scaled
    warp: np.ndarray          # (B,) rotated or scaled (else center crop)
    noise: np.ndarray         # (B,)
    noise_var: np.ndarray     # (B,)
    blur: np.ndarray          # (B, C) the sample blurred and the channel drawn
    blur_sigma: np.ndarray    # (B,)
    bright: np.ndarray        # (B,)
    bright_mult: np.ndarray   # (B, C)
    contrast: np.ndarray      # (B,)
    contrast_factor: np.ndarray  # (B,)
    gamma_inv: np.ndarray     # (B,) the inverted gamma
    gamma_inv_g: np.ndarray   # (B,)
    gamma: np.ndarray         # (B,)
    gamma_g: np.ndarray       # (B,)
    flips: np.ndarray         # (B, 3) per spatial axis


def _uniform(gen, shape, lo, hi) -> np.ndarray:
    """float32 draws of U(lo, hi)."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32).numpy()
    lo, hi = np.float32(lo), np.float32(hi)
    return lo + u * (hi - lo)


def _gamma_exponents(gen, batch, gamma_range) -> np.ndarray:
    """The gamma per sample: below 1 or above it with p 0.5 each."""
    low = _uniform(gen, (batch,), gamma_range[0], 1.0)
    high = _uniform(gen, (batch,), 1.0, gamma_range[1])
    return np.where(_uniform(gen, (batch,), 0, 1) < 0.5, low, high)


def sample_params(generator: torch.Generator, batch: int, channels: int,
                  patch: Sequence[int], rot_range=ROT_RANGE,
                  scale_range=SCALE_RANGE, p_rot=0.2, p_scale=0.2,
                  do_rotation=True, do_scaling=True, do_mirror=True,
                  mirror_axes=(0, 1, 2), do_gamma=True,
                  gamma_range=GAMMA_RANGE, p_gamma=0.3) -> DeviceAugParams:
    """Every random choice of the JAX chain's aug_one
    (e2enet_tpu/ops/device_augment.py:135-214) for `batch` samples of
    `channels` channels, from `generator` (a CPU torch.Generator): the
    rotation (angles U(rot_range) about each axis) at p_rot, the scale
    (zoom in U(scale_range[0], 1) or out U(1, scale_range[1]), p 0.5
    each) at p_scale, noise (variance U(0, 0.1)) at p 0.1, blur (p 0.2
    per sample, 0.5 per channel, sigma U(0.5, 1)), brightness (U(0.75,
    1.25) per channel) at p 0.15, contrast (U(0.75, 1.25)) at p 0.15,
    the inverted gamma at p 0.1, the gamma at p_gamma (with do_gamma),
    each gamma below or above 1 at p 0.5, a flip per axis of mirror_axes
    at p 0.5 (with do_mirror)."""
    B, C = int(batch), int(channels)

    def coin(p, shape=(B,)):
        return _uniform(generator, shape, 0, 1) < np.float32(p)

    angles = _uniform(generator, (B, 3), rot_range[0], rot_range[1])
    rot = coin(p_rot) & bool(do_rotation)
    zoom_in = coin(0.5)
    scale = np.where(zoom_in, _uniform(generator, (B,), scale_range[0], 1.0),
                     _uniform(generator, (B,), 1.0, scale_range[1]))
    sc = coin(p_scale) & bool(do_scaling)
    noise_var = _uniform(generator, (B,), 0, 0.1)
    noise = coin(0.1)
    blur_sigma = _uniform(generator, (B,), 0.5, 1.0)
    blur = coin(0.2)[:, None] & coin(0.5, (B, C))
    bright_mult = _uniform(generator, (B, C), 0.75, 1.25)
    bright = coin(0.15)
    contrast_factor = _uniform(generator, (B,), 0.75, 1.25)
    contrast = coin(0.15)
    gamma_inv_g = _gamma_exponents(generator, B, gamma_range)
    gamma_inv = coin(0.1)
    gamma_g = _gamma_exponents(generator, B, gamma_range)
    gamma = coin(p_gamma) & bool(do_gamma)
    axes = np.zeros(3, bool)
    if do_mirror:
        axes[list(mirror_axes)] = True
    flips = coin(0.5, (B, 3)) & axes
    return DeviceAugParams(
        patch=tuple(int(p) for p in patch),
        angles=np.where(rot[:, None], angles, np.float32(0)),
        scale=np.where(sc, scale, np.float32(1)), warp=rot | sc,
        noise=noise, noise_var=noise_var, blur=blur, blur_sigma=blur_sigma,
        bright=bright, bright_mult=bright_mult, contrast=contrast,
        contrast_factor=contrast_factor, gamma_inv=gamma_inv,
        gamma_inv_g=gamma_inv_g, gamma=gamma, gamma_g=gamma_g, flips=flips)


def rot_matrix(ax, ay, az) -> np.ndarray:
    """Rx @ Ry @ Rz in float32 (JAX _rot_matrix, :37-51)."""
    cx, sx = np.cos(np.float32(ax)), np.sin(np.float32(ax))
    cy, sy = np.cos(np.float32(ay)), np.sin(np.float32(ay))
    cz, sz = np.cos(np.float32(az)), np.sin(np.float32(az))
    one, zero = np.float32(1), np.float32(0)
    rx = np.array([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    ry = np.array([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    rz = np.array([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    return rx @ ry @ rz


def affine(angles, scale, patch, in_patch) -> Tuple[np.ndarray, np.ndarray]:
    """(M, offset) in float32 taking an output voxel of `patch` to its
    source in `in_patch`: M = rotation * scale, offset = center_in - M @
    center_out, the centers at (shape - 1) / 2 (JAX _sample_affine,
    :54-75)."""
    m = rot_matrix(*angles) * np.float32(scale)
    center_in = (np.asarray(in_patch, np.float32) - 1) / 2
    center_out = (np.asarray(patch, np.float32) - 1) / 2
    return m, center_in - m @ center_out


def affine_coords(m, offset, patch, device="cpu") -> torch.Tensor:
    """(3, *patch) float32 source coordinates M @ grid + offset in voxel
    units (JAX _affine_coords, :77-82), each as XLA's float32 dot forms it
    on the CPU: m0 g0, then m1 g1 and m2 g2 each by a fused multiply-add,
    then + offset. The fused multiply-add is taken in float64, where the
    product of two float32 values and its sum with a float32 value of
    these magnitudes are exact, and rounded once to float32."""
    g = [torch.arange(p, dtype=torch.float32, device=device).reshape(
        [-1 if a == i else 1 for a in range(3)]) for i, p in enumerate(patch)]
    out = []
    for i in range(3):
        acc = g[0] * float(m[i, 0])
        for j in (1, 2):
            acc = (g[j].double() * float(m[i, j]) + acc.double()).float()
        out.append(acc + float(offset[i]))
    return torch.stack(out)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest integer, halves away from zero (lax.round;
    torch.round takes halves to even)."""
    t = torch.trunc(x)
    return torch.where((x - t).abs() == 0.5, t + torch.sign(x),
                       torch.round(x))


def resample(vol: torch.Tensor, src: torch.Tensor, order: int
             ) -> torch.Tensor:
    """vol (C, *in) sampled at src (3, *out): (C, *out) in vol's dtype, 0
    outside, as jax.scipy.ndimage.map_coordinates(mode='constant') samples
    each channel (JAX _resample, :85-88)."""
    C, shape = vol.shape[0], vol.shape[1:]
    flat = vol.reshape(C, -1)
    if order == 0:
        idx = round_half_away(src).long()
        nodes = [[(idx[a], None)] for a in range(3)]
    elif order == 1:
        lower = torch.floor(src)
        upper_w = src - lower
        idx = lower.long()
        nodes = [[(idx[a], 1 - upper_w[a]), (idx[a] + 1, upper_w[a])]
                 for a in range(3)]
    else:
        raise ValueError(f"order {order}: 0 or 1")
    # per axis and node: the index clamped into range, whether it was in
    # range, its weight
    nodes = [[(i.clamp(0, size - 1), (i >= 0) & (i < size), w)
              for i, w in axis] for axis, size in zip(nodes, shape)]
    out = None
    for (i0, v0, w0), (i1, v1, w1), (i2, v2, w2) in itertools.product(
            *nodes):
        lin = (i0 * shape[1] + i1) * shape[2] + i2
        got = flat[:, lin.reshape(-1)].reshape(C, *src.shape[1:])
        term = torch.where(v0 & v1 & v2, got, 0)
        if order == 1:
            term = w0 * w1 * w2 * term
        out = term if out is None else out + term
    return out


def center_crop(x: torch.Tensor, patch) -> torch.Tensor:
    """The center crop of x's last three axes at lo = (s - p) // 2 (JAX
    _center_crop, :91-94)."""
    for a, p in enumerate(patch):
        axis = x.dim() - 3 + a
        x = x.narrow(axis, (x.shape[axis] - p) // 2, p)
    return x


def gaussian_taps(sigma):
    """The normalised float32 taps exp(-x^2 / (2 sigma^2)), x in
    [-BLUR_RADIUS, BLUR_RADIUS], as Python floats (each a float32
    value)."""
    xs = torch.arange(-BLUR_RADIUS, BLUR_RADIUS + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (xs / float(np.float32(sigma))) ** 2)
    return (k / k.sum()).tolist()


def separable_blur(img: torch.Tensor, sigma) -> torch.Tensor:
    """A Gaussian blur of img's last three axes: one edge-padded 1D pass
    of gaussian_taps along each, axes 0, 1, 2 in turn, the taps summed in
    order (JAX _separable_blur, :97-115)."""
    k = gaussian_taps(sigma)
    for a in range(3):
        axis = img.dim() - 3 + a
        n = img.shape[axis]
        edge = [img.narrow(axis, 0, 1)] * BLUR_RADIUS
        far = [img.narrow(axis, n - 1, 1)] * BLUR_RADIUS
        padded = torch.cat(edge + [img] + far, dim=axis)
        acc = torch.zeros_like(img)
        for i, w in enumerate(k):
            acc = acc + w * padded.narrow(axis, i, n)
        img = acc
    return img


def _contrast(d: torch.Tensor, factor) -> torch.Tensor:
    """(d - mean) * factor + mean, clipped to [min, max], each statistic
    per channel over the spatial axes (JAX :179-185)."""
    dims = (-3, -2, -1)
    mean = d.mean(dims, keepdim=True)
    out = (d - mean) * float(factor) + mean
    return torch.minimum(torch.maximum(out, d.amin(dims, keepdim=True)),
                         d.amax(dims, keepdim=True))


def _gamma(d: torch.Tensor, g, invert: bool) -> torch.Tensor:
    """The gamma transform keeping the mean and the population std, all
    taken over the whole sample (JAX gamma, :191-202)."""
    x = -d if invert else d
    mn, sd = x.mean(), x.std(correction=0)
    minm = x.amin()
    rnge = x.amax() - minm
    x = torch.pow((x - minm) / (rnge + 1e-7), float(g)) * rnge + minm
    x = (x - x.mean()) / (x.std(correction=0) + 1e-8) * sd + mn
    return -x if invert else x


def apply(params: DeviceAugParams, data: torch.Tensor, seg: torch.Tensor,
          noise: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The drawn transforms on data (B, C, *in_patch) float32 and seg (B,
    *in_patch) (float or integer labels) on their device: (data (B, C,
    *patch) float32, seg (B, *patch) in seg's dtype). noise: (B, C,
    *patch) standard normal draws on data's device, needed where a sample
    drew noise (each such sample adds noise[b] * sqrt(variance))."""
    B, C = data.shape[:2]
    in_patch, patch = tuple(data.shape[2:]), params.patch
    if params.noise.any() and noise is None:
        raise ValueError("a sample drew noise: pass noise (B, C, *patch)")
    out_d = torch.empty((B, C) + patch, dtype=torch.float32,
                        device=data.device)
    out_s = torch.empty((B,) + patch, dtype=seg.dtype, device=seg.device)
    for b in range(B):
        if params.warp[b]:
            m, offset = affine(params.angles[b], params.scale[b], patch,
                               in_patch)
            src = affine_coords(m, offset, patch, data.device)
            d = resample(data[b], src, 1)
            s = resample(seg[b][None], src, 0)[0]
        else:
            d, s = center_crop(data[b], patch), center_crop(seg[b], patch)
        if params.noise[b]:
            d = d + noise[b] * float(np.sqrt(params.noise_var[b]))
        if params.blur[b].any():
            d = torch.stack([
                separable_blur(d[c], params.blur_sigma[b])
                if params.blur[b, c] else d[c] for c in range(C)])
        if params.bright[b]:
            d = torch.stack([d[c] * float(params.bright_mult[b, c])
                             for c in range(C)])
        if params.contrast[b]:
            d = _contrast(d, params.contrast_factor[b])
        if params.gamma_inv[b]:
            d = _gamma(d, params.gamma_inv_g[b], True)
        if params.gamma[b]:
            d = _gamma(d, params.gamma_g[b], False)
        axes = [a for a in range(3) if params.flips[b, a]]
        if axes:
            d = torch.flip(d, [1 + a for a in axes])
            s = torch.flip(s, axes)
        out_d[b] = d
        out_s[b] = s
    return out_d, out_s


def ds_targets(seg: torch.Tensor, ds_scales) -> Tuple[torch.Tensor, ...]:
    """One int64 target per deep-supervision scale: seg (B, *patch) with
    negative labels 0, sliced [::f0, ::f1, ::f2] at the strides f =
    round(1 / scale) (JAX augment, :224-226), not pooled."""
    s = torch.clamp(seg, min=0).long()
    factors = [[int(round(1.0 / x)) for x in sc] for sc in ds_scales]
    return tuple(s[:, ::f[0], ::f[1], ::f[2]].contiguous() for f in factors)


def make_device_augmenter(patch: Tuple[int, int, int],
                          in_patch: Tuple[int, int, int],
                          num_classes: int,
                          ds_scales: Sequence[Sequence[float]],
                          rot_range=ROT_RANGE, scale_range=SCALE_RANGE,
                          p_rot=0.2, p_scale=0.2,
                          do_rotation=True, do_scaling=True,
                          do_mirror=True, mirror_axes=(0, 1, 2),
                          do_gamma=True, gamma_range=GAMMA_RANGE,
                          p_gamma=0.3):
    """The JAX make_device_augmenter's arguments and defaults (num_classes
    unused there too). Returns fn(generator, noise_generator, data (B, C,
    *in_patch) float32, seg (B, *in_patch)) -> (data (B, *patch, C)
    float32, channels-last as the train step takes it, targets
    (ds_targets)): the params drawn from `generator` (CPU), the noise from
    `noise_generator` (on data's device) when a sample drew noise, then
    `apply`. ds_scales None (no deep supervision) raises TypeError, as the
    JAX function does."""
    patch = tuple(int(p) for p in patch)
    in_patch = tuple(int(p) for p in in_patch)
    ds_scales = [list(sc) for sc in ds_scales]
    draw = dict(rot_range=rot_range, scale_range=scale_range, p_rot=p_rot,
                p_scale=p_scale, do_rotation=do_rotation,
                do_scaling=do_scaling, do_mirror=do_mirror,
                mirror_axes=mirror_axes, do_gamma=do_gamma,
                gamma_range=gamma_range, p_gamma=p_gamma)

    def augment(generator, noise_generator, data, seg):
        if tuple(data.shape[2:]) != in_patch:
            raise ValueError(f"data {tuple(data.shape)}: (B, C, *{in_patch})"
                             f" expected")
        B, C = data.shape[:2]
        params = sample_params(generator, B, C, patch, **draw)
        noise = None
        if params.noise.any():
            noise = torch.randn((B, C) + patch, generator=noise_generator,
                                device=data.device)
        d, s = apply(params, data, seg, noise)
        return d.movedim(1, -1).contiguous(), ds_targets(s, ds_scales)

    return augment
