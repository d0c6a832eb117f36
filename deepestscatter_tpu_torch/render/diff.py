"""Differentiable rendering: images and their gradients with respect to the
density voxels, the sun direction, the camera and the light, with the
in-scatter bake's forward on K3 and kernels of their own: K8a, the bake's
adjoint, and K8b, the quadrature march and its adjoint (also the per-point
sun march; ``csrc/diff.cu``); K8c, the path tracer's adjoint
(``csrc/path_adjoint.cu``).

The port of ``deepestscatter_tpu.render.diff``.  Multiple scattering
(``render_multi_scatter_mc``, ``multi_scatter_and_grads``) is the path
tracer's estimator with its seeds, differentiated: K4 traces every
subframe's paths in one launch and K8c replays them for their adjoint
(the plain version: autograd through ``pathtracer.scatter_loop_plain``).
Single scattering is a deterministic quadrature of the single-scattering
integral along each camera ray,

    L(ray) = sum_k T_view(k) (1 - exp(-sigma_k step)) t_sun(x_k) p(theta) r,

the in-scatter ``t_sun`` read from a differentiably baked grid (the
renderer's semantics, ``bake_inscatter_diff``) or marched toward the sun
from each point (``sun_transmittance``), each evaluated at the segment's
free-flight mean point.

On CUDA tensors the wrappers (``render_single_scatter``,
``render_and_grads``, ``bake_inscatter_diff``, ``sun_transmittance``,
``render_multi_scatter_mc``, ``multi_scatter_and_grads``) run the kernels,
each bound to autograd by a ``torch.autograd.Function`` whose backward is
a kernel too; on CPU tensors they run the plain PyTorch versions on
autograd (``*_plain``, ``path_records_plain``), which rematerialize each
chunk of ``remat_chunk`` march steps, each bake step and each chunk of the
path tracer's lockstep iterations under ``torch.utils.checkpoint`` as the
JAX package does under ``jax.checkpoint``.  The kernels store no march
state and ignore ``remat_chunk``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import cuda_build
from ..config import SceneConfig, fov_tan_halves
from ..device import check_on, resolve_device
from ..ops import grid as grid_ops
from ..ops import march as march_ops
from ..ops import phase as phase_ops
from ..scene import SceneParams, SceneStatic, build_scene
from . import camera as camera_ops
from . import inscatter
from . import pathtracer as pt_ops


class DiffScene(NamedTuple):
    """Differentiable scene inputs (the leaves gradients address)."""

    density: torch.Tensor  # [Z, Y, X] raw density in [0, 1]
    sun_dir: torch.Tensor  # [3] direction FROM the sun (not normalized)
    eye: torch.Tensor  # [3] camera position
    look_at: torch.Tensor  # [3]
    light_radiance: torch.Tensor  # [3]


def diff_scene_from_numpy(density, sun_dir, eye, look_at, light_radiance,
                          device="cuda") -> DiffScene:
    """A ``DiffScene`` of float32 copies of numpy arrays (the JAX
    ``DiffScene``'s leaves) on ``device``."""
    dev = resolve_device(device)
    return DiffScene(*(
        torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
        for a in (density, sun_dir, eye, look_at, light_radiance)
    ))


def _bbox_host(shape) -> Tuple[float, float, float]:
    return tuple(float(v) for v in grid_ops.bbox_size_from_shape(tuple(shape)))


def _bbox(density: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_bbox_host(density.shape), dtype=torch.float32, device=density.device)


@functools.lru_cache(maxsize=None)
def _phase(device: str) -> phase_ops.PhaseTable:
    return phase_ops.load_phase_table(device)


def _mie(device: str) -> torch.Tensor:
    return _phase(device).mie


def _remat(fn, *args):
    """``fn(*args)``, rematerialized in the backward pass where a gradient
    is being recorded."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _step_distance(step: float, i: int) -> float:
    """float32 ``step * i``, as the kernels and the JAX package form it."""
    return float(np.float32(step) * np.float32(i))


def sample_density(density: torch.Tensor, bbox: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Trilinear density at local coordinates in [0, bbox] (zero outside
    the box)."""
    u = pos / bbox
    inside = ((u >= 0.0) & (u <= 1.0)).all(dim=-1)
    return torch.where(inside, grid_ops.sample_trilinear(density, u), 0.0)


def camera_rays(eye: torch.Tensor, look_at: torch.Tensor, width: int, height: int,
                hfov_deg: float = 30.0, up=(0.0, 1.0, 0.0)):
    """Differentiable pinhole ray bundle → (origins [N, 3], dirs [N, 3])."""
    up = torch.tensor(up, dtype=torch.float32, device=eye.device)
    w = look_at - eye
    wlen = torch.linalg.norm(w)
    u = torch.linalg.cross(w, up)
    u = u / torch.linalg.norm(u)
    v = torch.linalg.cross(u, w)
    v = v / torch.linalg.norm(v)
    tan_h, tan_v = fov_tan_halves(hfov_deg, width, height)
    u = u * wlen * tan_h
    v = v * wlen * tan_v
    xs = grid_ops.true_div(torch.arange(width, dtype=torch.float32, device=eye.device),
                           float(width)) * 2.0 - 1.0
    ys = grid_ops.true_div(torch.arange(height, dtype=torch.float32, device=eye.device),
                           float(height)) * 2.0 - 1.0
    dy, dx = torch.meshgrid(ys, xs, indexing="ij")
    d = dx[..., None] * u + dy[..., None] * v + w
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = eye.expand(d.shape)
    return o.reshape(-1, 3), d.reshape(-1, 3)


# ---------------------------------------------------------------------------
# The sun march (diff.py:64-88): plain version, kernel, wrapper.
# ---------------------------------------------------------------------------


def _to_sun(sun_dir: torch.Tensor) -> torch.Tensor:
    return -sun_dir / torch.linalg.norm(sun_dir)


def _sun_march_plain(density, to_sun, pos, density_multiplier, n_steps, sample_step):
    """exp(-tau) toward ``to_sun`` from ``pos`` [..., 3]: every step's
    sample at once, tau summed in step order."""
    bbox = _bbox(density)
    step = _f32(sample_step)
    s = torch.tensor([_step_distance(step, i + 1) for i in range(n_steps)],
                     dtype=torch.float32, device=pos.device)
    p = pos[..., None, :] + to_sun * s[:, None]
    sigma = sample_density(density, bbox, p) * density_multiplier
    tau = torch.zeros(pos.shape[:-1], dtype=torch.float32, device=pos.device)
    for j in range(n_steps):
        tau = tau + sigma[..., j] * step
    return torch.exp(-tau)


def sun_transmittance_plain(density, sun_dir, pos, density_multiplier: float, n_steps: int,
                            sample_step: float = 1.0 / 256.0) -> torch.Tensor:
    """Plain version of the sun march: Beer-Lambert transmittance from
    ``pos`` [..., 3] toward the sun, rematerialized in the backward pass."""
    return _remat(
        lambda d, sd, p: _sun_march_plain(d, _to_sun(sd), p, density_multiplier, n_steps,
                                          sample_step),
        density, sun_dir, pos)


_SUN_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
]
_SUN_BWD_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def _check_grid(density: torch.Tensor) -> None:
    if density.dtype != torch.float32 or density.dim() != 3 or not density.is_contiguous():
        raise ValueError("density must be a contiguous float32 [Z, Y, X] grid")
    if density.numel() >= 2**31:
        raise ValueError("the diff kernels take fewer than 2^31 voxels")


def _check_vec(name: str, t: Optional[torch.Tensor], n: int) -> None:
    if t is not None and (t.dtype != torch.float32 or not t.is_contiguous()
                          or t.numel() != n):
        raise ValueError(f"{name} must be a contiguous float32 tensor of {n} values")


def _grid_consts(density, sample_step, density_multiplier, *extra):
    return (ctypes.c_float * (5 + len(extra)))(
        *_bbox_host(density.shape), sample_step, density_multiplier, *extra)


def launch_sun_march(density, to_sun, pos, density_multiplier, n_steps, sample_step,
                     steps: Optional[torch.Tensor] = None, lib=None) -> torch.Tensor:
    """The sun march's kernel (``ds_sun_march``) from ``pos`` [N, 3] → T [N].
    ``steps``: None, or an int32 [N] the kernel fills with each point's
    samples in the box."""
    _check_grid(density)
    cuda_build.require_vec3(pos=pos)
    _check_vec("to_sun", to_sun, 3)
    if steps is not None and (steps.dtype != torch.int32 or steps.shape != pos.shape[:1]):
        raise ValueError("steps must be an int32 [N] tensor")
    fn = (lib or cuda_build.load("diff")).ds_sun_march
    fn.argtypes = _SUN_ARGTYPES
    fn.restype = ctypes.c_int
    nz, ny, nx = density.shape
    out = torch.empty(pos.shape[0], dtype=torch.float32, device=pos.device)
    cuda_build.check(
        fn(cuda_build.ptr(density), cuda_build.ptr(to_sun), nx, ny, nz,
           _grid_consts(density, sample_step, density_multiplier), n_steps,
           cuda_build.ptr(pos), pos.shape[0], cuda_build.ptr(out), cuda_build.ptr(steps),
           cuda_build.stream_handle()),
        "sun march kernel",
    )
    launch_sun_march.launches += 1
    return out


#: Kernel launches so far (counted where the kernel is launched, nowhere
#: else); likewise every ``launch_*`` of this module.
launch_sun_march.launches = 0


def launch_sun_march_bwd(density, to_sun, pos, trans, g_trans, density_multiplier, n_steps,
                         sample_step, lib=None):
    """The sun march's adjoint (``ds_sun_march_bwd``) → (d density, d pos
    [N, 3], d to_sun [3])."""
    _check_grid(density)
    cuda_build.require_vec3(pos=pos)
    n = pos.shape[0]
    _check_vec("to_sun", to_sun, 3)
    _check_vec("trans", trans, n)
    _check_vec("g_trans", g_trans, n)
    fn = (lib or cuda_build.load("diff")).ds_sun_march_bwd
    fn.argtypes = _SUN_BWD_ARGTYPES
    fn.restype = ctypes.c_int
    nz, ny, nx = density.shape
    d_dens = torch.zeros_like(density)
    d_pos = torch.empty_like(pos)
    d_ts = torch.empty_like(pos)
    cuda_build.check(
        fn(cuda_build.ptr(density), cuda_build.ptr(to_sun), nx, ny, nz,
           _grid_consts(density, sample_step, density_multiplier), n_steps,
           cuda_build.ptr(pos), cuda_build.ptr(trans), cuda_build.ptr(g_trans), n,
           cuda_build.ptr(d_dens), cuda_build.ptr(d_pos), cuda_build.ptr(d_ts),
           cuda_build.stream_handle()),
        "sun march adjoint kernel",
    )
    launch_sun_march_bwd.launches += 1
    return d_dens, d_pos, d_ts.sum(dim=0)


launch_sun_march_bwd.launches = 0


class _SunMarch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, density, to_sun, pos, density_multiplier, n_steps, sample_step):
        flat = pos.reshape(-1, 3).contiguous()
        trans = launch_sun_march(density, to_sun, flat, density_multiplier, n_steps,
                                 sample_step)
        ctx.save_for_backward(density, to_sun, flat, trans)
        ctx.args = (density_multiplier, n_steps, sample_step)
        ctx.pos_shape = pos.shape
        return trans.reshape(pos.shape[:-1])

    @staticmethod
    def backward(ctx, g):
        density, to_sun, flat, trans = ctx.saved_tensors
        d_dens, d_pos, d_ts = launch_sun_march_bwd(
            density, to_sun, flat, trans, g.reshape(-1).contiguous(), *ctx.args)
        return d_dens, d_ts, d_pos.reshape(ctx.pos_shape), None, None, None


def sun_transmittance(density, sun_dir, pos, density_multiplier: float, n_steps: int,
                      sample_step: float = 1.0 / 256.0, device="cuda") -> torch.Tensor:
    """Differentiable in-scatter: Beer-Lambert transmittance from ``pos``
    [..., 3] toward the sun — the kernel for tensors on the card, the plain
    version for CPU tensors."""
    dev = resolve_device(device)
    check_on(dev, density, sun_dir, pos)
    if density.is_cuda:
        return _SunMarch.apply(density, _to_sun(sun_dir).contiguous(), pos,
                               _f32(density_multiplier), n_steps, _f32(sample_step))
    return sun_transmittance_plain(density, sun_dir, pos, density_multiplier, n_steps,
                                   sample_step)


# ---------------------------------------------------------------------------
# The in-scatter bake (diff.py:270-309): forward on K3, adjoint K8a.
# ---------------------------------------------------------------------------


def bake_inscatter_diff_plain(density, bbox, light_dir, density_multiplier,
                              sample_step: float,
                              voxels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the differentiable bake → T [Z, Y, X]:
    ``render.inscatter.sun_transmittance_plain``'s exact mode (no early-out,
    no quantization), each step rematerialized in the backward pass.  The
    steps' density gradients are summed in float64 (the grid enters each
    step as a float32 copy of a float64 one: the same values): a texel on
    the box's faces takes the clamped samples of every march that leaves
    across it, which a float32 sum over the steps rounds to ~1e-3.
    ``voxels``: flat z-major indices [M] to bake only those voxels → T [M]."""
    base = inscatter.voxel_base(density.shape, density.device)
    if voxels is not None:
        base = base[voxels]
    step = _f32(sample_step)
    to_light = -light_dir

    def body(trans, dens64, tl, s):
        pos = base + tl * s
        sigma = grid_ops.sample_trilinear(dens64.to(torch.float32), pos / bbox)
        return trans * torch.exp(-(sigma * density_multiplier) * step)

    trans = torch.ones(base.shape[:1], dtype=torch.float32, device=density.device)
    dens64 = density.to(torch.float64)
    for i in range(inscatter.bake_steps(step, False)):
        trans = _remat(functools.partial(body, s=_step_distance(step, i)), trans, dens64,
                       to_light)
    return trans if voxels is not None else trans.reshape(density.shape)


_ADJ_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
]


def launch_bake_adjoint(density, bbox, light_dir, density_multiplier, sample_step, trans,
                        g_trans, lib=None, float64: bool = False):
    """K8a (``ds_bake_adjoint``): the bake's adjoint at T ``trans`` for the
    upstream ``g_trans`` (both [V]) → (d density [Z, Y, X], d light_dir
    [3]), float32, or the kernel's float64 sums where ``float64``.
    ``bbox``, ``light_dir``: the host floats the forward ran with."""
    _check_grid(density)
    v = density.numel()
    _check_vec("trans", trans, v)
    _check_vec("g_trans", g_trans, v)
    nz, ny, nx = density.shape
    lib = lib or cuda_build.load("diff")
    lib.ds_bake_adjoint_blocks.argtypes = [ctypes.c_int] * 3
    lib.ds_bake_adjoint_blocks.restype = ctypes.c_int64
    blocks = lib.ds_bake_adjoint_blocks(nx, ny, nz)
    fn = lib.ds_bake_adjoint
    fn.argtypes = _ADJ_ARGTYPES
    fn.restype = ctypes.c_int
    consts = (ctypes.c_float * 9)(*bbox, *light_dir, sample_step, density_multiplier,
                                  float(max(nx, ny, nz)))
    d_dens = torch.zeros(density.shape, dtype=torch.float64, device=density.device)
    partials = torch.zeros((blocks, 3), dtype=torch.float64, device=density.device)
    cuda_build.check(
        fn(cuda_build.ptr(density), nx, ny, nz, consts, inscatter.bake_steps(sample_step, False),
           cuda_build.ptr(trans), cuda_build.ptr(g_trans), cuda_build.ptr(d_dens),
           cuda_build.ptr(partials), cuda_build.stream_handle()),
        "bake adjoint kernel",
    )
    launch_bake_adjoint.launches += 1
    d_light = partials.sum(dim=0)
    if float64:
        return d_dens, d_light
    return d_dens.to(torch.float32), d_light.to(torch.float32)


launch_bake_adjoint.launches = 0


class _BakeDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, density, light_dir, bbox, density_multiplier, sample_step):
        # K3 takes the light as host floats: one read-back a call.
        light = tuple(light_dir.detach().tolist())
        _check_grid(density)
        trans = inscatter.launch_bake(density, bbox, light, sample_step, density_multiplier,
                                      early_out=False)
        ctx.save_for_backward(density, trans)
        ctx.args = (bbox, light, density_multiplier, sample_step)
        return trans.reshape(density.shape)

    @staticmethod
    def backward(ctx, g):
        density, trans = ctx.saved_tensors
        d_dens, d_light = launch_bake_adjoint(density, *ctx.args, trans,
                                              g.reshape(-1).contiguous())
        return d_dens, d_light, None, None, None


def _bake(density, bbox, light_dir, density_multiplier, sample_step, kernels: bool):
    if kernels:
        return _BakeDiff.apply(density, light_dir, _bbox_host(density.shape),
                               _f32(density_multiplier), _f32(sample_step))
    return bake_inscatter_diff_plain(density, bbox, light_dir, density_multiplier, sample_step)


def bake_inscatter_diff(density, bbox, light_dir, density_multiplier, sample_step: float,
                        device="cuda") -> torch.Tensor:
    """Differentiable sun-transmittance bake of a ``[Z, Y, X]`` density →
    T [Z, Y, X] (``render.inscatter.bake``'s exact mode): K3 forward and
    K8a backward for tensors on the card, the plain version for CPU
    tensors.  ``light_dir``: normalized, pointing from the sun."""
    dev = resolve_device(device)
    check_on(dev, density, bbox, light_dir)
    if density.is_cuda:
        host = tuple(bbox.detach().tolist())
        if host != _bbox_host(density.shape):
            raise ValueError(f"bbox {host} is not the density's {_bbox_host(density.shape)}")
    return _bake(density, bbox, light_dir, density_multiplier, sample_step, density.is_cuda)


# ---------------------------------------------------------------------------
# The quadrature march (diff.py:198-238): plain version, K8b, the render.
# ---------------------------------------------------------------------------


class MarchMeta(NamedTuple):
    """The quadrature march's host values (float32 values as floats)."""

    bbox: Tuple[float, float, float]
    step: float
    density_multiplier: float
    sun_ratio: float
    n_steps: int  # steps marched: remat_chunk times the chunks
    sun_steps: int


def quadrature_march_plain(density, baked, to_sun, entry, dirs, p_phase, meta: MarchMeta,
                           remat_chunk: int) -> torch.Tensor:
    """Plain version of K8b: the radiance sum of every ray [N] (rays that
    miss the box included), in-scatter from ``baked`` or, where it is None,
    the sun march toward ``to_sun``; each chunk of ``remat_chunk`` steps
    rematerialized in the backward pass."""
    bbox = torch.tensor(meta.bbox, dtype=torch.float32, device=density.device)
    step, dm, sun_ratio = meta.step, meta.density_multiplier, meta.sun_ratio

    def t_sun_at(p):
        if baked is not None:
            return grid_ops.sample_trilinear(baked, p / bbox)
        return _remat(lambda d, ts, q: _sun_march_plain(d, ts, q, dm, meta.sun_steps, step),
                      density, to_sun, p)

    def chunk(tau, radiance, i0):
        for i in range(i0, i0 + remat_chunk):
            p = entry + dirs * _step_distance(step, i + 1)
            sigma = sample_density(density, bbox, p) * dm
            t_view = torch.exp(-tau)
            seg = 1.0 - torch.exp(-sigma * step)
            # The segment's free-flight mean point (diff.py:217-223).
            sig = torch.clamp(sigma, min=1e-6)
            a = sig * step
            em = -torch.expm1(-a)
            exact = 1.0 / sig - step * torch.exp(-a) / torch.clamp(em, min=1e-30)
            taylor = step * (0.5 - grid_ops.true_div(a, 12.0))
            mean_x = torch.where(a < 1e-3, taylor, exact)
            p_nee = p - dirs * (step - mean_x)[:, None]
            contrib = t_view * seg * t_sun_at(p_nee) * p_phase * sun_ratio
            tau = tau + sigma * step
            radiance = radiance + contrib
        return tau, radiance

    tau = torch.zeros(entry.shape[0], dtype=torch.float32, device=entry.device)
    radiance = torch.zeros_like(tau)
    for i0 in range(0, meta.n_steps, remat_chunk):
        tau, radiance = _remat(functools.partial(chunk, i0=i0), tau, radiance)
    return radiance


_MARCH_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
]
_MARCH_BWD_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def _march_inputs(density, baked, to_sun, entry, dirs, p_phase, hit):
    _check_grid(density)
    if baked is not None:
        _check_grid(baked)
        if baked.shape != density.shape:
            raise ValueError("the baked grid must have the density's shape")
    else:
        _check_vec("to_sun", to_sun, 3)
    cuda_build.require_vec3(entry=entry, dirs=dirs)
    n = entry.shape[0]
    _check_vec("p_phase", p_phase, n)
    if hit.dtype != torch.uint8 or not hit.is_contiguous() or hit.numel() != n:
        raise ValueError(f"hit must be a contiguous uint8 tensor of {n} values")
    return n


def _march_consts(meta: MarchMeta):
    return (ctypes.c_float * 6)(*meta.bbox, meta.step, meta.density_multiplier, meta.sun_ratio)


def launch_march(density, baked, to_sun, entry, dirs, p_phase, hit, meta: MarchMeta,
                 steps: Optional[torch.Tensor] = None, lib=None) -> torch.Tensor:
    """K8b's forward (``ds_diff_march``) → the radiance sum [N] (0 where
    ``hit`` [N] uint8 is 0).  ``steps``: None, or an int32 [N, 3] the kernel
    fills with each ray's steps in the box, its steps with sigma != 0 and
    the sun march's samples in the box at those steps (0 baked)."""
    n = _march_inputs(density, baked, to_sun, entry, dirs, p_phase, hit)
    if steps is not None and (steps.dtype != torch.int32 or steps.shape != (n, 3)):
        raise ValueError("steps must be an int32 [N, 3] tensor")
    fn = (lib or cuda_build.load("diff")).ds_diff_march
    fn.argtypes = _MARCH_ARGTYPES
    fn.restype = ctypes.c_int
    nz, ny, nx = density.shape
    rad = torch.empty(n, dtype=torch.float32, device=entry.device)
    cuda_build.check(
        fn(cuda_build.ptr(density), cuda_build.ptr(baked), cuda_build.ptr(to_sun), nx, ny, nz,
           _march_consts(meta), meta.n_steps, meta.sun_steps, cuda_build.ptr(entry),
           cuda_build.ptr(dirs), cuda_build.ptr(p_phase), cuda_build.ptr(hit), n,
           cuda_build.ptr(rad), cuda_build.ptr(steps), cuda_build.stream_handle()),
        "quadrature march kernel",
    )
    launch_march.launches += 1
    return rad


launch_march.launches = 0


class MarchGrads(NamedTuple):
    density: torch.Tensor  # [Z, Y, X]
    baked: Optional[torch.Tensor]  # [Z, Y, X] (baked in-scatter)
    to_sun: Optional[torch.Tensor]  # [3] (pointwise in-scatter)
    entry: torch.Tensor  # [N, 3]
    dirs: torch.Tensor  # [N, 3]
    p_phase: torch.Tensor  # [N]


def launch_march_bwd(density, baked, to_sun, entry, dirs, p_phase, hit, radiance, g_rad,
                     meta: MarchMeta, lib=None) -> MarchGrads:
    """K8b's backward (``ds_diff_march_bwd``) for the upstream ``g_rad``
    [N] at the forward's ``radiance`` [N]."""
    n = _march_inputs(density, baked, to_sun, entry, dirs, p_phase, hit)
    _check_vec("radiance", radiance, n)
    _check_vec("g_rad", g_rad, n)
    fn = (lib or cuda_build.load("diff")).ds_diff_march_bwd
    fn.argtypes = _MARCH_BWD_ARGTYPES
    fn.restype = ctypes.c_int
    nz, ny, nx = density.shape
    d_dens = torch.zeros_like(density)
    d_baked = None if baked is None else torch.zeros_like(baked)
    d_entry = torch.empty_like(entry)
    d_dirs = torch.empty_like(dirs)
    d_phase = torch.empty_like(p_phase)
    d_ts = torch.empty_like(entry) if baked is None else None
    cuda_build.check(
        fn(cuda_build.ptr(density), cuda_build.ptr(baked), cuda_build.ptr(to_sun), nx, ny, nz,
           _march_consts(meta), meta.n_steps, meta.sun_steps, cuda_build.ptr(entry),
           cuda_build.ptr(dirs), cuda_build.ptr(p_phase), cuda_build.ptr(hit),
           cuda_build.ptr(radiance), cuda_build.ptr(g_rad), n, cuda_build.ptr(d_dens),
           cuda_build.ptr(d_baked), cuda_build.ptr(d_entry), cuda_build.ptr(d_dirs),
           cuda_build.ptr(d_phase), cuda_build.ptr(d_ts), cuda_build.stream_handle()),
        "quadrature march adjoint kernel",
    )
    launch_march_bwd.launches += 1
    return MarchGrads(d_dens, d_baked, None if d_ts is None else d_ts.sum(dim=0), d_entry,
                      d_dirs, d_phase)


launch_march_bwd.launches = 0


class _QuadratureMarch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, density, baked, to_sun, entry, dirs, p_phase, hit, meta):
        rad = launch_march(density, baked, to_sun, entry, dirs, p_phase, hit, meta)
        ctx.save_for_backward(density, baked, to_sun, entry, dirs, p_phase, hit, rad)
        ctx.meta = meta
        return rad

    @staticmethod
    def backward(ctx, g):
        density, baked, to_sun, entry, dirs, p_phase, hit, rad = ctx.saved_tensors
        d = launch_march_bwd(density, baked, to_sun, entry, dirs, p_phase, hit, rad,
                             g.contiguous(), ctx.meta)
        return d.density, d.baked, d.to_sun, d.entry, d.dirs, d.p_phase, None, None


class MarchSetup(NamedTuple):
    """What the quadrature march takes: the in-scatter (a baked grid, or
    the sun direction for the sun march), the rays and their hit flags, the
    phase value of each ray and the host values."""

    baked: Optional[torch.Tensor]  # [Z, Y, X]
    to_sun: Optional[torch.Tensor]  # [3]
    entry: torch.Tensor  # [N, 3]
    dirs: torch.Tensor  # [N, 3]
    p_phase: torch.Tensor  # [N]
    hit: torch.Tensor  # [N] bool
    meta: MarchMeta


def march_setup(scene: DiffScene, width, height, density_multiplier, n_steps, sun_steps,
                sample_step, sun_cos_half_angle, remat_chunk, use_baked_inscatter,
                kernels: bool) -> MarchSetup:
    """The render's work before the march (diff.py:153-196): the camera
    rays, their box entry, the phase and the in-scatter (baked through K3
    where ``kernels``)."""
    density, sun_dir = scene.density, scene.sun_dir
    bbox = _bbox(density)
    sun_n = sun_dir / torch.linalg.norm(sun_dir)
    origins, dirs = camera_rays(scene.eye, scene.look_at, width, height)
    baked = to_sun = None
    if use_baked_inscatter:
        baked = _bake(density, bbox, sun_n, density_multiplier, sample_step, kernels)
    else:
        to_sun = _to_sun(sun_dir)

    # Axis-parallel rays have a zero direction component; the guarded
    # reciprocal keeps the backward pass finite (0 * inf = NaN in reverse
    # mode even for rays the final `where` masks out).
    half = bbox * 0.5
    tiny = torch.full_like(dirs, 1e-9)
    safe = torch.where(dirs.abs() < 1e-9, torch.where(dirs >= 0.0, tiny, -tiny), dirs)
    inv = 1.0 / safe
    t0 = (-half - origins) * inv
    t1 = (half - origins) * inv
    t_near = torch.clamp(torch.amax(torch.minimum(t0, t1), dim=-1), min=1e-4)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = t_near < t_far
    entry = origins + dirs * t_near[:, None] + half

    cos_light = (-sun_n * dirs).sum(dim=-1)
    p_phase = phase_ops.eval_phase(_mie(str(density.device)), cos_light)
    sun_area = 2.0 * math.pi * (1.0 - sun_cos_half_angle)
    meta = MarchMeta(
        bbox=_bbox_host(density.shape), step=_f32(sample_step),
        density_multiplier=_f32(density_multiplier), sun_ratio=_f32(sun_area / (4.0 * math.pi)),
        n_steps=-(-n_steps // remat_chunk) * remat_chunk, sun_steps=sun_steps,
    )
    return MarchSetup(baked, to_sun, entry, dirs, p_phase, hit, meta)


def _render(scene: DiffScene, width, height, density_multiplier, n_steps, sun_steps,
            sample_step, sun_cos_half_angle, remat_chunk, use_baked_inscatter, kernels: bool):
    m = march_setup(scene, width, height, density_multiplier, n_steps, sun_steps, sample_step,
                    sun_cos_half_angle, remat_chunk, use_baked_inscatter, kernels)
    if kernels:
        radiance = _QuadratureMarch.apply(
            scene.density, m.baked, None if m.to_sun is None else m.to_sun.contiguous(),
            m.entry.contiguous(), m.dirs.contiguous(), m.p_phase.contiguous(),
            m.hit.to(torch.uint8), m.meta)
    else:
        radiance = quadrature_march_plain(scene.density, m.baked, m.to_sun, m.entry, m.dirs,
                                          m.p_phase, m.meta, remat_chunk)
    rgb = scene.light_radiance[None, :] * radiance[:, None]
    rgb = torch.where(m.hit[:, None], rgb, 0.0)
    return rgb.reshape(height, width, 3)


def render_single_scatter(
    scene: DiffScene,
    width: int = 64,
    height: int = 32,
    density_multiplier: float = 100.0,
    n_steps: int = 256,
    sun_steps: int = 128,
    sample_step: float = 1.0 / 256.0,
    sun_cos_half_angle: float = math.cos(math.radians(0.53) / 2.0),
    remat_chunk: int = 32,
    use_baked_inscatter: bool = True,
    device="cuda",
) -> torch.Tensor:
    """Differentiable single-scatter render → [height, width, 3].

    ``use_baked_inscatter`` (default) reads the NEE sun transmittance from a
    differentiably baked grid sampled trilinearly (the renderer's
    semantics); ``False`` marches the sun from every sample point
    (``sun_steps`` steps).  The march runs ``remat_chunk`` times
    ``ceil(n_steps / remat_chunk)`` steps.  On the card: K3 and K8a (the
    bake), K8b (the march); on the CPU: the plain versions."""
    dev = resolve_device(device)
    check_on(dev, *scene)
    return _render(scene, width, height, density_multiplier, n_steps, sun_steps, sample_step,
                   sun_cos_half_angle, remat_chunk, use_baked_inscatter,
                   kernels=scene.density.is_cuda)


def render_single_scatter_plain(
    scene: DiffScene,
    width: int = 64,
    height: int = 32,
    density_multiplier: float = 100.0,
    n_steps: int = 256,
    sun_steps: int = 128,
    sample_step: float = 1.0 / 256.0,
    sun_cos_half_angle: float = math.cos(math.radians(0.53) / 2.0),
    remat_chunk: int = 32,
    use_baked_inscatter: bool = True,
) -> torch.Tensor:
    """Plain version of ``render_single_scatter`` on the scene's device
    (the plain bake and march on autograd): the kernels' oracle."""
    return _render(scene, width, height, density_multiplier, n_steps, sun_steps, sample_step,
                   sun_cos_half_angle, remat_chunk, use_baked_inscatter, kernels=False)


def _image_and_grads(render, scene: DiffScene, dev):
    """(image, gradients of the image mean w.r.t. every scene leaf as a
    ``DiffScene``) of ``render(scene)``."""
    check_on(dev, *scene)
    leaves = [t.detach().requires_grad_(True) for t in scene]
    img = render(DiffScene(*leaves))
    grads = torch.autograd.grad(img.mean(), leaves, allow_unused=True)
    return img.detach(), DiffScene(*(
        torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)))


def render_and_grads(scene: DiffScene, device="cuda", **kw):
    """(image, gradients of the image mean w.r.t. every scene leaf as a
    ``DiffScene``)."""
    dev = resolve_device(device)
    return _image_and_grads(lambda s: render_single_scatter(s, device=dev, **kw), scene, dev)


# ---------------------------------------------------------------------------
# Multiple scattering (diff.py:312-421): the path tracer's samples, their
# forward on K4 and their adjoint K8c.
# ---------------------------------------------------------------------------


def diff_scene(cfg: SceneConfig, scene: DiffScene, max_depth: int = 4,
               kernels: Optional[bool] = None) -> Tuple[SceneParams, SceneStatic]:
    """The path tracer's scene as a differentiable function of the leaves
    (diff.py:312-371): the density as the one mip level, the in-scatter
    grid baked unquantized (K3 forward and K8a backward where ``kernels``,
    default for tensors on the card; else the plain bake), the normalized
    sun direction and the light radiance as the scene's light; the static
    facts from ``cfg`` with ``max_depth``, the box as the cloud's AABB (a
    tight box taken from the density would cut the gradient of its zero
    voxels).  The light's host values (the kernels' launch constants) are
    read back once."""
    density = scene.density
    _check_grid(density)
    dev = density.device
    kernels = density.is_cuda if kernels is None else kernels
    nz, ny, nx = density.shape
    bbox = _bbox(density)
    light_dir = scene.sun_dir / torch.linalg.norm(scene.sun_dir)
    cfg = dataclasses.replace(cfg, rendering=dataclasses.replace(cfg.rendering,
                                                                 max_depth=max_depth))
    _, static0 = build_scene(cfg, np.zeros((2, 2, 2), np.float32), device="cpu")
    box = _bbox_host(density.shape)
    max_dim = max(nx, ny, nz)
    static = dataclasses.replace(
        static0, grid_shape=(nz, ny, nx), n_mips=1, mip_shapes=((nz, ny, nx),),
        mip_offsets=(0,), voxel_size_normalized=1.0 / max_dim,
        voxel_size_in_mfp=cfg.cloud.size_m / max_dim / cfg.cloud.mean_free_path_m,
        cloud_aabb=(0.0, 0.0, 0.0) + box, bbox=box,
        light_direction=tuple(float(v) for v in light_dir.detach().tolist()),
        light_rgb=tuple(float(v) for v in scene.light_radiance.detach().tolist()),
        # The JAX package's differentiable loop takes no empty-space skip.
        march_empty_skip=False, occupancy_skip_steps=0,
    )
    baked = _bake(density, bbox, light_dir, static.density_multiplier, static.sample_step,
                  kernels)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    params = SceneParams(
        density_mips=(density,), inscatter=baked, mip_flat=density.reshape(-1),
        bbox_size=bbox, light_dir=light_dir, light_radiance=scene.light_radiance,
        sky_intensity=f32(static.sky_rgb), ground_intensity=f32(static.ground_rgb),
        phase=_phase(str(dev)),
    )
    return params, static


def _sample_params(density, inscatter, phase) -> SceneParams:
    """The fields of a ``SceneParams`` that K4 and K8c read (the textures
    and the phase tables; the light is in the launch constants)."""
    return SceneParams(density_mips=(density,), inscatter=inscatter, mip_flat=None,
                       bbox_size=None, light_dir=None, light_radiance=None, sky_intensity=None,
                       ground_intensity=None, phase=phase)


def path_records_plain(params: SceneParams, static: SceneStatic, entry, dirs, hit, ray_ids,
                       seed: int, n_samples: int) -> torch.Tensor:
    """Plain version of the paths' forward (K4's records): sample k of each
    pixel with the seed ``seed ^ ((k + 1) * 0x9E3779B1)``, a
    ``scatter_loop_plain`` of one sample each → radiance [n_samples, N, 3]
    (0 where ``hit`` is false), differentiable in the scene's tensors,
    ``entry`` and ``dirs``: K8c's oracle.  The density and in-scatter
    gradients are summed in float64, as K8c sums them: the textures enter
    the loop as float64 (``scatter_loop_plain`` reads a float32 copy each
    iteration), since the face texels take every clamped sample near the
    box's faces."""
    p64 = params._replace(density_mips=(params.density_mips[0].to(torch.float64),),
                          inscatter=params.inscatter.to(torch.float64))
    return torch.stack([
        pt_ops.scatter_loop_plain(p64, static, entry, dirs, hit, ray_ids, seed, k + 1, 1,
                                  skip=march_ops.SKIP_NONE).mean
        for k in range(n_samples)])


#: The scratch budget of one K8c launch: the pixels are split into launches
#: whose flight records (n_samples x (max_depth + 1) a pixel) and work-list
#: entries (n_samples a pixel) stay under it.
PATH_SCRATCH_BYTES = 256 * 2**20

_PATH_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
]


class PathGrads(NamedTuple):
    """K8c's outputs: the gradients of sum(g * records) and the replay."""

    density: torch.Tensor  # [Z, Y, X] float64
    inscatter: torch.Tensor  # [Z, Y, X] float64
    light_dir: torch.Tensor  # [3] float64
    light_radiance: torch.Tensor  # [3] float64
    entry: torch.Tensor  # [N, 3], summed over the samples
    dirs: torch.Tensor  # [N, 3], summed over the samples
    records: pt_ops.SampleRecords  # the replayed records (zeros where not hit)


def launch_path_adjoint(params: SceneParams, static: SceneStatic, entry, dirs, hit, ray_ids,
                        seed_base: int, sub_first: int, n_samples: int, g_rec: torch.Tensor,
                        scratch_bytes: int = PATH_SCRATCH_BYTES,
                        remarch: Optional[torch.Tensor] = None,
                        counters: Optional[torch.Tensor] = None, lib=None) -> PathGrads:
    """K8c (``ds_path_adjoint``): K4's samples (``launch_samples``' with the
    same arguments; float32 textures) replayed and differentiated for the
    upstream ``g_rec`` [n_samples, N, 3] of their records, in launches of
    as many pixels as fit ``scratch_bytes`` of flight records and work-list
    entries; each launch runs the replay, then the sweep.
    ``remarch``: None, or an int32 [n_samples, N] the kernel fills with the
    steps each sample's adjoint re-marched (the flights that ended in an
    in-box scatter).  ``counters``: None, or an int64 [4] the last launch
    fills with its counters (the replay's queue head, the work list's front
    length (the samples with the longest re-march), the sweep's queue head,
    the list's back length)."""
    n, dev, dens, insc, hit8, ray_ids = pt_ops.check_launch(params, entry, dirs, hit, ray_ids,
                                                            n_samples)
    if dens.dtype != torch.float32:
        raise ValueError("K8c takes float32 textures")
    if (g_rec.dtype != torch.float32 or g_rec.shape != (n_samples, n, 3)
            or not g_rec.is_contiguous()):
        raise ValueError(f"g_rec must be a contiguous float32 [{n_samples}, {n}, 3] tensor")
    check_on(dev, g_rec)
    if remarch is not None and (remarch.dtype != torch.int32
                                or remarch.shape != (n_samples, n)):
        raise ValueError(f"remarch must be an int32 [{n_samples}, {n}] tensor")
    if counters is None:
        counters = torch.empty(4, dtype=torch.int64, device=dev)
    elif counters.dtype != torch.int64 or counters.shape != (4,):
        raise ValueError("counters must be an int64 [4] tensor")
    check_on(dev, counters)
    lib = lib or cuda_build.load("path_adjoint")
    lib.ds_path_pixel_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ds_path_pixel_bytes.restype = ctypes.c_int64
    lib.ds_path_adjoint_blocks.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.ds_path_adjoint_blocks.restype = ctypes.c_int64
    fn = lib.ds_path_adjoint
    fn.argtypes = _PATH_ARGTYPES
    fn.restype = ctypes.c_int
    max_segments = static.max_depth + 1
    per_pixel = lib.ds_path_pixel_bytes(n_samples, max_segments)
    m = max(1, min(n, scratch_bytes // per_pixel))
    scratch = torch.empty(m * per_pixel, dtype=torch.uint8, device=dev)
    rec_rad = torch.empty((n_samples, n, 3), dtype=torch.float32, device=dev)
    rec_work = torch.empty((n_samples, n, 2), dtype=torch.int32, device=dev)
    d_dens = torch.zeros(dens.shape, dtype=torch.float64, device=dev)
    d_insc = torch.zeros(insc.shape, dtype=torch.float64, device=dev)
    d_entry = torch.empty((n_samples, n, 3), dtype=torch.float32, device=dev)
    d_dirs = torch.empty((n_samples, n, 3), dtype=torch.float32, device=dev)
    light = torch.zeros(6, dtype=torch.float64, device=dev)
    consts, ground, flags, cap = pt_ops.launch_consts(static)
    nz, ny, nx = static.grid_shape
    ph = params.phase
    for r0 in range(0, n, m):
        mm = min(m, n - r0)
        rows = lib.ds_path_adjoint_blocks(mm, n_samples)
        if rows < 0:
            raise RuntimeError("path adjoint kernel: no launch configuration")
        partials = torch.empty((rows, 6), dtype=torch.float64, device=dev)
        cuda_build.check(
            fn(cuda_build.ptr(dens), cuda_build.ptr(insc), nx, ny, nz,
               cuda_build.ptr(ph.eval_rows), ph.eval_rows.shape[0],
               cuda_build.ptr(ph.inv_cdf_rows), ph.inv_cdf_rows.shape[0],
               cuda_build.ptr(entry), cuda_build.ptr(dirs), cuda_build.ptr(hit8),
               cuda_build.ptr(ray_ids), n, r0, mm, consts, ground, cap, static.max_depth,
               static.rr_start_depth, flags, int(seed_base) & 0xFFFFFFFF,
               int(sub_first) & 0xFFFFFFFF, int(n_samples), cuda_build.ptr(g_rec),
               cuda_build.ptr(scratch), max_segments, cuda_build.ptr(counters),
               cuda_build.ptr(rec_rad),
               cuda_build.ptr(rec_work), cuda_build.ptr(d_dens), cuda_build.ptr(d_insc),
               cuda_build.ptr(d_entry), cuda_build.ptr(d_dirs), cuda_build.ptr(remarch),
               cuda_build.ptr(partials), cuda_build.stream_handle()),
            "path adjoint kernel",
        )
        launch_path_adjoint.launches += 1
        light += partials.sum(dim=0)
    return PathGrads(d_dens, d_insc, light[:3], light[3:], d_entry.sum(dim=0),
                     d_dirs.sum(dim=0), pt_ops.SampleRecords(rec_rad, rec_work))


launch_path_adjoint.launches = 0


class _PathTrace(torch.autograd.Function):
    """The paths' records [n_samples, N, 3] (0 where a pixel misses the
    box): K4 forward, K8c backward."""

    @staticmethod
    def forward(ctx, density, inscatter, light_dir, light_radiance, entry, dirs, hit, ray_ids,
                static, phase, seed, n_samples):
        rec = pt_ops.launch_samples(_sample_params(density, inscatter, phase), static, entry,
                                    dirs, hit, ray_ids, seed, 1, n_samples)
        ctx.save_for_backward(density, inscatter, entry, dirs, hit, ray_ids)
        ctx.args = (static, phase, seed, n_samples)
        return torch.where(hit[None, :, None], rec.radiance, 0.0)

    @staticmethod
    def backward(ctx, g):
        density, inscatter, entry, dirs, hit, ray_ids = ctx.saved_tensors
        static, phase, seed, n_samples = ctx.args
        d = launch_path_adjoint(_sample_params(density, inscatter, phase), static, entry, dirs,
                                hit, ray_ids, seed, 1, n_samples, g.contiguous())
        f32 = torch.float32
        return (d.density.to(f32), d.inscatter.to(f32), d.light_dir.to(f32),
                d.light_radiance.to(f32), d.entry, d.dirs) + (None,) * 6


class PathRays(NamedTuple):
    """The paths' camera rays: directions (nudged off the axes), their ids
    (the RNG streams), box hits and entry points (local coordinates)."""

    dirs: torch.Tensor  # [N, 3]
    ids: torch.Tensor  # [N] int64
    hit: torch.Tensor  # [N] bool
    entry: torch.Tensor  # [N, 3]


def path_rays(scene: DiffScene, cfg: SceneConfig, width: int, height: int,
              params: SceneParams, static: SceneStatic) -> PathRays:
    """The render's rays (diff.py:395-403), differentiable in the camera:
    the box hit and entry as ``pathtracer.render_subframe`` forms them."""
    origins, dirs = camera_rays(scene.eye, scene.look_at, width, height, cfg.camera.hfov_deg)
    # Axis-parallel guard: the box test divides by the direction (IEEE inf
    # forward, but 0 * inf = NaN in reverse mode even for masked rays).
    tiny = torch.full_like(dirs, 1e-9)
    dirs = torch.where(dirs.abs() < 1e-9, torch.where(dirs >= 0.0, tiny, -tiny), dirs)
    ids = torch.arange(origins.shape[0], dtype=torch.int64, device=dirs.device)
    hit, t_hit = camera_ops.intersect_box(origins, dirs, static, params.bbox_size)
    entry = camera_ops.entry_points(origins, dirs, t_hit, params.bbox_size)
    return PathRays(dirs, ids, hit, entry)


def _render_ms(scene: DiffScene, cfg: SceneConfig, width, height, max_depth, n_subframes, seed,
               kernels: bool):
    params, static = diff_scene(cfg, scene, max_depth, kernels)
    dirs, ids, hit, entry = path_rays(scene, cfg, width, height, params, static)
    if kernels:
        rec = _PathTrace.apply(scene.density, params.inscatter, params.light_dir,
                               params.light_radiance, entry.contiguous(), dirs.contiguous(), hit,
                               ids, static, params.phase, seed, n_subframes)
    else:
        rec = path_records_plain(params, static, entry, dirs, hit, ids, seed, n_subframes)
    miss = camera_ops.miss_radiance(params, static, dirs)
    acc = torch.zeros_like(miss)
    for s in range(n_subframes):
        acc = acc + torch.where(hit[:, None], rec[s], miss)
    return grid_ops.true_div(acc, float(n_subframes)).reshape(height, width, 3)


def render_multi_scatter_mc(
    scene: DiffScene,
    cfg: SceneConfig,
    width: int = 16,
    height: int = 8,
    max_depth: int = 4,
    n_subframes: int = 2,
    seed: int = 0,
    device="cuda",
) -> torch.Tensor:
    """Differentiable multi-scatter Monte-Carlo render → [height, width, 3].

    The estimator is the path tracer's (mode, sky and roulette from
    ``cfg.rendering``) with its seeds: the image equals the mean of
    ``pathtracer.render_subframe`` over subframes 1 .. ``n_subframes``
    with the seed ``seed``, summed in subframe order.  Gradients reach the
    density through every march step, scatter position and the in-scatter
    bake, the sun direction, the light radiance and the camera.  On the
    card: K3 and K8a (the bake), K4 (the paths, all subframes in one
    launch) and K8c (their adjoint); on the CPU: the plain versions."""
    dev = resolve_device(device)
    check_on(dev, *scene)
    return _render_ms(scene, cfg, width, height, max_depth, n_subframes, seed,
                      kernels=scene.density.is_cuda)


def render_multi_scatter_mc_plain(
    scene: DiffScene,
    cfg: SceneConfig,
    width: int = 16,
    height: int = 8,
    max_depth: int = 4,
    n_subframes: int = 2,
    seed: int = 0,
) -> torch.Tensor:
    """Plain version of ``render_multi_scatter_mc`` on the scene's device
    (the plain bake and ``scatter_loop_plain`` on autograd): the kernels'
    oracle."""
    return _render_ms(scene, cfg, width, height, max_depth, n_subframes, seed, kernels=False)


def multi_scatter_and_grads(scene: DiffScene, cfg: SceneConfig, device="cuda", **kw):
    """(image, gradients of the image mean w.r.t. every scene leaf as a
    ``DiffScene``) of ``render_multi_scatter_mc``."""
    dev = resolve_device(device)
    return _image_and_grads(lambda s: render_multi_scatter_mc(s, cfg, device=dev, **kw),
                            scene, dev)
