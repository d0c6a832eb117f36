"""The empty-cell jump of K4 and K7b as their kernels now take it, on the host.

``tests/torch_kernel_host.cpp`` (built as ``test_torch_kernel_host.py``
builds it) runs the cell jump in three designs (``host_set_jump``): the
first (``march_steps_skip``: a jump ends its lookahead chunk, the exit by
``cell_exit_steps``' ten divisions), the kernels' (``march_steps_jump``:
the jump inside the chunk, the exit from the launch's face table,
``FaceExit``) and the jump inside the chunk with the first design's exit
(``DividedExit``, ``csrc/pathtrace_variants.cu``'s).  The scene: the 48^3
grid of two 16^3 cumulus blobs of ``test_torch_skip_host.py`` at 2000 m,
32 x 32 pixels, ``max_depth`` 10, the cell jump alone, at step 1/64 (a cell
is 1.3 steps) on both texture types and at step 1/256 (5.3 steps: jumps
inside a chunk) on uint8; and the blobs in a 64^3 grid at step 1/256 (4
steps a cell), where the kernels take the faces by product
(``kSkipCellPow2``), not from the face table.

- The face table equals ``axis_exit``'s expressions ``(c + 0.5) / n * b``
  and ``((c + 1) + 0.5) / n * b`` bitwise for every cell of 48^3, 64^3 and
  258^3 grids and of a 36 x 28 x 20 grid (a box that is not a power of
  two); its entry 0 is the step's exact reciprocal (0 where the step is no
  power of two).
- The table's exit equals ``cell_exit_steps`` bitwise on points in every
  cell of 48^3 and 64^3 and on random points of 258^3, with rooms from 0
  to 70 lattice steps, axis-parallel directions and directions under the
  1e-9 guard; without a room, both equal the JAX package's
  ``ops/march.py::empty_cell_exit_steps`` bitwise.
- K4: the kernels' jump and the jump inside the chunk with divided exits,
  at lookahead 1 and at the kernel's, in item order and shuffled, equal
  the first design bitwise (records, folds and each pixel's lattice steps
  jumped), also with a cap of 27 lattice steps a sample inside a chunk.
- K7b: the warp of deferred scatters with the kernels' jump equals K4's
  item loop with it and with the first design, bitwise, jumps included;
  against the plain twin (``scatter_loop_plain`` with the lanes'
  experiment bases) counts equal, steps and jumps equal on >= 99 % of
  lanes, there the mean within 1e-5 and m2 within 1e-4 of their largest
  values (glibc's ``expf``/``logf``/``sinf``/``cosf`` are not torch's).

Skips only where g++ is absent.
"""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepestscatter_tpu.ops import march as jmarch
from deepestscatter_tpu_torch import build_scene, config, with_baked_inscatter
from deepestscatter_tpu_torch.data import collectors
from deepestscatter_tpu_torch.ops import grid as tgrid
from deepestscatter_tpu_torch.render import camera, pathtracer

from test_torch_kernel_host import SAMPLES, SEED, _host_stream, _torch_threads, host_lib  # noqa: F401
from test_torch_skip_host import PIXELS, _equal, _pt, two_blobs

#: The designs of ``host_set_jump``.
FIRST, KERNELS, DIVIDED, TABLE = 0, 1, 2, 3

_F32P = ctypes.POINTER(ctypes.c_float)


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _blobs_64() -> np.ndarray:
    """The two blobs in a 64^3 grid (every cell count a power of two)."""
    d = np.zeros((64, 64, 64), np.float32)
    d[8:56, 8:56, 8:56] = two_blobs()
    return d


@pytest.fixture(scope="module",
                params=[("uint8", 64, 48), ("float32", 64, 48), ("uint8", 256, 48),
                        ("uint8", 256, 64)],
                ids=["uint8-step64", "float32-step64", "uint8-step256", "uint8-step256-64cube"])
def jump_rig(request):
    dtype, per_unit, grid = request.param
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        camera=config.CameraConfig(width=PIXELS, height=PIXELS),
        rendering=config.CloudRendering(march_dtype=dtype, sample_step=1.0 / per_unit,
                                        max_depth=10))
    params, static = build_scene(cfg, two_blobs() if grid == 48 else _blobs_64(), device="cpu")
    static = dataclasses.replace(static, occupancy_skip_steps=0, march_empty_skip=True)
    params = with_baked_inscatter(params, static, device="cpu")
    o, d = camera.generate_rays(camera.camera_basis(cfg.camera), PIXELS, PIXELS, "cpu")
    hit, t_hit = camera.intersect_box(o, d, static, params.bbox_size)
    entry = camera.entry_points(o, d, t_hit, params.bbox_size)
    return params, static, (entry, d, hit, torch.arange(o.shape[0]))


@pytest.fixture(scope="module")
def jump_host(host_lib):
    """The host build with its cell-jump entry points typed."""
    f32p, i32p = _F32P, ctypes.POINTER(ctypes.c_int32)
    host_lib.host_set_jump.argtypes = [ctypes.c_int]
    host_lib.host_face_table.argtypes = [ctypes.c_int] * 3 + [f32p, f32p]
    host_lib.host_exit_steps.argtypes = ([ctypes.c_int, ctypes.c_int64] + [ctypes.c_int] * 3
                                         + [f32p, ctypes.c_float, f32p, f32p, i32p, f32p])
    return host_lib


def _design(host, design, fn, *args, **kw):
    host.host_set_jump(design)
    try:
        return fn(*args, **kw)
    finally:
        host.host_set_jump(KERNELS)


def _face_table(lib, shape, bbox):
    nz, ny, nx = shape
    out = np.zeros(nx + ny + nz + 3, np.float32)
    lib.host_face_table(nx, ny, nz, _fp(bbox), _fp(out))
    return out


GRIDS = [(48, 48, 48), (64, 64, 64), (258, 258, 258), (20, 28, 36)]


@pytest.mark.parametrize("shape", GRIDS, ids=["x".join(map(str, s)) for s in GRIDS])
def test_face_table_equals_axis_exit_faces(jump_host, shape):
    bbox = tgrid.bbox_size_from_shape(shape)
    nz, ny, nx = shape
    table = _face_table(jump_host, shape, bbox)
    at = 0
    for n, b in zip((nx, ny, nz), bbox):
        faces = table[at:at + n + 1]
        c = np.arange(n, dtype=np.float32)
        nf, bf = np.float32(n), np.float32(b)
        lo = (c + np.float32(0.5)) / nf * bf
        hi = ((c + np.float32(1.0)) + np.float32(0.5)) / nf * bf
        assert np.array_equal(faces[:-1].view(np.int32), lo.view(np.int32))
        assert np.array_equal(faces[1:].view(np.int32), hi.view(np.int32))
        if n & (n - 1) == 0:  # the product the kernels take in place of the table
            i = np.arange(n + 1, dtype=np.float32)
            prod = (i + np.float32(0.5)) * np.float32(1.0 / n) * bf
            assert np.array_equal(faces.view(np.int32), prod.view(np.int32))
        at += n + 1
    assert at == table.size


def _exit_points(shape, rng, per_cell):
    """Points in every cell of ``shape`` (``per_cell`` each; random points
    where that is more than 2^20) with their directions."""
    nz, ny, nx = shape
    bbox = tgrid.bbox_size_from_shape(shape)
    dims = np.asarray([nx, ny, nz], np.float32)
    cells = nx * ny * nz
    if cells * per_cell <= 1 << 20:
        idx = np.repeat(np.arange(cells), per_cell)
        lower = np.stack([idx % nx, (idx // nx) % ny, idx // (nx * ny)], axis=1)
        u = (lower + 0.5 + rng.uniform(0.0, 1.0, lower.shape)) / dims
    else:
        u = rng.uniform(0.0, 1.0, (1 << 20, 3))
    pos = np.clip(u, 0.0, 1.0) * bbox
    n = pos.shape[0]
    d = rng.normal(size=(n, 3))
    k = n // 10
    d[:k] = 0.0
    d[np.arange(k), rng.integers(0, 3, k)] = rng.choice([-1.0, 1.0], k)  # axis-parallel
    d[k:2 * k, 1] = 1e-10  # under the 1e-9 guard
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (np.ascontiguousarray(pos, np.float32), np.ascontiguousarray(d, np.float32), bbox,
            dims)


def _exit_steps(lib, design, shape, bbox, step, pos, d, room):
    nz, ny, nx = shape
    out = np.zeros(pos.shape[0], np.float32)
    lib.host_exit_steps(design, pos.shape[0], nx, ny, nz, _fp(bbox), step, _fp(pos), _fp(d),
                        room.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _fp(out))
    return out


@pytest.mark.parametrize("shape", GRIDS[:3], ids=["x".join(map(str, s)) for s in GRIDS[:3]])
def test_exit_steps_equal_first_design_and_jax(jump_host, shape):
    rng = np.random.default_rng(7)
    pos, d, bbox, dims = _exit_points(shape, rng, 4)
    n = pos.shape[0]
    free = np.full(n, 1 << 20, np.int32)
    room = rng.integers(0, 71, n).astype(np.int32)
    for step in (1.0 / 512.0, 1.0 / 64.0, 0.003):
        for r in (free, room):
            first = _exit_steps(jump_host, FIRST, shape, bbox, step, pos, d, r)
            for design in (KERNELS, TABLE):
                got = _exit_steps(jump_host, design, shape, bbox, step, pos, d, r)
                assert np.array_equal(first.view(np.int32), got.view(np.int32))
        if step == 1.0 / 512.0:  # a cell of 48^3 to 258^3 spans 2 to 10.7 steps
            assert first.max() >= 1.0 and first.min() == 0.0
        cell = np.clip(np.floor(pos / bbox * dims - 0.5), 0, dims - 1).astype(np.int32)
        ref = jmarch.empty_cell_exit_steps(jnp.asarray(cell), jnp.asarray(pos), jnp.asarray(d),
                                           jnp.asarray(dims), jnp.asarray(bbox),
                                           jnp.float32(step))
        free_exit = _exit_steps(jump_host, KERNELS, shape, bbox, step, pos, d, free)
        assert np.array_equal(free_exit.view(np.int32), np.asarray(ref).view(np.int32))


def test_k4_jump_equals_first_design(jump_host, jump_rig):
    params, static, rays = jump_rig
    order = np.random.default_rng(4).permutation(PIXELS * PIXELS * SAMPLES).astype(np.int64)
    for cap in (None, 27):
        ref = _design(jump_host, FIRST, _pt, jump_host, params, static, rays, 1, max_steps=cap)
        assert int(ref.jumped.sum()) > 0
        _equal(_design(jump_host, FIRST, _pt, jump_host, params, static, rays, 0, order, cap), ref)
        for design in (KERNELS, DIVIDED, TABLE):
            for lookahead, o in ((1, None), (0, None), (0, order), (1, order)):
                _equal(_design(jump_host, design, _pt, jump_host, params, static, rays, lookahead,
                               o, cap), ref)
        if cap is not None:
            assert int((ref.steps + ref.jumped).max()) <= SAMPLES * cap


def test_k7b_jump_warp_equals_item_loop_and_plain(jump_host, jump_rig):
    params, static, rays = jump_rig
    rs = collectors.radiance_static(static)
    entry, d, hit, _ = rays
    idx = torch.nonzero(hit).flatten()[::4]
    entry, d = entry[idx].contiguous(), d[idx].contiguous()
    n = entry.shape[0]
    ids = torch.arange(n)
    sub0 = torch.tensor([2**32 - 2, 5, 2**31 - 1, 0] * (n // 4 + 1))[:n]
    outs = {}
    for design in (FIRST, KERNELS):
        for mode in (0, 1):
            jump_host.host_set_radiance(mode, 0)
            try:
                outs[design, mode] = _design(jump_host, design, collectors.launch_radiance,
                                             params, rs, entry, d, ids, sub0, SEED, SAMPLES,
                                             lib=jump_host)
            finally:
                jump_host.host_set_radiance(1, 0)
    pm, rec = outs[KERNELS, 1]
    assert int(pm.jumped.sum()) > 0
    for key in ((FIRST, 0), (FIRST, 1), (KERNELS, 0)):
        _equal(outs[key][0], pm)
        _equal(outs[key][1], rec)
    ref = pathtracer.scatter_loop_plain(params, rs, entry, d, torch.ones(n, dtype=torch.bool),
                                        ids, SEED, sub0, SAMPLES)
    assert torch.equal(pm.count, ref.count)
    same = (pm.steps == ref.steps) & (pm.jumped == ref.jumped)
    assert same.float().mean().item() >= 0.99
    for a, b, tol in ((pm.mean, ref.mean, 1e-5), (pm.m2, ref.m2, 1e-4)):
        assert (a - b)[same].abs().max().item() <= tol * (b.abs().max().item() + 1e-12)
