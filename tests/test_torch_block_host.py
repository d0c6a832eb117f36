"""K4's occupancy-block skip and K7a's empty-cell jump as their kernels now take them, on the host.

K4's block skip reads the occupancy only where a sample holds no
certificate (``csrc/pathtrace.cuh::march_steps_block``): (a) a step that
lands in a cell with a nonzero density corner certifies that the next
``ops/march.py::block_sure_steps`` (L) plain steps leave occupied blocks;
(b) the occupancy is read as bits (``ops/grid.py::occupancy_bits``,
``SceneParams.occupancy_bits``).  K7a's cell jump runs a thread an
attempt (``csrc/samples.cu::attempt_chunk_jump``, the jump inside a
lookahead chunk, the exit from ``FaceExit``).

- Certificate (a): on the skip phase's occupancies (``chip_smoke.py``'s PT
  cell, the cumulus of seed 11 at 256^3 and 64^3, step 1/512: L = 12 and
  48) and on 40^3 and 43 x 37 x 40 grids holding single dense voxels at
  block corners and on every grid edge (the clipping of ``block_index``
  and ``axis_cell``, a box that is not a cube), on uint8 and float32
  textures: for every texel above 0, every block within 1.5 + L * step *
  n / bbox voxels of it (each axis clamped into [0, n]) is occupied; and
  from points whose cell has a nonzero corner (inside the box and in its
  +-0.01 margin), the serial sums of L plain steps in random and
  axis-parallel directions all read occupancy 1 by ``sample_occupancy``.
  L is 0 where the step is too coarse.
- ``occupancy_bits`` is the occupancy's ``>= 0.5`` bit by bit, and the
  scene carries it beside the occupancy.
- K4 (``tests/torch_kernel_host.cpp``, ``host_set_block``): the kernels'
  design equals the first design (the float32 occupancy read at every
  step) bitwise: records, folds, steps and lattice steps jumped, in item
  order and shuffled, at lookahead 1 and the kernel's, also with a cap of
  27 lattice steps a sample inside a chunk; on the two-blob scene of
  ``test_torch_skip_host.py`` at step 1/64 (L = 8, long steps of 10) and
  1/256 (L = 32, long steps of 42), both texture types (the in-scatter
  grid unbaked: ones); the certificate spares reads.
- K7a: the thread an attempt (``host_set_samples`` mode 3, 32 attempts a
  round, lookahead 4) equals the first design (rounds of 8 attempts, each
  in chunks of 32 lanes) bitwise on every field, on the two-blob scene
  (48^3: the exit from the face table) and the blobs in a 64^3 grid (the
  faces by product), both texture types; and on uint8 at 48^3 the plain
  version ``generate_scatter_samples_plain``: found flags, attempts and
  steps bitwise, positions and directions within 1e-6 (glibc's
  ``sinf``/``cosf``/``logf`` are not torch's; on the card every field is
  bitwise, ``test_torch_cuda_kernels.py``).

Skips only where g++ is absent (the certificate's checks need none).
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from deepestscatter_tpu_torch import build_scene, config
from deepestscatter_tpu_torch.data import collectors, procedural
from deepestscatter_tpu_torch.ops import grid as tgrid
from deepestscatter_tpu_torch.ops import march
from deepestscatter_tpu_torch.render import camera

from test_torch_kernel_host import SAMPLES, _host_stream, _torch_threads, host_lib  # noqa: F401
from test_torch_skip_host import PIXELS, _equal, _pt, _static, two_blobs

#: ``host_set_block``'s designs (``csrc/pathtrace_variants.cu``'s codes):
#: the first and the kernels'.
FIRST, KERNELS = 0, 1


def _scene(density, dtype, step=1.0 / 512.0, skipping=True):
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        camera=config.CameraConfig(width=PIXELS, height=PIXELS),
        rendering=config.CloudRendering(march_dtype=dtype, sample_step=step, max_depth=10,
                                        occupancy_skipping=skipping))
    return build_scene(cfg, density, device="cpu")


# -- the certificate ----------------------------------------------------------

def _reach(static, L):
    """Voxels a point may be from a corner of its cell after L plain steps,
    along each (x, y, z) axis."""
    nz, ny, nx = static.grid_shape
    return [1.5 + L * static.sample_step * n / b for n, b in zip((nx, ny, nz), static.bbox)]


def _blocks_covered(params, static, L):
    """Every block within reach of a texel above 0 (each axis clamped into
    [0, n]) is occupied."""
    tex = params.density_mips[0].numpy()
    occ = params.occupancy.numpy()
    nz, ny, nx = static.grid_shape
    z, y, x = np.nonzero(tex > 0)
    reach = _reach(static, L)
    b = static.occupancy_block
    ranges = []
    for v, n, r, nb in zip((x, y, z), (nx, ny, nz), reach, occ.shape[::-1]):
        v = v.astype(np.float64)
        lo = np.clip(np.floor(np.clip(v - r, 0, n) / b), 0, nb - 1).astype(np.int64)
        hi = np.clip(np.floor(np.clip(v + r, 0, n) / b), 0, nb - 1).astype(np.int64)
        assert int((hi - lo).max()) <= 2
        ranges.append((lo, hi))
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                (lx, hx), (ly, hy), (lz, hz) = ranges
                ix, iy, iz = np.minimum(lx + dx, hx), np.minimum(ly + dy, hy), np.minimum(lz + dz, hz)
                assert (occ[iz, iy, ix] >= 0.5).all()
    return z.size


def _corner_max(tex, u, shape):
    """The largest of the eight corners of the packed cell at ``u``."""
    nz, ny, nx = shape
    c = [tgrid._axis_cell(u[..., i] * float(n) - 0.5, n) for i, n in enumerate((nx, ny, nz))]
    flat = tex.reshape(-1).to(torch.float32)
    out = None
    for k in range(8):
        xi, yi, zi = c[0][k & 1], c[1][(k >> 1) & 1], c[2][k >> 2]
        v = flat[(zi * ny + yi) * nx + xi]
        out = v if out is None else torch.maximum(out, v)
    return out


def _rays_stay_occupied(params, static, L, n_points, seed):
    """From points whose cell has a nonzero corner (near texels above 0,
    inside the box and its margin), L plain steps (the serial float32
    sums) in random and axis-parallel directions read occupancy 1."""
    rng = np.random.default_rng(seed)
    tex = params.density_mips[0]
    nz, ny, nx = static.grid_shape
    dims = np.asarray([nx, ny, nz], np.float64)
    bbox = np.asarray(static.bbox, np.float64)
    z, y, x = np.nonzero(tex.numpy() > 0)
    pick = rng.integers(0, z.size, n_points)
    v = np.stack([x[pick], y[pick], z[pick]], axis=1).astype(np.float64)
    vox = v + rng.uniform(-0.5, 1.5, v.shape)  # v is a corner of the cell at vox
    margin = 0.01 * dims / bbox
    vox = np.clip(vox, -margin, dims + margin)
    pos = torch.as_tensor(vox / dims * bbox, dtype=torch.float32)
    d = rng.normal(size=(n_points, 3))
    k = n_points // 4
    d[:k] = 0.0
    d[np.arange(k), rng.integers(0, 3, k)] = rng.choice([-1.0, 1.0], k)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = torch.as_tensor(d, dtype=torch.float32)
    bb = params.bbox_size
    held = _corner_max(tex, pos / bb, static.grid_shape) > 0
    assert held.float().mean().item() > 0.5
    pos, d = pos[held], d[held]
    step = torch.tensor(static.sample_step, dtype=torch.float32)
    for j in range(L + 1):
        occ = tgrid.sample_occupancy(params.occupancy, pos / bb, static.grid_shape,
                                     static.occupancy_block)
        assert bool((occ >= 0.5).all()), f"a point {j} steps on reads an empty block"
        pos = pos + d * step
    return int(held.sum())


@pytest.fixture(scope="module")
def cumulus_256():
    return procedural.cumulus(resolution=256, seed=11)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("res", [256, 64])
def test_certificate_on_the_skip_phase_occupancies(cumulus_256, res, dtype):
    density = cumulus_256 if res == 256 else procedural.cumulus(resolution=64, seed=11)
    params, static = _scene(density, dtype)
    L = march.block_sure_steps(static)
    assert L == {256: 12, 64: 48}[res]
    assert _blocks_covered(params, static, L) > 0
    assert _rays_stay_occupied(params, static, L, 20000, res) > 0


def _edge_grid(shape):
    """Single dense voxels at block corners, on every grid edge and in the
    grid's corners; the rest empty."""
    nz, ny, nx = shape
    d = np.zeros(shape, np.float32)
    for z, y, x in ((0, 0, 0), (nz - 1, ny - 1, nx - 1), (7, 7, 7), (8, 8, 8), (16, 15, 24),
                    (0, ny // 2, nx - 1), (nz - 1, 0, nx // 2), (nz // 2, ny - 1, 0),
                    (0, ny - 1, 8), (nz - 1, 7, 0), (23, 0, nx - 1)):
        d[z, y, x] = 0.8
    return d


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("shape", [(40, 40, 40), (40, 37, 43)], ids=["40^3", "40x37x43"])
def test_certificate_at_block_corners_and_grid_edges(shape, dtype):
    for step in (1.0 / 512.0, 1.0 / 64.0):
        params, static = _scene(_edge_grid(shape), dtype, step)
        L = march.block_sure_steps(static)
        assert L > 0 and static.occupancy_skip_steps >= 2
        assert _blocks_covered(params, static, L) == 11
        assert _rays_stay_occupied(params, static, L, 20000, 3) > 0


def test_sure_steps_is_zero_where_the_step_is_too_coarse():
    _, static = _scene(_edge_grid((40, 40, 40)), "uint8", 1.0 / 64.0)
    assert march.block_sure_steps(dataclasses.replace(static, sample_step=1.0 / 4.0)) == 0
    assert march.block_sure_steps(dataclasses.replace(static, sample_step=1.0 / 8.0)) == 1
    assert march.block_sure_steps(dataclasses.replace(static, occupancy_skip_steps=0)) == 0


def test_occupancy_bits_are_the_occupancy():
    occ = torch.as_tensor(np.random.default_rng(2).uniform(0, 1, (5, 6, 7)) > 0.6,
                          dtype=torch.float32)
    bits = tgrid.occupancy_bits(occ)
    assert bits.dtype == torch.int32 and bits.numel() == (5 * 6 * 7 + 31) // 32
    words = bits.numpy().view(np.uint32)
    i = np.arange(occ.numel())
    got = (words[i >> 5] >> (i & 31)) & 1
    assert np.array_equal(got, (occ.reshape(-1).numpy() >= 0.5).astype(np.uint32))
    params, _ = _scene(_edge_grid((40, 40, 40)), "uint8", 1.0 / 64.0)
    assert torch.equal(params.occupancy_bits, tgrid.occupancy_bits(params.occupancy))
    params, _ = _scene(_edge_grid((40, 40, 40)), "uint8", 1.0 / 64.0, skipping=False)
    assert params.occupancy.numel() == 0 and params.occupancy_bits.numel() == 0


# -- K4's block skip ----------------------------------------------------------

@pytest.fixture(scope="module",
                params=[("uint8", 64), ("float32", 64), ("uint8", 256)],
                ids=["uint8-step64", "float32-step64", "uint8-step256"])
def block_rig(request):
    dtype, per_unit = request.param
    params, static = _scene(two_blobs(), dtype, 1.0 / per_unit)
    assert (static.occupancy_skip_steps, march.block_sure_steps(static)) == \
        {64: (10, 8), 256: (42, 32)}[per_unit]
    o, d = camera.generate_rays(camera.camera_basis(config.CameraConfig(width=PIXELS,
                                                                        height=PIXELS)),
                                PIXELS, PIXELS, "cpu")
    hit, t_hit = camera.intersect_box(o, d, static, params.bbox_size)
    entry = camera.entry_points(o, d, t_hit, params.bbox_size)
    return params, static, (entry, d, hit, torch.arange(o.shape[0]))


@pytest.fixture(scope="module")
def block_host(host_lib):
    """The host build with its block-skip and sampler choices typed."""
    host_lib.host_set_block.argtypes = [ctypes.c_int]
    host_lib.host_block_reads.restype = ctypes.c_int64
    return host_lib


def _block(host, design, params, *args, **kw):
    host.host_set_block(design)
    try:
        return _pt(host, params, *args, **kw)
    finally:
        host.host_set_block(KERNELS)


def test_k4_block_skip_equals_first_design(block_host, block_rig):
    params, static, rays = block_rig
    order = np.random.default_rng(4).permutation(PIXELS * PIXELS * SAMPLES).astype(np.int64)
    for cap in (None, 27):
        ref = _block(block_host, FIRST, params, static, rays, 1, max_steps=cap)
        assert int(ref.jumped.sum()) > 0
        reads = {}
        for lookahead, o in ((0, None), (0, order), (1, order)):
            _equal(_block(block_host, KERNELS, params, static, rays, lookahead, o, cap), ref)
            reads[lookahead] = block_host.host_block_reads()
        # At lookahead 1 a step sampled reads the occupancy only where the
        # certificate does not cover it (a step the cap then stops reads
        # too).
        assert 0 < reads[1] < int(ref.steps.sum()) if cap is None else reads[1] > 0
        if cap is not None:
            assert int((ref.steps + ref.jumped).max()) <= SAMPLES * cap


# -- K7a's cell jump ----------------------------------------------------------

@pytest.fixture(scope="module", params=[("uint8", 48), ("float32", 48), ("uint8", 64)],
                ids=["uint8-48^3", "float32-48^3", "uint8-64^3"])
def sampler_rig(request):
    dtype, grid = request.param
    density = two_blobs()
    if grid == 64:
        density = np.zeros((64, 64, 64), np.float32)
        density[8:56, 8:56, 8:56] = two_blobs()
    params, static = _scene(density, dtype, 1.0 / 64.0, skipping=False)
    return params, _static(static, "cell")


def _samples(host, mode):
    host.host_set_samples(mode, host.ds_sample_warps() if mode == 2 else 32)


def test_k7a_cell_jump_threads_equal_first_design_and_match_plain(block_host, sampler_rig):
    params, st = sampler_rig
    outs = {}
    try:
        for mode in (2, 3):
            _samples(block_host, mode)
            outs[mode] = collectors._launch_samples(params, st, 160, 2, lib=block_host)
    finally:
        _samples(block_host, 2)
    first = outs[2]
    _equal(outs[3], first)
    if params.density_mips[0].shape[0] == 64 or params.density_mips[0].dtype != torch.uint8:
        return  # test_torch_skip_host.py holds the first design against the plain version
    ref = collectors.generate_scatter_samples_plain(params, st, 160, 2)
    for name in ("found", "attempts", "steps"):
        assert torch.equal(getattr(first, name), getattr(ref, name)), name
    for a, b in ((first.positions, ref.positions), (first.directions, ref.directions)):
        assert (a - b).abs().max().item() <= 1e-6
    none = collectors._launch_samples(params, dataclasses.replace(st, march_empty_skip=False),
                                      160, 2, lib=block_host)
    assert int(first.steps.sum()) < int(none.steps.sum())
