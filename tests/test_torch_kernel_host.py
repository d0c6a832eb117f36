"""K4 (path-trace bounce loop) and K3 (in-scatter bake) on the host.

``tests/torch_kernel_host.cpp`` compiles the kernels' device functions
(``csrc/pathtrace.cu``, ``csrc/inscatter.cu``) with g++ under
``-DDS_HOST_EMULATION`` into a library with the device entry points'
signatures; the wrappers' ``_launch`` drives it on CPU tensors.  What the
warp-level queue and the block-level staging leave to the device is not
here: this pins the arithmetic the kernels share with their host build.

- K4's work items (pixel, sample) traced in a shuffled order into per-sample
  records and then folded equal, bitwise, the per-pixel loop
  ``pathtrace_pixel``; so does the march for K = 1 and the kernel's
  lookahead K, also with a step cap that cuts samples inside a chunk.
- K3's row formulation ``bake_row`` equals the per-voxel ``bake_voxel``,
  bitwise, on a 20 x 28 x 36 grid, for four sun directions, with early-out
  on and off, on both texture types.
- Both match the plain PyTorch versions within the tolerances of
  ``test_torch_cuda_kernels.py``: glibc's ``expf``/``logf``/``sinf``/
  ``cosf`` are not torch's, so step counts agree on >= 99 % of pixels
  (mean within 1e-5, m2 within 1e-4 of their largest values there) and the
  bake within 1e-5 (quantized values on all but 0.1 % of voxels).  The
  path tracer is held there at ``max_depth`` 10: over tens of bounces the
  ulps of the two libraries' direction samples move NEE taps with the
  step counts still equal (measured at ``max_depth`` 40 in the
  multiple-scatter mode: 9.2e-5 of the image's largest mean, on 2 of 1,024
  pixels, with 45 and 88 bounces).

Skips only where g++ is absent.
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from deepestscatter_tpu_torch import build_scene, config, cuda_build, with_baked_inscatter
from deepestscatter_tpu_torch.data import procedural
from deepestscatter_tpu_torch.render import camera, inscatter, pathtracer

HOST_SOURCE = Path(__file__).with_name("torch_kernel_host.cpp")
PIXELS = 32
SAMPLES = 3
SEED = 5


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (the host build of the kernels' device functions)")
    out = tmp_path_factory.mktemp("kernel_host") / "libkernel_host.so"
    proc = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
         "-DDS_HOST_EMULATION", "-D__device__=", "-D__forceinline__=inline",
         f"-I{cuda_build.CSRC}", "-o", str(out), str(HOST_SOURCE)],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out))
    lib.host_set_pathtrace.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.host_set_bake.argtypes = [ctypes.c_int]
    return lib


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _host_stream(monkeypatch):
    monkeypatch.setattr(cuda_build, "stream_handle", lambda: ctypes.c_void_p(None))


@pytest.fixture(scope="module", params=["uint8", "float32"])
def pt_rig(request):
    """The 24^3 cumulus of seed 11 at 2000 m, 32 x 32 pixels, step 1/64,
    max_depth 40, baked on the CPU; and its rays."""
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        camera=config.CameraConfig(width=PIXELS, height=PIXELS),
        rendering=config.CloudRendering(
            march_dtype=request.param, sample_step=1.0 / 64.0, max_depth=40),
    )
    params, static = build_scene(cfg, procedural.cumulus(24, seed=11), device="cpu")
    params = with_baked_inscatter(params, static, device="cpu")
    o, d = camera.generate_rays(camera.camera_basis(cfg.camera), PIXELS, PIXELS, "cpu")
    hit, t_hit = camera.intersect_box(o, d, static, params.bbox_size)
    entry = camera.entry_points(o, d, t_hit, params.bbox_size)
    return params, static, (entry, d, hit, torch.arange(o.shape[0]))


def _pt(lib, params, static, rays, mode, lookahead=0, order=None, max_steps=None):
    lib.host_set_pathtrace(mode, lookahead, None if order is None else order.ctypes.data)
    return pathtracer._launch(params, static, *rays, SEED, 1, SAMPLES, max_steps, lib=lib)


def _assert_equal(got, ref):
    for name, a, b in zip(ref._fields, got, ref):
        assert torch.equal(a, b), name


def _shuffled(rays, seed):
    n = rays[0].shape[0] * SAMPLES
    return np.random.default_rng(seed).permutation(n).astype(np.int64)


@pytest.mark.parametrize("mode", list(config.RenderMode))
def test_k4_items_in_any_order_equal_the_pixel_loop(host_lib, pt_rig, mode):
    params, static, rays = pt_rig
    static = dataclasses.replace(static, mode=mode)
    ref = _pt(host_lib, params, static, rays, 0)
    assert int(ref.bounces.sum()) > 0 and bool((~rays[2]).any())
    # lookahead 0: the kernel's.
    for lookahead, order in ((0, None), (0, _shuffled(rays, 1)), (1, _shuffled(rays, 2))):
        _assert_equal(_pt(host_lib, params, static, rays, 1, lookahead, order), ref)


def test_k4_lookahead_equals_stepwise_with_a_cap_inside_a_chunk(host_lib, pt_rig):
    """27 steps a sample: not a multiple of the kernel's lookahead."""
    params, static, rays = pt_rig
    full = _pt(host_lib, params, static, rays, 0)
    ref = _pt(host_lib, params, static, rays, 0, max_steps=27)
    assert bool((ref.steps < full.steps).any())  # the cap cut samples
    assert int(ref.steps.max()) <= SAMPLES * 27
    order = _shuffled(rays, 3)
    for lookahead in (1, 0):
        _assert_equal(_pt(host_lib, params, static, rays, 1, lookahead, order, 27), ref)


@pytest.mark.parametrize("mode", list(config.RenderMode))
def test_k4_host_build_matches_plain(host_lib, pt_rig, mode):
    params, static, rays = pt_rig
    static = dataclasses.replace(static, mode=mode, max_depth=10)
    got = _pt(host_lib, params, static, rays, 1, order=_shuffled(rays, 4))
    ref = pathtracer.scatter_loop_plain(params, static, *rays, SEED, 1, SAMPLES)
    assert torch.equal(got.count, ref.count)
    same = got.steps == ref.steps
    assert same.float().mean().item() >= 0.99
    for a, b, tol in ((got.mean, ref.mean, 1e-5), (got.m2, ref.m2, 1e-4)):
        assert (a - b)[same].abs().max().item() <= tol * (b.abs().max().item() + 1e-12)


#: Sun directions (pointing from the sun): the default, one along an axis,
#: one with every component negative, one of mixed signs.
LIGHTS = {
    "default": config.DirectionalLight().direction,
    "axis": (0.0, -1.0, 0.0),
    "negative": (-0.3, -0.45, -0.84),
    "mixed": (0.48, -0.6, 0.64),
}


@pytest.fixture(scope="module", params=["uint8", "float32"])
def bake_density(request):
    """A 20 x 28 x 36 ([Z, Y, X]) grid of smooth random density (marched
    at step 1/128, about a third of a cell)."""
    rng = np.random.default_rng(7)
    raw = rng.random((20, 28, 36)).astype(np.float32)
    smooth = (raw + np.roll(raw, 1, 0) + np.roll(raw, 1, 1) + np.roll(raw, 1, 2)) / 4.0
    return request.param, np.clip(smooth * 1.5 - 0.5, 0.0, None).astype(np.float32)


@pytest.mark.parametrize("early_out", [True, False], ids=["early_out", "full"])
@pytest.mark.parametrize("light", list(LIGHTS))
def test_k3_row_equals_voxel(host_lib, bake_density, light, early_out):
    dtype, density = bake_density
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        light=config.DirectionalLight(direction=LIGHTS[light]),
        rendering=config.CloudRendering(march_dtype=dtype, sample_step=1.0 / 128.0),
    )
    params, static = build_scene(cfg, density, device="cpu")
    assert static.grid_shape == (20, 28, 36)
    host_lib.host_set_bake(0)
    ref = inscatter._launch(params, static, early_out, lib=host_lib)
    host_lib.host_set_bake(1)
    got = inscatter._launch(params, static, early_out, lib=host_lib)
    assert torch.equal(got, ref)
    if early_out:  # the early-out fires
        assert bool((got * 255.0 < 1.0).any())
    plain = inscatter.sun_transmittance_plain(params, static, early_out)
    assert (got - plain).abs().max().item() <= 1e-5
    q = lambda t: torch.floor(t * 255.0) / 255.0  # noqa: E731
    assert (q(got) != q(plain)).float().mean().item() <= 1e-3
