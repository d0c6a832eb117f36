"""K9 (the slab march, ``csrc/spatial.cu``) on the host: the kernel's
groups of G lanes a ray against its first design and the plain version.

``tests/torch_kernel_host.cpp`` (built as ``test_torch_kernel_host.py``
builds it) runs ``ds::spatial::ray_phase<G>``, the kernel's group of G
lanes on one ray with a chunk's lanes emulated one after the other (G = 1:
a lane of one thread marching K4's lookahead), or ``phase_ray``, the first
design, a ray at a time.  Phase by phase on 1, 2 and 4 z-slabs of the 24^3
cumulus of seed 11 (32 x 32 pixels, step 1/64, ``max_depth`` 40), in the
three render modes, on uint8 and float32 textures, at G = 1, 8 and 32:

- every slab's records equal the first design's on all 16 columns
  (``torch.equal``), the records carried from phase to phase by the masked
  sum of ``spatial_render.merge_slabs``;
- the plain version ``spatial_phase_plain`` on the same inputs takes the
  same decisions (depth, alive, touched, steps equal) and the rest lies
  within 1e-5 of each column's largest value (at least 1) on 2 and 4 slabs
  (16 and 32 steps a phase), within 1e-4 on one slab (64 steps a phase):
  glibc's ``expf``/``logf``/``sinf``/``cosf`` are not torch's, and over a
  phase of 64 steps the transmittance's products part by more than 1e-5;
- on several slabs, fresh rays whose first step is another slab's are
  left as they came in (touched and steps zeroed);
- a budget of 13 steps a phase, which ends inside the chunks of 8 and 32
  lanes (and of K4's lookahead of 2), changes nothing of the above, and
  rays do use it up.

Skips only where g++ is absent.
"""

import ctypes
import dataclasses

import pytest
import torch

from deepestscatter_tpu_torch import config
from deepestscatter_tpu_torch.ops import rng as rng_ops
from deepestscatter_tpu_torch.parallel import spatial_render as sr

from test_torch_kernel_host import SEED, _host_stream, _torch_threads, host_lib, pt_rig  # noqa: F401

LANES = (1, 8, 32)
#: A budget that ends inside every chunk form's chunk (lookahead 2, 8 and
#: 32 lanes).
ODD_BUDGET = 13
#: The plain version's values against the host build's, of each column's
#: largest, by slab count (the steps a phase: 64, 32, 16).
PLAIN_TOL = {1: 1e-4, 2: 1e-5, 4: 1e-5}


@pytest.fixture(scope="module")
def k9_lib(host_lib):
    host_lib.host_set_spatial.argtypes = [ctypes.c_int, ctypes.c_int]
    yield host_lib
    host_lib.host_set_spatial(1, 1)


def _phase(lib, scene, st, seed, ids, spp, rec, design, lanes=1):
    lib.host_set_spatial(design, lanes)
    return sr._launch(scene, st, seed, ids, spp, rec, lib=lib)


def _check_phases(lib, params, static, rays, n_slabs, spp=None) -> dict:
    """A subframe's phases on ``n_slabs`` slabs: each slab's records at
    every G of LANES against the first design's (bitwise) and the plain
    version's (decisions equal, the rest within PLAIN_TOL) → what was seen
    (phases, the largest step count, fresh rays left untouched)."""
    entry, d, hit, ids = rays
    st = sr.phase_static(static)
    scenes = [sr.slab_scene(params, i, n_slabs, device="cpu") for i in range(n_slabs)]
    spp = spp or sr.default_steps_per_phase(static, static.grid_shape[0] // n_slabs)
    seed = rng_ops.subframe_seed(SEED, 1)
    seen = dict(phases=0, longest=0, fresh_untouched=0)
    rec = sr.begin_records(entry, d, hit, params.bbox_size)
    while bool((rec[:, sr.ALIVE] != 0.0).any()):
        outs = []
        for s in scenes:
            first = _phase(lib, s, st, seed, ids, spp, rec, 0)
            for g in LANES:
                got = _phase(lib, s, st, seed, ids, spp, rec, 1, g)
                assert torch.equal(got, first), f"G={g}, phase {seen['phases']}"
            plain = sr.spatial_phase_plain(s, st, seed, ids, spp, rec)
            assert torch.equal(plain[:, sr.DEPTH:], first[:, sr.DEPTH:])
            scale = first.abs().amax(dim=0).clamp(min=1.0)
            assert ((plain - first).abs() / scale).max().item() <= PLAIN_TOL[n_slabs]
            fresh = (rec[:, sr.ALIVE] != 0.0) & (rec[:, sr.DEPTH] == 0.0)
            left = fresh & (first[:, sr.TOUCHED] == 0.0)
            assert torch.equal(first[left, :sr.TOUCHED], rec[left, :sr.TOUCHED])
            assert not bool(first[left, sr.TOUCHED:].any())
            seen["fresh_untouched"] += int(left.sum())
            seen["longest"] = max(seen["longest"], int(first[:, sr.STEPS].max()))
            outs.append(first)
        rec = sr.merge_slabs(outs)
        seen["phases"] += 1
    return seen


@pytest.mark.parametrize("n_slabs", [1, 2, 4])
@pytest.mark.parametrize("mode", list(config.RenderMode))
def test_k9_groups_equal_the_first_design(k9_lib, pt_rig, mode, n_slabs):
    params, static, rays = pt_rig
    static = dataclasses.replace(static, mode=mode)
    seen = _check_phases(k9_lib, params, static, rays, n_slabs)
    assert seen["phases"] >= n_slabs
    if n_slabs > 1:
        assert seen["fresh_untouched"] > 0


def test_k9_groups_with_a_budget_inside_the_chunks(k9_lib, pt_rig):
    params, static, rays = pt_rig
    seen = _check_phases(k9_lib, params, static, rays, 2, spp=ODD_BUDGET)
    assert seen["longest"] == ODD_BUDGET and ODD_BUDGET % 2 and seen["phases"] > 2
