"""Parity of the port's row-gather probe (P1, P2, ``probes/gather.py``)
with ``tools/pallas_gather_probe.py`` on the CPU, through the kernels'
plain versions (the wrappers' CPU path).

- P2 against the Pallas ``coalesced`` kernel run in interpret mode at
  ``nrows`` 256, width 1024 B, batch 1024, ``run`` 32, on the tool's own
  padded index layout: rtol 1e-6.  The port sums the bytes exactly in
  integers and rounds once to float32; the Pallas kernel accumulates its
  blocks in float32, which rounds above 2^24.
- P1 against the tool's own reference sum (``jnp.take`` of the rows,
  summed in float32, ``pallas_gather_probe.py:174-183``): rtol 1e-6.  The
  Pallas ``per_lane`` kernel in interpret mode takes tens of seconds per
  tile here, too slow for these tests.
- The index layouts and the wrappers' argument checks exactly.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepestscatter_tpu_torch.probes import gather

TOOL = Path(__file__).resolve().parent.parent / "tools" / "pallas_gather_probe.py"


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("pallas_gather_probe", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_constants_match_the_tool(tool):
    assert gather.TILE == tool.TILE == 1024


def test_coalesced_matches_the_pallas_kernel(tool):
    nrows, width, batch, run = 256, 1024, 1024, 32
    rows, idx = gather.make_case("coalesced", nrows, width, batch, run=run, device="cpu")
    fn = tool.build("coalesced", nrows, width, batch, run=run, interpret=True)
    ref = np.asarray(fn(jnp.asarray(idx.numpy()), jnp.asarray(rows.numpy())))
    got = gather.coalesced(idx, rows, width, run)
    assert got.shape == ref.shape == (1, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("width", [16, 1024])
def test_per_lane_matches_the_tools_reference_sum(width):
    nrows, batch = 256, 4096
    rows, idx = gather.make_case("per_lane", nrows, width, batch, device="cpu")
    rows2d = jnp.asarray(rows.numpy()).reshape(nrows, width)
    want = (
        jnp.take(rows2d, jnp.asarray(idx.numpy()), axis=0)
        .astype(jnp.float32).sum(-1).reshape(-1, gather.TILE).sum(-1)
    )
    got = gather.per_lane(idx, rows, width)
    assert got.shape == (batch // gather.TILE, 1)
    np.testing.assert_allclose(got.numpy()[:, 0], np.asarray(want), rtol=1e-6, atol=0)


def test_plain_sums_are_exact():
    """Exact integer sums, rounded once: the kernel's int32 → float."""
    rows, idx = gather.make_case("coalesced", 512, 32, 2048, run=8, device="cpu")
    r = rows.numpy().reshape(512, 32).astype(np.int64)
    used = idx.numpy().reshape(2, 1024)[:, :128]
    want = [sum(int(r[s:s + 8].sum()) for s in u) for u in used]
    np.testing.assert_array_equal(gather.coalesced_plain(idx, rows, 32, 8).numpy()[:, 0],
                                  np.asarray(want, np.float32))


def test_index_layouts():
    rows, idx = gather.make_case("coalesced", 300, 16, 3072, run=32, device="cpu")
    lay = idx.numpy().reshape(3, 1024)
    assert idx.dtype == torch.int32 and rows.dtype == torch.uint8
    assert rows.shape == (300 * 16,) and int(rows.max()) < 255
    assert np.all(lay[:, 32:] == 0)  # padding: only 1024 / run entries count
    assert lay[:, :32].max() < 300 - 32
    _, idx = gather.make_case("per_lane", 300, 16, 3072, device="cpu")
    assert idx.shape == (3072,) and 0 <= int(idx.min()) and int(idx.max()) < 300
    # Seeded: the same case twice is the same case.
    a = gather.make_case("per_lane", 64, 16, 1024, device="cpu")
    b = gather.make_case("per_lane", 64, 16, 1024, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_launch_refuses_what_the_kernel_does_not_take():
    rows, idx = gather.make_case("per_lane", 64, 16, 1024, device="cpu")
    with pytest.raises(ValueError, match="multiple of 16"):
        gather._launch(idx, torch.zeros(64 * 24, dtype=torch.uint8), 24, 0)
    with pytest.raises(ValueError, match="int32"):
        gather._launch(idx.to(torch.int64), rows, 16, 0)
    with pytest.raises(ValueError, match="divide"):
        gather._launch(idx, rows, 16, 3)


def test_bounds_check_refuses_rows_outside_the_table():
    _, idx = gather.make_case("per_lane", 64, 16, 1024, device="cpu")
    gather._check_bounds(idx, 64, 0)
    with pytest.raises(ValueError, match="rows"):
        gather._check_bounds(idx, int(idx.max()), 0)
    _, cidx = gather.make_case("coalesced", 64, 16, 1024, run=8, device="cpu")
    gather._check_bounds(cidx, 64, 8)
    with pytest.raises(ValueError, match="rows"):
        gather._check_bounds(cidx, int(cidx.max()) + 7, 8)
