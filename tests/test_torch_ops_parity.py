"""Parity of the PyTorch port's scene-free ops with the JAX package on the
CPU: procedural cloud, hash, mip pyramid, phase table, light frame and
the RPNN forward on converted weights (the ops that sample a scene are
tested in test_torch_slice_parity.py, which builds the scenes once).

Inputs are made with numpy from fixed seeds and fed to both frameworks.
Stated tolerances: bitwise for the cloud, the hash and the mip pyramid;
rtol 1e-6 for the phase lerp; atol 1e-6 for the light frame; rtol 1e-4
for the RPNN forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepestscatter_tpu.data import procedural as jproc
from deepestscatter_tpu.models.rpnn import DisneyModel as JaxDisneyModel
from deepestscatter_tpu.ops import descriptor as jdesc
from deepestscatter_tpu.ops import grid as jgrid
from deepestscatter_tpu.ops import phase as jphase
from deepestscatter_tpu.ops import rng as jrng
from deepestscatter_tpu_torch.data import procedural as tproc
from deepestscatter_tpu_torch.models.convert import disney_from_flax
from deepestscatter_tpu_torch.models.rpnn import DisneyModel, init_disney_model
from deepestscatter_tpu_torch.ops import descriptor as tdesc
from deepestscatter_tpu_torch.ops import grid as tgrid
from deepestscatter_tpu_torch.ops import phase as tphase
from deepestscatter_tpu_torch.ops import rng as trng


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_procedural_cloud_is_the_same_grid():
    np.testing.assert_array_equal(
        jproc.cumulus(resolution=20, seed=5), tproc.cumulus(resolution=20, seed=5)
    )


@pytest.mark.parametrize("counter", [0, 1, 7, 2**32 - 1])
def test_hash_bitwise(counter):
    rng = np.random.default_rng(counter % 1000)
    streams = np.concatenate(
        [
            rng.integers(0, 2**32, 256, dtype=np.uint64),
            np.asarray([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint64),
        ]
    )
    for seed in (0, 3, 2**31 + 5, 2**32 - 1):
        ref = np.asarray(
            jrng.hash_u32(
                jnp.uint32(seed), jnp.asarray(streams.astype(np.uint32)), jnp.uint32(counter)
            )
        )
        got = trng.hash_u32(seed, torch.from_numpy(streams.astype(np.int64)), counter)
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
        ref_u = np.asarray(
            jrng.hash_uniform(
                jnp.uint32(seed), jnp.asarray(streams.astype(np.uint32)), jnp.uint32(counter)
            )
        )
        got_u = trng.hash_uniform(seed, torch.from_numpy(streams.astype(np.int64)), counter)
        np.testing.assert_array_equal(got_u.numpy().view(np.uint32), ref_u.view(np.uint32))


def test_hash_accepts_uint32_tensors():
    ids = torch.tensor([0, 2**31, 2**32 - 1], dtype=torch.int64)
    np.testing.assert_array_equal(
        trng.hash_u32(1, ids.to(torch.uint32), 0).numpy(), trng.hash_u32(1, ids, 0).numpy()
    )


def test_build_mipmaps_bitwise():
    grid = np.random.default_rng(2).random((9, 6, 13)).astype(np.float32)
    ref = jgrid.build_mipmaps(grid)
    got = tgrid.build_mipmaps(grid)
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_eval_phase_pair():
    jt = jphase.load_phase_table()
    tt = tphase.load_phase_table("cpu")
    np.testing.assert_array_equal(tt.eval_rows.numpy(), np.asarray(jt.eval_rows))
    c = np.random.default_rng(4).uniform(-1.0, 1.0, 4096).astype(np.float32)
    c[:3] = (-1.0, 1.0, 0.0)
    jm, jc = jphase.eval_phase_pair(jt, jnp.asarray(c))
    tm, tc = tphase.eval_phase_pair(tt, torch.from_numpy(c))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=0)


def _points(seed, n):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    view = rng.normal(size=(n, 3)).astype(np.float32)
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    return pos, view


def test_light_frame_and_omega():
    jl = np.asarray([-0.586, -0.766, -0.271], np.float32)
    _, view = _points(7, 64)
    ref = jdesc.light_frame(jnp.asarray(jl), jnp.asarray(view))
    got = tdesc.light_frame(torch.from_numpy(jl), torch.from_numpy(view))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tdesc.omega_angle(torch.from_numpy(jl), torch.from_numpy(view)).numpy(),
        np.asarray(jdesc.omega_angle(jnp.asarray(jl), jnp.asarray(view))),
        rtol=0,
        atol=1e-6,
    )


def _flax_weights():
    model = JaxDisneyModel()
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 10, 226)))
    return model, variables


def test_disney_model_forward_on_converted_weights():
    jmodel, variables = _flax_weights()
    tmodel = DisneyModel()
    tmodel.load_state_dict(disney_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    x = np.random.default_rng(9).random((64, 10, 226)).astype(np.float32)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (64, 1)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_convert_transposes_every_kernel():
    _, variables = _flax_weights()
    flax = jax.tree_util.tree_map(np.asarray, variables)["params"]
    sd = disney_from_flax(flax)
    assert set(sd) == set(DisneyModel().state_dict())
    np.testing.assert_array_equal(
        sd["blocks.3.f1z.weight"].numpy(), flax["block_3"]["f1z"]["kernel"].T
    )
    np.testing.assert_array_equal(sd["fc2.bias"].numpy(), flax["fc2"]["bias"])


def test_init_disney_model_is_seeded():
    a = init_disney_model(566, device="cpu").state_dict()
    b = init_disney_model(566, device="cpu").state_dict()
    c = init_disney_model(567, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fc0.weight"], c["fc0.weight"])
