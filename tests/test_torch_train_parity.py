"""Parity of the PyTorch port's training slice with the JAX package on the
CPU: the log transform and loss, optax's amsgrad rule, the training
compositions (``BakedModel``, ``MimicModel``), Flax's initialisation rule,
the datasets, the device-resident batches (K10's plain version), the
``Trainer`` against the JAX ``Trainer``, and the port's own checkpoint,
resume, NaN-abort, validation-fallback and export contracts.

The stores are written by the port and read by both packages (one file
layout): 96 records of seeded numpy, as ``tests/test_device_train.py``
fills them.  Stated tolerances:

- ``LogTransform`` forward and inverse, and ``log_mse_loss``: rtol 1e-6
  (torch's and XLA's ``log``/``exp`` may differ by an ulp; the mean sums in
  another order);
- the amsgrad rule against ``optax.amsgrad`` over 10 steps: every update
  within 1e-6 of the learning rate (a relative 1e-6 of the rule's unit
  step) and the updates within a norm-relative 1e-6; ``mu``, ``nu`` and
  ``nu_max`` within a norm-relative 1e-6; the parameters within a relative
  1e-6 (absolute below 1).  Not bitwise: XLA contracts ``(1 - b1) g + b1
  mu`` into a fused multiply-add (pinned below), and the bias corrections'
  powers are numpy's against XLA's;
- ``BakedModel`` and ``MimicModel`` on converted Flax weights: rtol 1e-5,
  atol 1e-6 (the products sum in another order);
- ``flax_init``: every layer's standard deviation within 3 % of the JAX
  ``model.init``'s where a layer has at least 10,000 weights, within 4
  standard errors of the estimate where it has fewer (the 100- and
  200-weight output layers); every |w| <= 2 sigma; biases zero;
- the datasets' and the device batches' features: bitwise, except alpha,
  within 1e-5 modulo 2 pi plus two float32 ulps of its cosine times acos'
  slope (``alpha_angle``'s arccos amplifies an ulp near +-1);
- the ``Trainer`` against the JAX ``Trainer`` from the same converted
  initial weights over 10 steps: each step's train loss and validation
  loss within rtol 1e-4; the parameters within a norm-relative 1e-3, and
  every element within 2 lr x steps of JAX's (amsgrad's first step moves a
  weight by ~lr x sign(g): a gradient at rounding level may take the other
  sign in the other framework);
- the chunk step against sequential steps, and a resumed run against an
  uninterrupted one: bitwise.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepestscatter_tpu.config import TrainConfig as JaxTrainConfig
from deepestscatter_tpu.data import datasets as jdatasets
from deepestscatter_tpu.data.store import RecordStore as JaxStore
from deepestscatter_tpu.models import blocks as jblocks
from deepestscatter_tpu.models.probes import BakedModel as JaxBakedModel
from deepestscatter_tpu.models.probes import MimicModel as JaxMimicModel
from deepestscatter_tpu.models.rpnn import DisneyModel as JaxDisneyModel
from deepestscatter_tpu.train import device_data as jdd
from deepestscatter_tpu.train import trainer as jtrainer
from deepestscatter_tpu_torch import config as tconfig
from deepestscatter_tpu_torch.data import datasets as tdatasets
from deepestscatter_tpu_torch.data import procedural, records
from deepestscatter_tpu_torch.data.store import DatasetTriplet, RecordStore
from deepestscatter_tpu_torch.models import blocks as tblocks
from deepestscatter_tpu_torch.models import convert
from deepestscatter_tpu_torch.models.probes import (BakedModel, LightProbeModel, MimicModel,
                                                    ProbeRendererModel)
from deepestscatter_tpu_torch.models.rpnn import DisneyModel
from deepestscatter_tpu_torch.train import device_data as tdd
from deepestscatter_tpu_torch.train import entries
from deepestscatter_tpu_torch.train import trainer as ttrainer

N_RECORDS = 96
BATCH = 32
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _fill_store(store: RecordStore, n: int = N_RECORDS, seed: int = 4) -> None:
    """Every table the training pipelines read, from seeded numpy."""
    rng = np.random.default_rng(seed)
    n_scenes = -(-n // 32)
    setups = np.zeros(n_scenes, records.SCENE_SETUP)
    for i in range(n_scenes):
        light = rng.normal(size=3)
        setups[i] = (b"procedural:8:1", 2000.0, (light / np.linalg.norm(light)).astype(np.float32))
    store.table("SceneSetup").batch_append(0, setups)
    samples = np.zeros(n, records.SCATTER_SAMPLE)
    samples["scene_setup_id"] = np.arange(n) // 32
    samples["point"] = rng.random((n, 3)).astype(np.float32)
    view = rng.normal(size=(n, 3))
    samples["view_direction"] = (view / np.linalg.norm(view, axis=1, keepdims=True)).astype(
        np.float32)
    store.table("ScatterSample").batch_append(0, samples)
    results = np.zeros(n, records.RESULT)
    results["light_intensity"] = rng.random(n).astype(np.float32) * 3.0
    results["is_converged"] = (rng.random(n) > 0.25).astype(np.uint8)
    store.table("Result").batch_append(0, results)
    grids = np.zeros(n, records.DISNEY_DESCRIPTOR)
    grids["grid"] = rng.integers(0, 256, (n, 2250), dtype=np.uint8)
    store.table("DisneyDescriptor").batch_append(0, grids)
    sets = np.zeros(n, records.BAKED_INTERPOLATION_SET)
    for c in "abcd":
        sets[c]["grid"] = rng.integers(0, 256, (n, 2250), dtype=np.uint8)
        sets[c]["power"] = rng.random(n).astype(np.float32)
        direction = rng.normal(size=(n, 3))
        sets[c]["direction"] = (direction / np.linalg.norm(direction, axis=1, keepdims=True)
                                ).astype(np.float32)
        sets[c]["position"] = rng.random((n, 3)).astype(np.float32)
    store.table("BakedInterpolationSet").batch_append(0, sets)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A triplet whose train store holds the records and whose validation
    store is empty."""
    path = str(tmp_path_factory.mktemp("train_parity"))
    _fill_store(DatasetTriplet(path).train)
    return path


@pytest.fixture(scope="module")
def stores(root):
    return RecordStore(os.path.join(root, "Train")), JaxStore(os.path.join(root, "Train"))


def _config(path, **kw):
    kw = dict(dict(run_dir=str(path), batch_size=BATCH, val_batch_size=64, validate_every=2), **kw)
    return tconfig.TrainConfig(**kw)


def _alpha_close(got: np.ndarray, ref: np.ndarray) -> None:
    wrapped = np.abs((got - ref + np.pi) % (2.0 * np.pi) - np.pi)
    slope = 1.0 / np.sqrt(np.maximum(1.0 - np.cos(ref.astype(np.float64)) ** 2, 1e-12))
    assert np.all(wrapped <= 1e-5 + 2.4e-7 * slope)


def _items_equal(got: dict, ref: dict) -> None:
    assert set(got) == set(ref)
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.shape == r.shape and g.dtype == r.dtype, k
        if k == "alpha":
            _alpha_close(g, r)
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)


# -- leaf pieces ---------------------------------------------------------------


def test_log_transform_and_loss_match_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.random(500) * 5.0, rng.random(100) * 1e-3,
                        -rng.random(100) * 0.098, [0.0, -0.099, 1e-8]]).astype(np.float32)
    y = rng.random(x.shape[0]).astype(np.float32)
    ref = np.asarray(jblocks.LogTransform.forward(jnp.asarray(x)))
    got = tblocks.LogTransform.forward(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    ref_inv = np.asarray(jblocks.LogTransform.inverse(jnp.asarray(ref)))
    got_inv = tblocks.LogTransform.inverse(torch.from_numpy(ref.copy())).numpy()
    np.testing.assert_allclose(got_inv, ref_inv, rtol=1e-6, atol=1e-9)
    ref_loss = float(jtrainer.log_mse_loss(jnp.asarray(x), jnp.asarray(y)))
    got_loss = float(ttrainer.log_mse_loss(torch.from_numpy(x), torch.from_numpy(y)))
    assert got_loss == pytest.approx(ref_loss, rel=1e-6)


def _disney_shapes():
    return [tuple(p.shape) for p in DisneyModel().parameters()]


def _gradient_steps(steps: int, seed: int = 3):
    """Seeded gradients of the DisneyModel's shapes, their scales spread
    over six decades and changing from step to step."""
    rng = np.random.default_rng(seed)
    return [[(rng.normal(size=s) * 10.0 ** rng.uniform(-6, 0, size=s)).astype(np.float32)
             for s in _disney_shapes()] for _ in range(steps)]


def _optax_run(params, grads):
    tx = optax.amsgrad(LR)
    state = tx.init(params)
    update = jax.jit(tx.update)
    out = []
    for g in grads:
        u, state = update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, u)
        out.append(([np.asarray(x) for x in u], [np.asarray(x) for x in params]))
    return out, state[0]


def _flat(arrays) -> np.ndarray:
    return np.concatenate([np.asarray(x).ravel() for x in arrays])


def _norm_rel(got, ref) -> float:
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def test_amsgrad_matches_optax():
    grads = _gradient_steps(10)
    rng = np.random.default_rng(1)
    p0 = [rng.normal(size=s).astype(np.float32) for s in _disney_shapes()]
    ref, ref_state = _optax_run([jnp.asarray(p) for p in p0], grads)
    params = [torch.from_numpy(p.copy()) for p in p0]
    opt = ttrainer.AmsGrad(params, LR)
    for g, (ref_u, ref_p) in zip(grads, ref):
        u = opt.updates([torch.from_numpy(x) for x in g])
        with torch.no_grad():
            torch._foreach_add_(params, [v.view_as(p) for v, p in zip(u.split(opt.sizes), params)])
        ru, rp = _flat(ref_u), _flat(ref_p)
        assert np.abs(u.numpy() - ru).max() <= 1e-6 * LR
        assert _norm_rel(u.numpy(), ru) <= 1e-6
        gp = torch.cat([p.reshape(-1) for p in params]).numpy()
        assert np.all(np.abs(gp - rp) <= 1e-6 * np.maximum(np.abs(rp), 1.0))
    assert opt.count == int(ref_state.count) == 10
    for name in ("mu", "nu", "nu_max"):
        assert _norm_rel(getattr(opt, name).numpy(), _flat(getattr(ref_state, name))) <= 1e-6


def test_xla_contracts_the_first_moment():
    """Why the amsgrad tolerance is stated against the step's scale: on the
    CPU XLA computes optax's ``(1 - b1) g + b1 mu`` as one fused
    multiply-add, rounding once; the port (on the CPU and the card) rounds
    each product.  Where the two terms cancel, the relative error of ``mu``
    is not small, its error against lr stays below 1e-6."""
    grads = _gradient_steps(2)
    p0 = [np.zeros(s, np.float32) for s in _disney_shapes()]
    _, state = _optax_run([jnp.asarray(p) for p in p0], grads)
    g0, g1 = _flat(grads[0]), _flat(grads[1])
    c1, b1 = np.float32(0.1), np.float32(0.9)
    mu0 = c1 * g0
    fused = (np.float64(c1) * g1.astype(np.float64) + (b1 * mu0).astype(np.float64))
    assert np.array_equal(_flat(state.mu), fused.astype(np.float32))
    assert not np.array_equal(_flat(state.mu), c1 * g1 + b1 * mu0)


def test_amsgrad_step_applies_the_update():
    """``step`` adds ``updates`` to the parameters in place, each parameter
    its own slice of the flat vector."""
    grads = _gradient_steps(3, seed=9)
    p0 = [torch.ones(s) for s in _disney_shapes()]
    a, b = [p.clone() for p in p0], [p.clone() for p in p0]
    opt_a, opt_b = ttrainer.AmsGrad(a, LR), ttrainer.AmsGrad(b, LR)
    for g in grads:
        opt_a.step([torch.from_numpy(x) for x in g])
        u = opt_b.updates([torch.from_numpy(x) for x in g])
        for p, v in zip(b, u.split(opt_b.sizes)):
            p += v.view_as(p)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_torch_adam_amsgrad_is_not_the_optax_rule():
    """The fault the port's ``AmsGrad`` fixes: ``torch.optim.Adam(amsgrad=
    True)`` takes the maximum of the raw second moment, optax of the
    bias-corrected one, and the trajectories part."""
    grads = _gradient_steps(10)
    rng = np.random.default_rng(1)
    p0 = [rng.normal(size=s).astype(np.float32) for s in _disney_shapes()]
    ref, _ = _optax_run([jnp.asarray(p) for p in p0], grads)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    adam = torch.optim.Adam(params, lr=LR, amsgrad=True)
    worst = 0.0
    for g, (ref_u, _) in zip(grads, ref):
        before = [p.detach().clone() for p in params]
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x)
        adam.step()
        u = np.concatenate([(p.detach() - q).numpy().ravel() for p, q in zip(params, before)])
        worst = max(worst, _norm_rel(u, _flat(ref_u)))
    assert worst > 0.1


# -- the training compositions ---------------------------------------------------


def _baked_inputs(rng, b):
    return (rng.random((b, 4, 9, 225)).astype(np.float32),
            rng.random((b, 4)).astype(np.float32),
            rng.random((b, 3, 226)).astype(np.float32),
            rng.random(b).astype(np.float32) * np.pi,
            (rng.random(b).astype(np.float32) - 0.5) * 2 * np.pi)


def test_baked_and_mimic_models_match_flax():
    rng = np.random.default_rng(2)
    pd, pw, dd, om, al = _baked_inputs(rng, 6)
    jm = JaxBakedModel()
    variables = jm.init(jax.random.PRNGKey(3), *(jnp.asarray(x) for x in (pd, pw, dd, om, al)))
    ref = np.asarray(jm.apply(variables, *(jnp.asarray(x) for x in (pd, pw, dd, om, al))))
    tm = BakedModel()
    tm.load_state_dict(convert.baked_from_flax(variables), strict=True)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(x) for x in (pd, pw, dd, om, al))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)

    jm = JaxMimicModel()
    args = (pd[:, 0], dd, om, al)
    variables = jm.init(jax.random.PRNGKey(4), *(jnp.asarray(x) for x in args))
    ref = np.asarray(jm.apply(variables, *(jnp.asarray(x) for x in args)))
    tm = MimicModel()
    tm.load_state_dict(convert.mimic_from_flax(variables), strict=True)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(np.ascontiguousarray(x)) for x in args)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def _kernels(tree, prefix=""):
    """Flax Dense kernels and biases by torch-style name."""
    out = {}
    for k, v in tree.items():
        if "kernel" in v:
            out[prefix + k] = (np.asarray(v["kernel"]), np.asarray(v["bias"]))
        else:
            out.update(_kernels(v, prefix + k + "/"))
    return out


@pytest.mark.parametrize("which", ["disney", "baked"])
def test_flax_init_matches_the_flax_rule(which):
    if which == "disney":
        jm, args, tm = JaxDisneyModel(), (jnp.zeros((1, 10, 226)),), DisneyModel()
    else:
        jm, tm = JaxBakedModel(), BakedModel()
        args = (jnp.zeros((1, 4, 9, 225)), jnp.zeros((1, 4)), jnp.zeros((1, 3, 226)),
                jnp.zeros((1,)), jnp.zeros((1,)))
    jk = _kernels(jm.init(jax.random.PRNGKey(566), *args)["params"])
    tm = tblocks.flax_init(tm, 566, "cpu")
    linears = [m for m in tm.modules() if isinstance(m, torch.nn.Linear)]
    assert len(linears) == len(jk)
    jstd = sorted((k.shape[0], k.shape[1], float(k.std())) for k, _ in jk.values())
    tstd = sorted((m.in_features, m.out_features, float(m.weight.detach().std())) for m in linears)
    for (fi, fo, js), (ti, to, ts) in zip(jstd, tstd):
        assert (fi, fo) == (ti, to)
        n = fi * fo
        tol = 0.03 if n >= 10_000 else 4.0 * np.sqrt(2.0 * 1.4 / (4.0 * n))
        assert abs(ts / js - 1.0) <= tol, (fi, fo, ts, js)
    for m in linears:
        sigma = np.sqrt(1.0 / m.in_features) / tblocks.TRUNCATED_NORMAL_STD
        assert float(m.weight.detach().abs().max()) <= 2.0 * sigma * (1 + 1e-6)
        assert not m.bias.any()
    for _, bias in jk.values():
        assert not bias.any()


# -- datasets and device batches --------------------------------------------------


@pytest.mark.parametrize("kind", ["disney", "baked"])
def test_dataset_batches_match_jax(stores, kind):
    tstore, jstore = stores
    tcls, jcls = {"disney": (tdatasets.DisneyDataset, jdatasets.DisneyDataset),
                  "baked": (tdatasets.BakedDataset, jdatasets.BakedDataset)}[kind]
    tds, jds = tcls(tstore), jcls(jstore)
    assert len(tds) == len(jds) == N_RECORDS
    got = list(tds.batches(BATCH, seed=566))
    ref = list(jds.batches(BATCH, seed=566))
    assert len(got) == len(ref) == N_RECORDS // BATCH
    for (gi, gl), (ri, rl) in zip(got, ref):
        _items_equal(gi, ri)
        np.testing.assert_array_equal(gl, rl)


def test_epoch_schedule_bitwise():
    pool = np.arange(1000)[np.random.default_rng(5).random(1000) > 0.2]
    for epoch in range(3):
        got = tdd.epoch_schedule(pool, 64, 566, epoch)
        ref = jdd.epoch_schedule(pool, 64, 566, epoch)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("kind", ["disney", "baked"])
def test_device_batches_match_jax_and_the_host_dataset(stores, kind):
    tstore, jstore = stores
    if kind == "disney":
        tdev, jdev = tdd.DeviceDisneyData(tstore, device="cpu"), jdd.DeviceDisneyData(jstore)
        host = tdatasets.DisneyDataset(tstore)
    else:
        tdev, jdev = tdd.DeviceBakedData(tstore, device="cpu"), jdd.DeviceBakedData(jstore)
        host = tdatasets.BakedDataset(tstore)
    np.testing.assert_array_equal(tdev.pool(), jdev.pool())
    idx = np.sort(np.random.default_rng(6).permutation(tdev.pool())[:40])
    got, glab = tdev.assemble(torch.from_numpy(idx))
    ref, rlab = jdev.assemble(jnp.asarray(idx.astype(np.int32)))
    got = {k: v.numpy() for k, v in got.items()}
    _items_equal(got, {k: np.asarray(v) for k, v in ref.items()})
    np.testing.assert_array_equal(glab.numpy(), np.asarray(rlab))
    item_h, labels_h, ok_h = host._gather(idx)
    _items_equal(got, item_h)
    np.testing.assert_array_equal(glab.numpy(), labels_h)
    assert ok_h.all()


def test_assemble_wrappers_run_the_plain_version_on_the_cpu(stores):
    """On CPU tensors the wrappers run the plain version (no launch);
    ``assemble_plain`` is that version."""
    tstore, _ = stores
    before = (tdd.assemble_disney.launches, tdd.assemble_baked.launches)
    idx = torch.arange(0, N_RECORDS, 3)
    for cls in (tdd.DeviceDisneyData, tdd.DeviceBakedData):
        data = cls(tstore, device="cpu")
        a, la = data.assemble(idx)
        b, lb = data.assemble_plain(idx)
        assert all(torch.equal(a[k], b[k]) for k in a) and torch.equal(la, lb)
    assert (tdd.assemble_disney.launches, tdd.assemble_baked.launches) == before


# -- the trainer -------------------------------------------------------------------


def _metrics(run_dir, tag):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [(r["step"], r["value"]) for r in rows if r["tag"] == tag]


def test_trainer_tracks_the_jax_trainer(stores, tmp_path):
    """Both trainers on the device path from the same (converted) initial
    weights, validating every step: 5 epochs of 2 steps."""
    tstore, jstore = stores
    jm = JaxDisneyModel()
    variables = jm.init(jax.random.PRNGKey(566), jnp.zeros((1, 10, 226)))
    jdev = jdd.DeviceDisneyData(jstore)
    jt = jtrainer.Trainer(
        name="DisneyModel", apply_fn=lambda p, b: jm.apply(p, b["z_layers"]),
        init_params=variables, train_batches=lambda e: iter(()), val_batch=lambda: None,
        config=JaxTrainConfig(run_dir=str(tmp_path / "jax"), batch_size=BATCH,
                              val_batch_size=64, validate_every=1),
        device_data=jdev, val_device_data=jdev,
    )
    jt.run(epochs=5)
    model = DisneyModel()
    model.load_state_dict(convert.disney_from_flax(variables), strict=True)
    tdev = tdd.DeviceDisneyData(tstore, device="cpu")
    tt = ttrainer.Trainer(
        name="DisneyModel", model=model, apply_fn=lambda m, b: m(b["z_layers"]),
        train_batches=lambda e: iter(()), val_batch=lambda: None,
        config=_config(tmp_path / "torch", validate_every=1), device_data=tdev,
        val_device_data=tdev, device="cpu",
    )
    tt.run(epochs=5)
    assert tt.step == int(jt.state.step) == 10
    for tag in ("train_loss", "val_loss"):
        got = _metrics(tt.run_dir, tag)
        ref = _metrics(jt.run_dir, tag)
        assert [s for s, _ in got] == [s for s, _ in ref] == list(range(1, 11))
        np.testing.assert_allclose([v for _, v in got], [v for _, v in ref], rtol=1e-4)
    ref_p = convert.disney_from_flax(jt.state.params)
    got_p = tt.model.state_dict()
    a = torch.cat([got_p[k].reshape(-1) for k in ref_p])
    b = torch.cat([ref_p[k].reshape(-1) for k in ref_p])
    assert float(torch.linalg.norm(a - b) / torch.linalg.norm(b)) <= 1e-3
    assert float((a - b).abs().max()) <= 2 * LR * 10


def test_chunk_step_equals_sequential_steps(stores):
    tstore, _ = stores
    data = tdd.DeviceDisneyData(tstore, device="cpu")
    sched = torch.from_numpy(tdd.epoch_schedule(data.pool(), 16, 566, 0)[:4]).long()
    apply_fn = lambda m, b: m(b["z_layers"])  # noqa: E731
    init = tblocks.flax_init(DisneyModel(), 566, "cpu")
    runs = []
    for chunked in (False, True):
        model = DisneyModel()
        model.load_state_dict(init.state_dict())
        opt = ttrainer.AmsGrad(list(model.parameters()), LR)
        if chunked:
            losses = ttrainer.chunk_step(model, opt, apply_fn, data.assemble, sched)
        else:
            losses = torch.stack([ttrainer.train_step(model, opt, apply_fn, *data.assemble(i))
                                  for i in sched])
        runs.append((losses, ttrainer.flat_params(model), opt.count))
    (la, pa, ca), (lb, pb, cb) = runs
    assert torch.equal(la, lb) and torch.equal(pa, pb) and ca == cb == 4


@pytest.mark.parametrize("device_resident", [False, True])
def test_resume_continues_the_uninterrupted_run(root, tmp_path, device_resident):
    """Stopped after 2 epochs and restored into a fresh trainer, the run
    reaches the uninterrupted run's parameters, optimizer state, step and
    best validation loss, bitwise."""
    whole = entries.train_disney(root, _config(tmp_path / "whole"), epochs=4,
                                 device_resident=device_resident, device="cpu")
    first = entries.train_disney(root, _config(tmp_path / "cut"), epochs=2,
                                 device_resident=device_resident, device="cpu")
    assert first.step == whole.step // 2
    resumed = entries.disney_trainer(root, _config(tmp_path / "cut"),
                                     device_resident=device_resident, device="cpu")
    assert resumed.restore() and resumed.step == first.step
    resumed.run(epochs=4)
    assert resumed.step == whole.step
    assert torch.equal(ttrainer.flat_params(resumed.model), ttrainer.flat_params(whole.model))
    for k in ("mu", "nu", "nu_max"):
        assert torch.equal(getattr(resumed.opt, k), getattr(whole.opt, k))
    assert resumed.opt.count == whole.opt.count and resumed.best_val == whole.best_val


def test_checkpoints_hold_the_full_state(root, tmp_path):
    t = entries.train_disney(root, _config(tmp_path, validate_every=1), epochs=1, device="cpu")
    st = torch.load(t.checkpoint_path(), weights_only=True)
    assert set(st) == {"params", "opt_state", "step", "best_val"}
    assert st["step"] == t.step and st["opt_state"]["count"] == t.step
    best = torch.load(t.checkpoint_path(best=True), weights_only=True)
    export = torch.load(os.path.join(t.run_dir, "DisneyModel.pt"), weights_only=True)
    assert set(best) == set(export) == set(DisneyModel().state_dict())
    assert not [f for f in os.listdir(t.run_dir) if f.endswith(".tmp")]


@pytest.mark.parametrize("device_resident", [False, True])
def test_nan_loss_aborts(stores, tmp_path, device_resident):
    tstore, _ = stores
    model = tblocks.flax_init(DisneyModel(), 566, "cpu")
    data = tdd.DeviceDisneyData(tstore, device="cpu")
    data.labels = torch.full_like(data.labels, float("nan"))
    item, labels = data.assemble(torch.arange(BATCH))
    t = ttrainer.Trainer(
        name="DisneyModel", model=model, apply_fn=lambda m, b: m(b["z_layers"]),
        train_batches=lambda e: iter([(item, labels)]), val_batch=lambda: (item, labels),
        config=_config(tmp_path, validate_every=1),
        device_data=data if device_resident else None,
        val_device_data=data if device_resident else None, device="cpu",
    )
    with pytest.raises(FloatingPointError, match="loss is nan"):
        t.run(epochs=1)


@pytest.mark.parametrize("device_resident", [False, True])
def test_empty_validation_store_falls_back_to_train(root, tmp_path, capsys, device_resident):
    triplet = DatasetTriplet(root)
    assert triplet.validation.count("Result") == 0
    t = entries.train_disney(root, _config(tmp_path), epochs=2,
                             device_resident=device_resident, device="cpu")
    assert "WARNING: validation store has no complete labels" in capsys.readouterr().out
    assert np.isfinite(t.best_val) and t.step > 0


def test_baked_exports_load_into_the_renderer(root, tmp_path):
    """``train_baked``'s split export loads into ``BakedRenderer``'s two
    models with strict=True, and the renderer makes a finite frame."""
    from deepestscatter_tpu_torch import BakedRenderer, build_scene, with_baked_inscatter
    from deepestscatter_tpu_torch.render import camera as tcam

    t = entries.train_baked(root, _config(tmp_path), epochs=1, device_resident=True,
                            device="cpu")
    models = {}
    for name, cls in (("LightProbeModel", LightProbeModel),
                      ("ProbeRendererModel", ProbeRendererModel), ("BakedModel", BakedModel)):
        models[name] = cls()
        models[name].load_state_dict(
            torch.load(os.path.join(t.run_dir, f"{name}.pt"), weights_only=True), strict=True)
    for sub, name in ((t.model.light_probe_model, "LightProbeModel"),
                      (t.model.renderer_model, "ProbeRendererModel")):
        for k, v in sub.state_dict().items():
            assert torch.equal(models[name].state_dict()[k], v)
    cfg = tconfig.SceneConfig(cloud=tconfig.CloudModel(size_m=200.0),
                              camera=tconfig.CameraConfig(width=8, height=4))
    params, static = build_scene(cfg, procedural.cumulus(8, seed=1), device="cpu")
    params = with_baked_inscatter(params, static, device="cpu")
    renderer = BakedRenderer(params, static, models["LightProbeModel"].eval(),
                             models["ProbeRendererModel"].eval(), device="cpu")
    frame = renderer.render_frame(params, static, 8, 4, tcam.camera_basis(cfg.camera), seed=1)
    assert frame.shape == (4, 8, 3) and bool(torch.isfinite(frame).all())


def test_train_mimic_runs(tmp_path):
    path = str(tmp_path / "mimic")
    triplet = DatasetTriplet(path)
    _fill_store(triplet.train)
    _fill_store(triplet.validation, seed=8)
    t = entries.train_mimic(path, _config(tmp_path), epochs=1, device="cpu")
    assert t.step == N_RECORDS // BATCH and np.isfinite(t.best_val)
