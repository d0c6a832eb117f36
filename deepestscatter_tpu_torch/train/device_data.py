"""Device-resident training data: the record tables uploaded once, batches
assembled on the device from index vectors (K10, ``csrc/assemble.cu``).

The port of ``deepestscatter_tpu.train.device_data``.  The uint8
descriptor tables live on the card, sliced to the layers the models
consume before the upload (the RPNN's 10 of 10, the probes' 9 of 10 with
a row's four corners side by side, the realtime descriptor's 3 of 10), and
each step's batch is gathered from them by an index vector: per step the
host sends nothing but the chunk's ``[k, B]`` schedule.  The index pools
hold converged labels only (the reference asserts convergence per item,
DisneyDataset.py:41), so batches keep their size.

``assemble_disney`` and ``assemble_baked`` are K10's wrappers: on CUDA
tensors they launch the kernel (counted in ``.launches``), on CPU tensors
they run ``assemble_disney_plain`` / ``assemble_baked_plain``
(``index_select``, ``float``, ``true_div`` by 256, ``cat``), which the
kernel equals bitwise.  The float features are those of
``data.datasets``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from .. import cuda_build
from ..data.datasets import _alpha, _omega
from ..data.store import RecordStore
from ..device import check_on, resolve_device
from ..models.probes import BAKED_LAYERS, REALTIME_LAYERS
from ..ops.grid import true_div

LAYER = 225


def _scene_lights(store: RecordStore, scene_ids: np.ndarray) -> np.ndarray:
    setups = store.table("SceneSetup")
    uniq = {int(s): setups.get_record(int(s))["light_direction"] for s in np.unique(scene_ids)}
    out = np.zeros((len(scene_ids), 3), np.float32)
    for i, s in enumerate(scene_ids):
        out[i] = uniq[int(s)]
    return out


def _dequantize(table: torch.Tensor, idx: torch.Tensor, layers: int) -> torch.Tensor:
    rows = table.index_select(0, idx)
    return true_div(rows.to(torch.float32), 256.0).reshape(idx.shape[0], -1, layers, LAYER)


def _with_omega(x: torch.Tensor, om: torch.Tensor) -> torch.Tensor:
    """[B, L, 225] layers with omega appended to each → [B, L, 226]."""
    return torch.cat([x, om[:, None, None].expand(x.shape[0], x.shape[1], 1)], dim=-1)


def _layers(name: str, table: torch.Tensor, per_layer: int) -> int:
    """The layers a row of ``table`` holds (its width over ``per_layer``)."""
    if table.dim() != 2 or table.shape[1] == 0 or table.shape[1] % per_layer:
        raise ValueError(f"{name} rows must hold whole layers of {per_layer} bytes, got "
                         f"{tuple(table.shape)}")
    return table.shape[1] // per_layer


def assemble_disney_plain(grids, omega, labels, idx):
    """Plain PyTorch version of K10's RPNN layout: z [B, L, 226] (the rows'
    L layers / 256, omega in column 225), labels [B]."""
    z = _dequantize(grids, idx, _layers("grids", grids, LAYER))[:, 0]
    return _with_omega(z, omega.index_select(0, idx)), labels.index_select(0, idx)


def assemble_baked_plain(probes, rt, powers, omega, alpha, labels, idx):
    """Plain PyTorch version of K10's baked layout → (probe descriptors [B, 4,
    Lb, 225], realtime descriptor [B, Lr, 226], powers [B, 4], omega,
    alpha, labels [B])."""
    om = omega.index_select(0, idx)
    p = _dequantize(probes, idx, _layers("probes", probes, 4 * LAYER))
    r = _with_omega(_dequantize(rt, idx, _layers("rt", rt, LAYER))[:, 0], om)
    return (p, r, powers.index_select(0, idx), om, alpha.index_select(0, idx),
            labels.index_select(0, idx))


def _require_table(name: str, t: torch.Tensor, per_layer: int) -> int:
    """The layers of a contiguous uint8 table; raises on any other."""
    if t.dtype != torch.uint8 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous uint8 table, got {t.dtype}")
    return _layers(name, t, per_layer)


def _require_rows(n: int, **vectors: torch.Tensor) -> None:
    for name, t in vectors.items():
        if t.dtype != torch.float32 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 table of {n} rows")


def _require_idx(idx: torch.Tensor) -> None:
    if idx.dtype != torch.int64 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"indices must be a contiguous int64 vector, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if idx.shape[0] >= 2**31:
        raise ValueError("K10 launches a block a row: fewer than 2^31 indices")


def _require_stage(row_bytes: int) -> None:
    """K10 stages a batch row in (static-limit) shared memory."""
    if row_bytes + 64 > 48 * 1024:
        raise ValueError(f"K10 stages a row in 48 KB of shared memory: {row_bytes} bytes")


def _entry(name: str, lib, argtypes):
    fn = getattr(lib or cuda_build.load("assemble"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


_VP, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _launch_disney(grids, omega, labels, idx, lib=None):
    """K10's RPNN layout on the inputs' device.  ``lib``: another library
    with the ``ds_assemble_disney`` entry point (the tests' host build)."""
    layers = _require_table("grids", grids, LAYER)
    n = grids.shape[0]
    _require_rows(n, omega=omega, labels=labels)
    _require_idx(idx)
    check_on(grids.device, omega, labels, idx)
    _require_stage(layers * LAYER)
    b = idx.shape[0]
    z = torch.empty((b, layers, LAYER + 1), dtype=torch.float32, device=grids.device)
    lab = torch.empty(b, dtype=torch.float32, device=grids.device)
    fn = _entry("ds_assemble_disney", lib, [_VP, _VP, _VP, _I64, _VP, _INT, _INT, _VP, _VP, _VP])
    p = cuda_build.ptr
    cuda_build.check(fn(p(grids), p(omega), p(labels), n, p(idx), b, layers, p(z), p(lab),
                        cuda_build.stream_handle()), "batch assembly kernel (RPNN)")
    assemble_disney.launches += 1
    return z, lab


def _launch_baked(probes, rt, powers, omega, alpha, labels, idx, lib=None):
    """K10's baked layout on the inputs' device (``lib`` as for
    ``_launch_disney``)."""
    probe_layers = _require_table("probes", probes, 4 * LAYER)
    rt_layers = _require_table("rt", rt, LAYER)
    n = probes.shape[0]
    if rt.shape[0] != n or powers.shape != (n, 4):
        raise ValueError("probes, rt and powers [n, 4] must hold the same rows")
    _require_rows(n, powers=powers, omega=omega, alpha=alpha, labels=labels)
    _require_idx(idx)
    check_on(probes.device, rt, powers, omega, alpha, labels, idx)
    _require_stage(probes.shape[1] + rt.shape[1])
    b, dev = idx.shape[0], probes.device
    p_out = torch.empty((b, 4, probe_layers, LAYER), dtype=torch.float32, device=dev)
    r_out = torch.empty((b, rt_layers, LAYER + 1), dtype=torch.float32, device=dev)
    pw_out = torch.empty((b, 4), dtype=torch.float32, device=dev)
    om_out, al_out, lab = (torch.empty(b, dtype=torch.float32, device=dev) for _ in range(3))
    fn = _entry("ds_assemble_baked", lib,
                [_VP] * 6 + [_I64, _VP, _INT, _INT, _INT] + [_VP] * 7)
    p = cuda_build.ptr
    cuda_build.check(
        fn(p(probes), p(rt), p(powers), p(omega), p(alpha), p(labels), n, p(idx), b,
           probe_layers, rt_layers, p(p_out), p(r_out), p(pw_out), p(om_out), p(al_out), p(lab),
           cuda_build.stream_handle()),
        "batch assembly kernel (baked)",
    )
    assemble_baked.launches += 1
    return p_out, r_out, pw_out, om_out, al_out, lab


def assemble_disney(grids, omega, labels, idx):
    """K10's RPNN layout: the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if grids.is_cuda:
        return _launch_disney(grids, omega, labels, idx)
    return assemble_disney_plain(grids, omega, labels, idx)


def assemble_baked(probes, rt, powers, omega, alpha, labels, idx):
    """K10's baked layout: the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if probes.is_cuda:
        return _launch_baked(probes, rt, powers, omega, alpha, labels, idx)
    return assemble_baked_plain(probes, rt, powers, omega, alpha, labels, idx)


#: Kernel launches so far (counted where K10 is launched, nowhere else).
assemble_disney.launches = 0
assemble_baked.launches = 0


def _upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


class DeviceDisneyData:
    """RPNN tables on ``device`` (the card unless the caller asks for the
    CPU; raises if there is no card) and their batches: z = [grid / 256,
    omega] per layer, labels = light_intensity (``DisneyDataset``)."""

    def __init__(self, store: RecordStore, device="cuda"):
        self.device = resolve_device(device)
        n = min(store.count("DisneyDescriptor"), store.count("Result"))
        grids = store.table("DisneyDescriptor").read(0, n)["grid"]
        samples = store.table("ScatterSample").read(0, n)
        results = store.table("Result").read(0, n)
        light = _scene_lights(store, samples["scene_setup_id"])
        view = samples["view_direction"].astype(np.float32)
        self.omega_h = _omega(light, view)
        self.labels_h = results["light_intensity"].astype(np.float32)
        self.converged = results["is_converged"].astype(bool)
        self.n = n
        self.grids = _upload(grids.reshape(n, -1), self.device)
        self.omega = _upload(self.omega_h, self.device)
        self.labels = _upload(self.labels_h, self.device)

    def pool(self) -> np.ndarray:
        return np.arange(self.n)[self.converged]

    def assemble(self, idx: torch.Tensor) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The batch of rows ``idx`` (K10) → ({"z_layers": [B, 10, 226]}, labels)."""
        z, lab = assemble_disney(self.grids, self.omega, self.labels, idx.to(torch.int64))
        return {"z_layers": z}, lab

    def assemble_plain(self, idx: torch.Tensor):
        z, lab = assemble_disney_plain(self.grids, self.omega, self.labels, idx.to(torch.int64))
        return {"z_layers": z}, lab


_BAKED_KEYS = ("probe_descriptors", "disney_descriptor", "probe_powers", "omega", "alpha")


class DeviceBakedData:
    """Baked-pipeline tables on ``device`` (the card unless the caller asks
    for the CPU; raises if there is no card) and their batches
    (``BakedDataset``): the 4 corners' first 9 descriptor layers, their
    powers, the 3-layer realtime descriptor with omega, omega, alpha."""

    def __init__(self, store: RecordStore, device="cuda"):
        self.device = resolve_device(device)
        n = min(store.count("BakedInterpolationSet"), store.count("Result"))
        sets = store.table("BakedInterpolationSet").read(0, n)
        disney = store.table("DisneyDescriptor").read(0, n)["grid"]
        samples = store.table("ScatterSample").read(0, n)
        results = store.table("Result").read(0, n)
        light = _scene_lights(store, samples["scene_setup_id"])
        view = samples["view_direction"].astype(np.float32)
        self.n = n
        # Sliced to the consumed layers before the upload; a row holds its
        # four corners side by side.
        probes = np.stack([sets[c]["grid"].reshape(n, 10, LAYER)[:, :BAKED_LAYERS]
                           for c in "abcd"], axis=1)
        self.probes = _upload(probes.reshape(n, -1), self.device)
        self.rt = _upload(disney.reshape(n, 10, LAYER)[:, :REALTIME_LAYERS].reshape(n, -1),
                          self.device)
        self.powers = _upload(np.stack([sets[c]["power"] for c in "abcd"], 1)
                              .astype(np.float32), self.device)
        self.omega_h = _omega(light, view)
        self.alpha_h = _alpha(light, view, sets["a"]["direction"].astype(np.float32))
        self.labels_h = results["light_intensity"].astype(np.float32)
        self.converged = results["is_converged"].astype(bool)
        self.omega = _upload(self.omega_h, self.device)
        self.alpha = _upload(self.alpha_h, self.device)
        self.labels = _upload(self.labels_h, self.device)

    def pool(self) -> np.ndarray:
        return np.arange(self.n)[self.converged]

    def _tables(self):
        return (self.probes, self.rt, self.powers, self.omega, self.alpha, self.labels)

    def assemble(self, idx: torch.Tensor) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The batch of rows ``idx`` (K10) → (item dict, labels)."""
        *item, lab = assemble_baked(*self._tables(), idx.to(torch.int64))
        return dict(zip(_BAKED_KEYS, item)), lab

    def assemble_plain(self, idx: torch.Tensor):
        *item, lab = assemble_baked_plain(*self._tables(), idx.to(torch.int64))
        return dict(zip(_BAKED_KEYS, item)), lab


def epoch_schedule(pool: np.ndarray, batch: int, seed: int, epoch: int) -> np.ndarray:
    """[steps, batch] int32 index schedule: a shuffled epoch over the
    converged pool, its order keyed by (seed, epoch) like the host path, so
    resume by skipping replays the same schedule."""
    order = np.random.default_rng(seed + epoch).permutation(pool)
    steps = len(order) // batch
    return order[: steps * batch].reshape(steps, batch).astype(np.int32)
