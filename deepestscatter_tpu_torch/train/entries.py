"""Training entry points (reference: TrainDisneyModel.py, TrainBakedModel.py).

The port of ``deepestscatter_tpu.train.entries``.  Each builds its datasets
from a ``DatasetTriplet`` root (train and validation stores), initialises
its model by Flax's rule from ``config.seed`` (``blocks.flax_init``) and
runs the shared ``Trainer`` with the reference recipe (seed 566, AMSGrad
at 1e-3, batch 1,024, validation batch 4,096, validation every 40 steps),
after restoring a checkpoint where one exists.  ``device_resident=True``
uploads the record tables to the device once and trains in chunks over
batches assembled there (``train.device_data``, K10).

Every entry point runs on ``device="cuda"`` unless the caller passes
``device="cpu"``, and raises when there is no card.

``train_baked`` exports the two submodels apart as well
(TrainBakedModel.py:42-43): ``LightProbeModel.pt`` for the probe bake and
``ProbeRendererModel.pt`` for the realtime path, which
``render.baked.BakedRenderer`` loads; ``DisneyModel.pt`` loads into
``render.neural.DisneyRenderer``.

``mesh=`` (a ``DeviceMesh``, ``parallel.make_mesh``) trains data-parallel
over its ``data`` axis, each rank on its shard of every batch (the JAX
package's ``mesh``; ``train.trainer``).
"""

from __future__ import annotations

import os
from typing import Optional

from ..config import TrainConfig
from ..data.datasets import BakedDataset, DisneyDataset
from ..data.store import DatasetTriplet
from ..device import resolve_device
from ..models.blocks import flax_init
from ..models.probes import BakedModel, MimicModel
from ..models.rpnn import DisneyModel
from . import trainer as trainer_mod
from .device_data import DeviceBakedData, DeviceDisneyData


def _val_batch_fn(dataset, batch_size: int, seed: int = 999):
    def val_batch():
        for item, labels in dataset.batches(batch_size, seed=seed):
            return item, labels
        raise RuntimeError("validation store has no complete batch")

    return val_batch


def _val_store(triplet: DatasetTriplet, label_table: str, name: str):
    """The validation store, with a loud fallback: where it holds no labels
    yet (a collection that has reached only train scenes), validate on the
    train store.  The val_loss watermark then measures fit, not
    generalisation; the render RMS on a held-out scene is the
    generalisation check."""
    store = triplet.validation
    if min(store.count(label_table), store.count("Result")) == 0:
        print(
            f"[{name}] WARNING: validation store has no complete labels — "
            "validating on a train slice (held-out-scene render RMS is the "
            "generalization check)",
            flush=True,
        )
        return triplet.train
    return store


def _train_batches_fn(dataset, batch_size: int, base_seed: int):
    def train_batches(epoch: int):
        yield from dataset.batches(batch_size, seed=base_seed + epoch)

    return train_batches


def disney_trainer(dataset_root: str, config: TrainConfig = TrainConfig(),
                   device_resident: bool = False, device="cuda",
                   mesh=None) -> trainer_mod.Trainer:
    """The ``Trainer`` that ``train_disney`` runs, built and not yet run."""
    dev = resolve_device(device)
    triplet = DatasetTriplet(dataset_root)
    vstore = _val_store(triplet, "DisneyDescriptor", "DisneyModel")
    train_ds, val_ds = DisneyDataset(triplet.train), DisneyDataset(vstore)
    data = vdata = None
    if device_resident:
        data, vdata = DeviceDisneyData(triplet.train, dev), DeviceDisneyData(vstore, dev)
    return trainer_mod.Trainer(
        name="DisneyModel",
        model=flax_init(DisneyModel(), config.seed, dev),
        apply_fn=lambda m, b: m(b["z_layers"]),
        train_batches=_train_batches_fn(train_ds, config.batch_size, config.seed),
        val_batch=_val_batch_fn(val_ds, max(1, min(config.val_batch_size, len(val_ds)))),
        config=config,
        device_data=data,
        val_device_data=vdata,
        device=dev,
        mesh=mesh,
    )


def train_disney(dataset_root: str, config: TrainConfig = TrainConfig(),
                 epochs: Optional[int] = None, device_resident: bool = False,
                 device="cuda", mesh=None) -> trainer_mod.Trainer:
    """DisneyTrainer().run() (TrainDisneyModel.py:35-39): resumes from a
    checkpoint where there is one (warm optimizer, the same trajectory)."""
    t = disney_trainer(dataset_root, config, device_resident, device, mesh)
    t.restore()
    t.run(epochs=epochs)
    return t


def _apply_baked(m, b):
    return m(b["probe_descriptors"], b["probe_powers"], b["disney_descriptor"], b["omega"],
             b["alpha"])


def export_baked(model: BakedModel, run_dir: str) -> None:
    """Split export (TrainBakedModel.py:42-43): the probe net for the bake,
    the renderer net for the realtime path, and the whole model."""
    for name, module in (("LightProbeModel", model.light_probe_model),
                         ("ProbeRendererModel", model.renderer_model), ("BakedModel", model)):
        trainer_mod.save_state(os.path.join(run_dir, f"{name}.pt"),
                               trainer_mod.cpu_state_dict(module))


def baked_trainer(dataset_root: str, config: TrainConfig = TrainConfig(),
                  device_resident: bool = False, device="cuda",
                  mesh=None) -> trainer_mod.Trainer:
    """The ``Trainer`` that ``train_baked`` runs, built and not yet run."""
    dev = resolve_device(device)
    triplet = DatasetTriplet(dataset_root)
    vstore = _val_store(triplet, "BakedInterpolationSet", "BakedModel")
    train_ds, val_ds = BakedDataset(triplet.train), BakedDataset(vstore)
    data = vdata = None
    if device_resident:
        data, vdata = DeviceBakedData(triplet.train, device=dev), DeviceBakedData(vstore, device=dev)
    return trainer_mod.Trainer(
        name="BakedModel",
        model=flax_init(BakedModel(), config.seed, dev),
        apply_fn=_apply_baked,
        train_batches=_train_batches_fn(train_ds, config.batch_size, config.seed),
        val_batch=_val_batch_fn(val_ds, max(1, min(config.val_batch_size, len(val_ds)))),
        config=config,
        export_params=export_baked,
        device_data=data,
        val_device_data=vdata,
        device=dev,
        mesh=mesh,
    )


def train_baked(dataset_root: str, config: TrainConfig = TrainConfig(),
                epochs: Optional[int] = None, device_resident: bool = False,
                device="cuda", mesh=None) -> trainer_mod.Trainer:
    """BakedTrainer().run() (TrainBakedModel.py:47-51): end-to-end training
    of the two-stage model; exports the submodels apart."""
    t = baked_trainer(dataset_root, config, device_resident, device, mesh)
    t.restore()
    t.run(epochs=epochs)
    return t


def train_mimic(dataset_root: str, config: TrainConfig = TrainConfig(),
                epochs: Optional[int] = None, device="cuda", mesh=None) -> trainer_mod.Trainer:
    """Mimic-variant training: one probe descriptor (corner "a"), no
    tetrahedral interpolation (TR/Mimic/MimicModel.py:7-43)."""
    dev = resolve_device(device)
    triplet = DatasetTriplet(dataset_root)
    train_ds, val_ds = BakedDataset(triplet.train), BakedDataset(triplet.validation)
    t = trainer_mod.Trainer(
        name="MimicModel",
        model=flax_init(MimicModel(), config.seed, dev),
        apply_fn=lambda m, b: m(b["probe_descriptors"][:, 0], b["disney_descriptor"],
                                b["omega"], b["alpha"]),
        train_batches=_train_batches_fn(train_ds, config.batch_size, config.seed),
        val_batch=_val_batch_fn(val_ds, config.val_batch_size),
        config=config,
        device=dev,
        mesh=mesh,
    )
    t.restore()
    t.run(epochs=epochs)
    return t
