"""Training harness (reference: TR/Common/Trainer.py:21-205).

The port of ``deepestscatter_tpu.train.trainer``:

- **log-space regression**: labels and predictions pass through
  ``LogTransform.forward`` before the MSE (Trainer.py:27-31);
- **Adam with AMSGrad at lr 1e-3** by optax's rule (``AmsGrad``; the JAX
  package's ``optax.amsgrad``), which takes the running maximum of the
  *bias-corrected* second moment.  ``torch.optim.Adam(amsgrad=True)`` takes
  the maximum of the raw moment and follows another trajectory;
- **seed discipline**: one integer seed (566) keys the initial weights
  (``models.blocks.flax_init``) and the data order (Trainer.py:40-47);
- **validate and checkpoint every 40 steps**, keeping the best validation
  loss (Trainer.py:145-173); a NaN loss aborts with ``FloatingPointError``
  (Trainer.py:155);
- **checkpoints** of the full state (parameters, optimizer state, step,
  best validation loss) and of the best parameters, ``torch.save``d
  atomically (a temporary file, then ``os.replace``) and loaded with
  ``weights_only=True``; ``export`` writes ``<name>.pt`` state dicts that
  the renderers load;
- **metrics**: JSONL scalars (the tensorboardX replacement).

The device path (``Trainer.device_data``) runs ``validate_every`` steps a
chunk over batches that ``train.device_data`` assembles on the card from
an uploaded ``[k, B]`` index schedule (K10); a Python loop over the chunk
stands in for the JAX package's ``lax.scan``.  The networks' products run
on cuBLAS in float32 with TF32 off.

Data parallelism (the JAX package's ``mesh``): with ``Trainer(mesh=...)``
each rank of the mesh's ``data`` axis takes its contiguous shard of every
batch (assembled on its card by K10 on the device path), and one
``all_reduce`` a step averages the flat gradient (the shard losses ride
along) before ``AmsGrad.step``.  With equal shards that is the global
batch's mean gradient, as ``make_train_step(mesh=...)`` computes it (the
sums in another order; at one rank bitwise the undistributed step).  Every
rank holds the same weights and optimizer state; only the axis's first
rank writes metrics and checkpoints.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..config import TrainConfig
from ..device import resolve_device
from ..models.blocks import LogTransform
from ..ops.grid import true_div
from ..render.neural import exact_float32_matmul
from . import device_data as dd

#: ``apply_fn(model, batch) -> [B, 1]`` predictions.
ApplyFn = Callable[[nn.Module, Dict[str, torch.Tensor]], torch.Tensor]


#: optax.amsgrad's defaults, the JAX trainer's rule: moment decays, and the
#: denominator's epsilon outside the square root (eps_root is 0).
B1, B2, EPS = 0.9, 0.999, 1e-8


class AmsGrad:
    """optax's ``amsgrad(learning_rate)`` over a list of parameters, its
    state ``count``, ``mu``, ``nu`` and ``nu_max`` kept as flat float32
    tensors in the parameters' order.  A step, from the gradients g::

        mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu
        count += 1;   mu_hat = mu / (1 - b1^count);   nu_hat = nu / (1 - b2^count)
        nu_max = max(nu_max, nu_hat)
        p += (mu_hat / (sqrt(nu_max) + eps)) * (-learning_rate)

    The maximum is taken of the bias-corrected moment (``torch.optim.Adam
    (amsgrad=True)`` takes it of the raw one).  The bias corrections are
    computed in float32 on the host and divide as 0-dim tensors on the
    parameters' device (IEEE divisions there too)."""

    def __init__(self, params: Sequence[torch.Tensor], learning_rate: float):
        self.params = list(params)
        self.learning_rate = learning_rate
        self.sizes = [p.numel() for p in self.params]
        n = sum(self.sizes)
        dev = self.params[0].device
        self.count = 0
        self.mu = torch.zeros(n, dtype=torch.float32, device=dev)
        self.nu = torch.zeros(n, dtype=torch.float32, device=dev)
        self.nu_max = torch.zeros(n, dtype=torch.float32, device=dev)

    def _correction(self, decay: float) -> torch.Tensor:
        value = np.float32(1.0) - np.float32(decay) ** np.float32(self.count)
        return torch.full((), float(value), dtype=torch.float32, device=self.mu.device)

    def updates(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The flat update of these gradients (already scaled by
        ``-learning_rate``); advances the state."""
        g = torch.cat([x.reshape(-1) for x in grads])
        self.mu = g * (1 - B1) + self.mu * B1
        self.nu = (g * g) * (1 - B2) + self.nu * B2
        self.count = min(self.count + 1, 2**31 - 1)
        mu_hat = self.mu / self._correction(B1)
        nu_hat = self.nu / self._correction(B2)
        self.nu_max = torch.maximum(self.nu_max, nu_hat)
        return (mu_hat / (torch.sqrt(self.nu_max) + EPS)) * (-self.learning_rate)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        u = self.updates(grads)
        torch._foreach_add_(
            self.params, [v.view_as(p) for v, p in zip(u.split(self.sizes), self.params)]
        )

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "mu": self.mu, "nu": self.nu, "nu_max": self.nu_max}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        dev = self.mu.device
        for name in ("mu", "nu", "nu_max"):
            if state[name].shape != self.mu.shape:
                raise ValueError(f"optimizer state {name} has shape "
                                 f"{tuple(state[name].shape)}, expected {tuple(self.mu.shape)}")
        self.count = int(state["count"])
        self.mu, self.nu, self.nu_max = (state[k].to(dev).clone() for k in ("mu", "nu", "nu_max"))


def log_mse_loss(predictions: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """MSE in log space (Trainer.py:114 with LogModel.logEps :27-31): both
    the model's output and the label are log-eps transformed."""
    diff = LogTransform.forward(predictions) - LogTransform.forward(labels)
    return torch.mean(diff * diff)


def data_shard(n: int, group) -> slice:
    """This rank's contiguous rows of a batch of ``n`` over ``group``
    (all of them without one); raises unless the ranks divide ``n``."""
    if group is None:
        return slice(0, n)
    ranks, rank = dist.get_world_size(group), dist.get_rank(group)
    if n % ranks:
        raise ValueError(f"a batch of {n} must divide evenly over {ranks} data ranks")
    return slice(rank * (n // ranks), (rank + 1) * (n // ranks))


def mean_over(group, loss: torch.Tensor, grads: Sequence[torch.Tensor]):
    """The group's mean loss and gradient: one ``all_reduce`` of the flat
    gradient with the loss appended, divided by the group's size → (loss,
    [flat gradient])."""
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
    dist.all_reduce(flat, group=group)
    flat = true_div(flat, float(dist.get_world_size(group)))
    return flat[-1], [flat[:-1]]


def train_step(model: nn.Module, opt: AmsGrad, apply_fn: ApplyFn,
               batch: Dict[str, torch.Tensor], labels: torch.Tensor,
               group=None) -> torch.Tensor:
    """One optimizer step on a batch → its loss (a 0-dim tensor on the
    model's device; nothing waits for the device).  With a ``group``, the
    batch is this rank's shard and the step takes the group's mean."""
    preds = apply_fn(model, batch)[:, 0]
    loss = log_mse_loss(preds, labels)
    grads = torch.autograd.grad(loss, opt.params)
    if group is not None:
        loss, grads = mean_over(group, loss, grads)
    opt.step(grads)
    return loss.detach()


@torch.no_grad()
def eval_step(model: nn.Module, apply_fn: ApplyFn, batch: Dict[str, torch.Tensor],
              labels: torch.Tensor) -> torch.Tensor:
    return log_mse_loss(apply_fn(model, batch)[:, 0], labels)


def chunk_step(model: nn.Module, opt: AmsGrad, apply_fn: ApplyFn,
               assemble_fn: Callable[[torch.Tensor], Tuple[dict, torch.Tensor]],
               idx_chunk: torch.Tensor, group=None) -> torch.Tensor:
    """``k`` sequential ``train_step``s over the rows of an on-device
    ``[k, B]`` index schedule, each batch assembled by ``assemble_fn`` →
    the k losses [k].  The trajectory is that of k ``train_step`` calls.
    With a ``group`` each rank assembles its shard of every row."""
    losses = []
    rows = data_shard(idx_chunk.shape[1], group)
    for idx in idx_chunk:
        batch, labels = assemble_fn(idx[rows])
        losses.append(train_step(model, opt, apply_fn, batch, labels, group))
    return torch.stack(losses)


class MetricsWriter:
    """Append-only JSONL scalar log (the tensorboardX replacement)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                  "ts": time.time()}) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def save_state(path: str, obj: Any) -> None:
    """``torch.save`` to ``path`` atomically: a temporary file beside it,
    then ``os.replace``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def cpu_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` copied to the CPU (the export's form: it
    loads on any device)."""
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


def _on(dev: torch.device, batch: Dict[str, Any], labels: Any):
    return ({k: torch.as_tensor(v, device=dev) for k, v in batch.items()},
            torch.as_tensor(labels, device=dev))


@dataclasses.dataclass
class Trainer:
    """The epoch / validate / checkpoint loop (Trainer.py:88-205).

    ``model`` is copied onto ``device`` (the card unless the caller asks
    for the CPU; raises if there is no card) and trained in place of the
    caller's.  ``train_batches(epoch)`` yields ``(batch, labels)`` and
    ``val_batch()`` returns one, as numpy arrays or tensors; ``apply_fn
    (model, batch) -> [B, 1]``.  With ``device_data`` (``train.device_data.
    DeviceDisneyData`` / ``DeviceBakedData``) ``run`` trains in
    ``validate_every``-step chunks over batches assembled on the device,
    validating on ``val_device_data``.  ``mesh``: a ``DeviceMesh`` whose
    ``data_axis`` the batches shard over (module docstring)."""

    name: str
    model: nn.Module
    apply_fn: ApplyFn
    train_batches: Callable[[int], Iterator[Tuple[Any, Any]]]
    val_batch: Callable[[], Tuple[Any, Any]]
    config: TrainConfig = TrainConfig()
    export_params: Optional[Callable[[nn.Module, str], None]] = None
    device_data: Optional[Any] = None
    val_device_data: Optional[Any] = None
    device: Any = "cuda"
    mesh: Optional[Any] = None
    data_axis: str = "data"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.group = None if self.mesh is None else self.mesh.get_group(self.data_axis)
        self.writer = self.group is None or dist.get_rank(self.group) == 0
        if self.device.type == "cuda":
            exact_float32_matmul()
        self.model = copy.deepcopy(self.model).to(self.device).train()
        self.opt = AmsGrad(list(self.model.parameters()), self.config.learning_rate)
        self.step = 0
        self.best_val = float("inf")
        self.run_dir = os.path.join(self.config.run_dir, self.name)
        self.metrics = (MetricsWriter(os.path.join(self.run_dir, "metrics.jsonl"))
                        if self.writer else None)
        if self.device_data is not None:
            # The device path validates on a fixed batch of the validation
            # pool: 999 keys its choice, sorted.
            vdata = self.val_device_data
            vsel = np.random.default_rng(999).permutation(vdata.pool())[
                : self.config.val_batch_size]
            val_idx = torch.as_tensor(np.sort(vsel), dtype=torch.int64, device=self.device)
            self.val_batch = lambda: vdata.assemble(val_idx)

    # -- checkpoints (Trainer.py:60-67, 164-169) -----------------------------

    def checkpoint_path(self, best: bool = False) -> str:
        return os.path.join(self.run_dir, "model_best.pt" if best else "checkpoint.pt")

    def save_checkpoint(self, is_best: bool) -> None:
        """Checkpoint the full train state: parameters, optimizer state,
        step and the best validation loss, so that a preempted run resumes
        with warm moments and exports no worse model over ``model_best``.
        Only the writer (the data axis's first rank) writes."""
        if not self.writer:
            return
        save_state(self.checkpoint_path(), {
            "params": self.model.state_dict(),
            "opt_state": self.opt.state_dict(),
            "step": self.step,
            "best_val": self.best_val,
        })
        if is_best:
            save_state(self.checkpoint_path(best=True), self.model.state_dict())
            self.export()

    def export(self) -> None:
        """The render-ready artifact: ``export_params(model, run_dir)``, or
        the model's state dict as ``<name>.pt``."""
        if self.export_params is not None:
            self.export_params(self.model, self.run_dir)
        else:
            save_state(os.path.join(self.run_dir, f"{self.name}.pt"), cpu_state_dict(self.model))

    def restore(self) -> bool:
        """Load the full state of ``checkpoint.pt``, if there is one."""
        path = self.checkpoint_path()
        if not os.path.exists(path):
            return False
        st = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(st["params"])
        self.opt.load_state_dict(st["opt_state"])
        self.step = int(st["step"])
        self.best_val = float(st["best_val"])
        return True

    # -- the loop --------------------------------------------------------------

    def val_loss(self) -> float:
        """The loss of the current parameters on the validation batch."""
        batch, labels = _on(self.device, *self.val_batch())
        return float(eval_step(self.model, self.apply_fn, batch, labels))

    def scalar(self, tag: str, value: float) -> None:
        if self.writer:
            self.metrics.scalar(tag, value, self.step)

    def validate_and_save(self) -> float:
        val_loss = self.val_loss()
        self.scalar("val_loss", val_loss)
        if self.writer:
            print(f"[{self.name}] step {self.step}: val_loss {val_loss:.5f}", flush=True)
        if not np.isfinite(val_loss):
            raise FloatingPointError(f"validation loss is {val_loss} at step {self.step}")
        is_best = val_loss < self.best_val
        self.best_val = min(self.best_val, val_loss)
        self.save_checkpoint(is_best)
        return val_loss

    def _check(self, loss: torch.Tensor) -> float:
        value = float(loss)
        if not np.isfinite(value):
            raise FloatingPointError(f"train loss is {value} at step {self.step}")
        return value

    def run(self, epochs: Optional[int] = None) -> None:
        """The epoch loop.  After ``restore()`` the first ``step`` batches
        are skipped (the data order is keyed by (seed, epoch)), so a
        resumed run continues the uninterrupted trajectory."""
        if self.device_data is not None:
            return self._run_device(epochs)
        cfg = self.config
        done, consumed = self.step, 0
        for epoch in range(epochs if epochs is not None else cfg.epochs):
            for batch, labels in self.train_batches(epoch):
                consumed += 1
                if consumed <= done:
                    continue
                batch, labels = _on(self.device, batch, labels)
                rows = data_shard(labels.shape[0], self.group)
                loss = train_step(self.model, self.opt, self.apply_fn,
                                  {k: v[rows] for k, v in batch.items()}, labels[rows],
                                  self.group)
                self.step += 1
                if self.step % cfg.validate_every == 0:
                    self.scalar("train_loss", self._check(loss))
                    self.validate_and_save()

    def _run_device(self, epochs: Optional[int] = None) -> None:
        """Chunks of ``validate_every`` steps over the device tables; the
        validation and checkpoint cadence, the NaN abort and resume by
        skipping are the host loop's (the skip replays the same (seed,
        epoch) schedules)."""
        cfg = self.config
        data = self.device_data
        pool = data.pool()
        k_max = cfg.validate_every
        done, consumed = self.step, 0
        for epoch in range(epochs if epochs is not None else cfg.epochs):
            sched = dd.epoch_schedule(pool, cfg.batch_size, cfg.seed, epoch)
            s = 0
            while s < len(sched):
                k = min(k_max, len(sched) - s)
                if consumed + k <= done:
                    consumed += k
                    s += k
                    continue
                if consumed < done:
                    # Mid-chunk resume: skip the prefix already done; the
                    # next pass runs the rest of the chunk.
                    skip = done - consumed
                    consumed += skip
                    s += skip
                    continue
                idx = torch.as_tensor(sched[s : s + k], dtype=torch.int64, device=self.device)
                losses = chunk_step(self.model, self.opt, self.apply_fn, data.assemble, idx,
                                    self.group)
                consumed += k
                s += k
                self.step += k
                train_loss = self._check(losses[-1])
                if self.step % k_max == 0 or s >= len(sched):
                    self.scalar("train_loss", train_loss)
                    self.validate_and_save()


def flat_params(model: nn.Module) -> torch.Tensor:
    """Every parameter of ``model`` flattened in order into one vector."""
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])
