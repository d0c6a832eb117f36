"""Trains EVAL_r05's operating point with the JAX package and with the
port on the CPU, from one collected store, and renders the held-out scene
with each, so that the two frameworks' trained RMS can be compared on the
same labels.

The store is a ``DatasetTriplet`` root as ``eval_e2e.run_r05`` leaves it
(train scene 0 collected, the validation store holding its setups and no
labels); ``python -m deepestscatter_tpu_torch.probes.eval_spread --root
DIR`` on the card writes one.  For each training seed the script runs
``tools/eval_e2e.py::run_eval`` (the JAX package: device-resident training
of 200 RPNN and 100 baked epochs with ``TrainConfig(seed=...)``, the NN and
BNN frames of the held-out scene, render seed 3) and, with
``--port``, ``deepestscatter_tpu_torch.eval_e2e.run_eval`` with the same
settings on the CPU (and with ``--card-run``, renders the exports the card
trained).  The frames are rendered at 128 x 64, a quarter of the
evaluation's side (the full frame is a card's job), and each is held
against the committed ground truth box-filtered to that size.  Prints one JSON line a run, with the
frames' means; ~10 minutes a run on an 8-core CPU (a run whose exports
exist only renders).

    JAX_PLATFORMS=cpu python tests/jax_eval_check.py --root runs/r05_store --seeds 566
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

REFERENCE = ROOT / "runs/eval_e2e/renders_512x256/eval.PT.exr"
KEYS = ("rms_nn", "rms_nn_random", "rms_bnn", "rms_bnn_random", "val_loss_nn", "val_loss_bnn")
#: The frames' size: a quarter of the evaluation's side (the full frame is
#: a card's job).
WIDTH, HEIGHT = 128, 64


def main(argv=None) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from deepestscatter_tpu.config import TrainConfig as JTrainConfig
    from tools import eval_e2e as jeval

    from deepestscatter_tpu_torch import eval_e2e
    from deepestscatter_tpu_torch.config import TrainConfig as TTrainConfig
    from deepestscatter_tpu_torch.utils import exr

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True, help="the collected DatasetTriplet root")
    parser.add_argument("--seeds", type=int, nargs="+", default=[566])
    parser.add_argument("--port", action="store_true", help="also train and render the port")
    parser.add_argument("--card-run", default=None,
                        help="a run directory under --root with the card's exports "
                             "(runs_seed566): its frames rendered here too")
    args = parser.parse_args(argv)
    root = Path(args.root)
    w, h = WIDTH, HEIGHT
    renders = root / f"renders_{w}x{h}"
    reference = exr.read_exr(str(REFERENCE))
    fy, fx = reference.shape[0] // h, reference.shape[1] // w
    reference = (reference.reshape(h, fy, w, fx, 3).mean(axis=(1, 3), dtype=np.float64)
                 .astype(np.float32))
    point = dict(width=w, height=h, epochs_disney=200, epochs_baked=100, verbose=False)
    for seed in args.seeds:
        jrun, trun = f"runs_jax_seed{seed}", f"runs_port_cpu_seed{seed}"
        runs = [("jax", lambda: jeval.run_eval(
            str(root), train_cfg=JTrainConfig(run_dir=str(root / jrun), seed=seed,
                                              val_batch_size=4096),
            run_name=jrun, collect=False, **point))]
        if args.port:
            runs.append(("port_cpu", lambda: eval_e2e.run_eval(
                str(root), train_cfg=TTrainConfig(run_dir=str(root / trun), seed=seed),
                run_name=trun, collect=(), device="cpu", **point)))
        if args.card_run:
            runs.append(("port_card_weights", lambda: eval_e2e.run_eval(
                str(root), run_name=args.card_run, collect=(), device="cpu", **point)))
        for name, run in runs:
            # Each run renders into renders_<w>x<h>, which starts with the
            # ground truth alone; its frames are kept under a name of its own.
            shutil.rmtree(renders, ignore_errors=True)
            renders.mkdir()
            exr.write_exr(str(renders / "eval.PT.exr"), reference)
            t0 = time.time()
            rep = run()
            kept = root / f"renders_{w}x{h}.{name}.seed{seed}"
            shutil.rmtree(kept, ignore_errors=True)
            renders.rename(kept)
            means = {f"mean_{k}": float(exr.read_exr(str(kept / f"eval.{k.upper()}.exr")).mean())
                     for k in ("nn", "bnn")}
            print(json.dumps({"framework": name, "train_seed": seed,
                              **{k: rep.get(k) for k in KEYS}, **means,
                              "pt_mean": float(reference.mean()),
                              "labels": rep["dataset"]["train_labels"],
                              "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
