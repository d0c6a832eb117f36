"""The spread of the end-to-end evaluation's RMS over training seeds.

At ``EVAL_r05.json``'s operating point (``eval_e2e.run_r05``): one
collection of train scene 0, then training and the held-out scene's frames
once per training seed, each frame's tone-mapped RMS against the ground
truth.  Prints a line per seed and a summary (min, max, mean, standard
deviation of each RMS and validation loss) beside EVAL_r05's values.  Run
from the repository root on the card:

    python -m deepestscatter_tpu_torch.probes.eval_spread \\
        --ground-truth runs/eval_e2e/renders_512x256/eval.PT.exr --seeds 566 567 568
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from .. import eval_e2e

KEYS = ("rms_nn", "rms_nn_random", "rms_bnn", "rms_bnn_random", "val_loss_nn", "val_loss_bnn")
#: The JAX package's report of the evaluation, at the repository's root.
RECORD = Path(__file__).resolve().parents[2] / "EVAL_r05.json"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ground-truth", required=True, help="the held-out scene's PT EXR")
    p.add_argument("--seeds", type=int, nargs="+", default=[566, 567, 568])
    p.add_argument("--out", default=None, help="write every report here (JSON)")
    p.add_argument("--root", default=None,
                   help="keep the stores and runs here (default: a temporary directory)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    record = json.loads(RECORD.read_text())
    reports = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = args.root or tmp
        for i, seed in enumerate(args.seeds):
            t0 = time.time()
            rep = eval_e2e.run_r05(root, seed, collect=(i == 0), ground_truth=args.ground_truth,
                                   device=args.device)
            reports[seed] = rep
            print(f"eval spread, train seed {seed}: "
                  f"{json.dumps({k: rep.get(k) for k in KEYS + ('steps_nn', 'steps_bnn')})} "
                  f"labels_converged={rep['dataset']['train_labels_converged']} "
                  f"timings={json.dumps(rep['timings'])} seconds={time.time() - t0:.2f}",
                  flush=True)
    summary = {}
    for k in KEYS:
        v = np.array([r[k] for r in reports.values() if k in r], np.float64)
        summary[k] = dict(min=v.min(), max=v.max(), mean=v.mean(), std=v.std(ddof=1)
                          if len(v) > 1 else 0.0, eval_r05=record.get(k))
    device = next(iter(reports.values()))["device"]
    print(f"eval spread: seeds={args.seeds} device={json.dumps(device)} "
          f"summary={json.dumps(summary)}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"reports": reports, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
