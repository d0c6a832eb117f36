"""Holds the labels the card collected for EVAL_r05's train scene 0 against
the JAX package's collector on the CPU, on the same points.

The store is a ``DatasetTriplet`` root as ``eval_e2e.run_r05`` leaves it
(train scene 0 collected); ``python -m
deepestscatter_tpu_torch.probes.eval_spread --root DIR`` on the card writes
one.  The first POINTS stored ScatterSamples of scene 0 go through
``deepestscatter_tpu.data.collectors.estimate_point_radiance`` with the
evaluation's settings (``tools/eval_e2e.py:133-157``: Russian roulette from
bounce 64 at 0.98, uint8 textures, 20,000 experiments for a black point;
seed 0, the scene's id, as ``tasks.collect`` passes it), for UPDATES
updates of the collector's loop: each update is ~2 million experiments,
~5 minutes on an 8-core CPU, and converging every point takes the card's
loop up to its 200.  A label is the mean of its point's experiments,
converged or not, so the two collectors' labels of a point differ by noise
alone unless one is biased.  Prints one JSON line: the converged (the
JAX package's within its UPDATES) and black counts of both, the label
means, and a paired t statistic of the differences over all points and
over those both converged (|t| <= 4 expected).

    JAX_PLATFORMS=cpu python tests/jax_label_check.py --root runs/r05_store
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: The points checked, the first of scene 0's 2,048, and the JAX
#: collector's updates.
POINTS = 128
UPDATES = 3
#: A paired t statistic beyond this says the label means differ.
T_MAX = 4.0


def main(argv=None) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from deepestscatter_tpu import tasks
    from deepestscatter_tpu.config import CloudRendering, PointRadianceConfig, SceneConfig
    from deepestscatter_tpu.data import collectors
    from deepestscatter_tpu.data.store import DatasetTriplet

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True, help="the collected DatasetTriplet root")
    args = parser.parse_args(argv)
    train = DatasetTriplet(args.root).train
    setup = train.table("SceneSetup").get_record(0)
    samples = train.table("ScatterSample").read(0, POINTS)
    card = train.table("Result").read(0, POINTS)
    base = SceneConfig(rendering=CloudRendering(rr_start_depth=64, rr_survival=0.98,
                                                march_dtype="uint8"))
    rcfg = PointRadianceConfig(black_min_experiments=20_000)
    t0 = time.time()
    _, params, static = tasks.scene_from_setup(setup, base)
    est = collectors.estimate_point_radiance(
        params, static, jnp.asarray(samples["point"]), jnp.asarray(samples["view_direction"]),
        rcfg, seed=0, max_updates=UPDATES)
    secs = time.time() - t0
    c_lab = card["light_intensity"].astype(np.float64)
    c_conv = card["is_converged"].astype(bool)
    j_lab = np.asarray(est.radiance, np.float64)
    j_conv = np.asarray(est.is_converged, bool)
    both = c_conv & j_conv

    def paired(sel):
        d = j_lab[sel] - c_lab[sel]
        if d.size < 2:
            return {"points": int(d.size)}
        return {"points": int(sel.sum()), "card": float(c_lab[sel].mean()),
                "jax": float(j_lab[sel].mean()), "rel_diff": float(d.mean() / c_lab[sel].mean()),
                "t": float(d.mean() / (d.std(ddof=1) / np.sqrt(d.size)))}

    every = paired(np.ones(POINTS, bool))
    eps = np.finfo(np.float32).eps
    out = {
        "cloud": bytes(setup["cloud_path"]).rstrip(b"\x00").decode(),
        "size_m": float(setup["cloud_size_m"]), "points": POINTS,
        "converged": {"card": int(c_conv.sum()), "jax": int(j_conv.sum()), "both": int(both.sum())},
        "black": {"card": int((c_lab < eps).sum()), "jax": int((j_lab < eps).sum())},
        "all_points": every, "both_converged": paired(both), "t_max": T_MAX,
        "jax_experiments": {"min": int(np.min(est.experiments)),
                            "median": float(np.median(est.experiments))},
        "jax_updates": len(est.schedule), "seconds": secs,
    }
    print(json.dumps(out), flush=True)
    return 0 if abs(every["t"]) <= T_MAX else 1


if __name__ == "__main__":
    sys.exit(main())
