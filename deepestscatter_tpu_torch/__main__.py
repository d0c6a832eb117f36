"""The command line of the PyTorch / CUDA port (reference: DG/src/main.cpp:
26-85 and the Python utility mains), mirroring ``python -m
deepestscatter_tpu``:

    python -m deepestscatter_tpu_torch render <cloud> [--out DIR] [--renderer pt|nn|bnn]
    python -m deepestscatter_tpu_torch setups <dataset_root> --clouds <root|specs...>
    python -m deepestscatter_tpu_torch collect <dataset_root> <record_type> [...]
    python -m deepestscatter_tpu_torch train-disney <dataset_root> [...]
    python -m deepestscatter_tpu_torch train-baked <dataset_root> [...]
    python -m deepestscatter_tpu_torch compare <pt.exr> <other.exr...> [--out DIR]
    python -m deepestscatter_tpu_torch eval [--root DIR] [--out report.json]

The arguments and defaults are the JAX CLI's, but for ``eval --root``
(``runs/eval_torch``).  ``bench`` is not ported yet.

Every command that computes takes ``--device`` (default ``cuda``: it raises
where there is no card; ``--device cpu`` runs on the CPU).  Run it from the
repository root.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="deepestscatter_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    on = argparse.ArgumentParser(add_help=False)
    on.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")

    r = sub.add_parser("render", parents=[on], help="render a cloud (renderCloud task)")
    r.add_argument("cloud")
    r.add_argument("--out", default=".")
    r.add_argument(
        "--renderer", default="pt", choices=["pt", "nn", "bnn"],
        help="pt = path-traced ground truth; nn = RPNN; bnn = baked "
        "two-network (the reference renderCloud default, Tasks.cpp:86)",
    )
    r.add_argument(
        "--models-dir", default="runs",
        help="directory of exported <Model>.pt or <Model>.params.msgpack "
        "(':init:' = untrained weights, smoke renders only)",
    )
    r.add_argument("--size-m", type=float, default=3000.0)
    r.add_argument("--directions", nargs="+", default=["Side", "Back"])
    r.add_argument("--max-subframes", type=int, default=None)
    r.add_argument("--width", type=int, default=None)
    r.add_argument("--height", type=int, default=None)

    s = sub.add_parser("setups", help="seed SceneSetup tables")
    s.add_argument("dataset_root")
    s.add_argument("--clouds", nargs="+", required=True,
                   help="cloud files/specs or a directory to glob")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--scenes-per-cloud", type=int, default=30)

    c = sub.add_parser("collect", parents=[on], help="run one dataset collection stage")
    c.add_argument("dataset_root")
    c.add_argument("record_type", choices=[
        "ScatterSample", "Result", "DisneyDescriptor", "BakedInterpolationSet"])
    c.add_argument("--split", default="train", choices=["train", "validation", "test"])
    c.add_argument("--mode", default="continue", choices=["continue", "overwrite"])
    c.add_argument("--max-scenes", type=int, default=None)

    for name in ("train-disney", "train-baked"):
        t = sub.add_parser(name, parents=[on], help=f"{name} on a collected dataset")
        t.add_argument("dataset_root")
        t.add_argument("--epochs", type=int, default=None)
        t.add_argument("--run-dir", default="runs")

    m = sub.add_parser("compare", help="RMS bias vs PT ground truth")
    m.add_argument("pt_exr")
    m.add_argument("others", nargs="+")
    m.add_argument("--out", default=None)

    e = sub.add_parser(
        "eval", parents=[on],
        help="end-to-end quality eval: dataset -> training -> NN/BNN/PT "
        "renders -> RMS bias (GenerateComparisons.py analog)",
    )
    # Not the JAX CLI's runs/eval_e2e: that directory holds the JAX
    # package's committed renders, which a 512 x 256 run would overwrite.
    e.add_argument("--root", default="runs/eval_torch")
    e.add_argument("--out", default=None, help="report JSON path")
    e.add_argument("--width", type=int, default=256)
    e.add_argument("--height", type=int, default=128)
    e.add_argument("--scenes-per-cloud", type=int, default=2)
    e.add_argument("--batch-size", type=int, default=2048)
    e.add_argument("--epochs-nn", type=int, default=50)
    e.add_argument("--epochs-bnn", type=int, default=30)
    e.add_argument("--skip-baked", action="store_true")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    if args.cmd == "render":
        from . import tasks
        from .config import SceneConfig

        base = SceneConfig()
        if args.max_subframes is not None:
            base = dataclasses.replace(base, progressive=dataclasses.replace(
                base.progressive, max_subframes=args.max_subframes))
        if args.width or args.height:
            cam = base.camera
            base = dataclasses.replace(base, camera=dataclasses.replace(
                cam, width=args.width or cam.width, height=args.height or cam.height))
        tasks.render_cloud(args.cloud, args.out, args.renderer, args.size_m,
                           directions=args.directions, base=base, models_dir=args.models_dir,
                           device=args.device)
    elif args.cmd == "setups":
        from .data import scenesetups

        clouds = []
        for spec in args.clouds:
            if os.path.isdir(spec):
                clouds.extend(scenesetups.find_clouds(spec))
            else:
                clouds.append(spec)
        scenesetups.generate(args.dataset_root, clouds, seed=args.seed,
                             scenes_per_cloud=args.scenes_per_cloud)
        print(f"seeded {len(clouds)} clouds under {args.dataset_root}")
    elif args.cmd == "collect":
        from . import tasks
        from .data.store import DatasetTriplet

        store = getattr(DatasetTriplet(args.dataset_root), args.split)
        mode = tasks.CollectMode(args.mode)
        n = tasks.collect(store, args.record_type, mode, max_scenes=args.max_scenes,
                          device=args.device)
        print(f"processed {n} scenes")
    elif args.cmd in ("train-disney", "train-baked"):
        from .config import TrainConfig
        from .train import entries

        fn = entries.train_disney if args.cmd == "train-disney" else entries.train_baked
        fn(args.dataset_root, config=TrainConfig(run_dir=args.run_dir), epochs=args.epochs,
           device=args.device)
    elif args.cmd == "compare":
        from .utils import compare

        result = compare.compare_renders(args.pt_exr, args.others, args.out)
        print(json.dumps(result, indent=2))
    elif args.cmd == "eval":
        from . import eval_e2e

        eval_e2e.run_eval(args.root, scenes_per_cloud=args.scenes_per_cloud,
                          batch_size=args.batch_size, width=args.width, height=args.height,
                          epochs_disney=args.epochs_nn, epochs_baked=args.epochs_bnn,
                          out_json=args.out, skip_baked=args.skip_baked, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
