"""The row-gather probe (P1, P2): how fast the card gathers rows of a uint8
table by random int32 indices.

The port of ``tools/pallas_gather_probe.py``, with its cases, index layouts
and report keys.  The march kernels read the density texture at random
addresses, one small row per ray per step; this probe measures that access
pattern alone, so a kernel's step rate can be held against the card's
gather ceiling rather than against its streaming bandwidth:

- P1 ``per_lane``: every lane of a 1024-lane tile gathers one ``width``-byte
  row at a random index; the tile's bytes are summed.
- P2 ``coalesced``: each tile gathers ``1024 / run`` blocks of ``run``
  contiguous rows (the best case a ray-binning pass could make); only the
  first ``1024 / run`` index entries of each tile are read, the rest is
  padding, as in the Pallas kernel's index layout.

``per_lane`` and ``coalesced`` are the kernels' wrappers
(``csrc/gather_probe.cu``) for CUDA tensors and their plain PyTorch
versions for CPU tensors.  The TPU kernel's DMA pipeline depth (``nbuf``)
is not reported: P1 keeps 8 rows' loads in flight a lane instead.
``variants`` times P1's designs against each other
(``csrc/gather_variants.cu``, ``P1_DESIGNS``).

Run on the card::

    python -m deepestscatter_tpu_torch.probes.gather [--json out.json]
"""

from __future__ import annotations

import ctypes
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import cuda_build
from ..device import check_on, resolve_device

TILE = 1024  # lanes (rows) per tile: one CTA on the card
#: (nrows, row bytes, batch) of the Pallas probe: a 128 MB and a 1 GB table.
CASES = ((1 << 17, 1024, 1 << 18), (1 << 20, 1024, 1 << 18))
RUNS = (8, 32)
#: P1's designs (csrc/gather_variants.cu): the first design (a warp a row),
#: the package's (8 rows in flight a lane), a bulk-copy ring (cp.async.bulk
#: into 8 shared-memory slots a warp).
P1_DESIGNS = {"warp a row": 0, "8 rows in flight a lane": 1, "bulk-copy ring of 8": 2}
#: A 16 MiB table of 16-byte rows (the 256^3 uint8 density texture's size;
#: 32 rows a warp step), 2^24 rows gathered: at 2^18 the launch is shorter
#: than its host-side cost and the events time the host.
TEXTURE_CASE = ((1 << 24) // 16, 16, 1 << 24)
#: The cases ``variants`` times: the probe's two tables and the texture's.
VARIANT_CASES = CASES + (TEXTURE_CASE,)
#: Published H100 SXM HBM rate, bytes/s (the bound of a gather).
HBM_BYTES_PER_S = 3.35e12


def _tile_sums(gathered: torch.Tensor, ntiles: int) -> torch.Tensor:
    """Exact integer byte sums of each tile's gathered rows, as float32
    ``[ntiles, 1]`` (one rounding, as the kernel's int32 → float)."""
    return gathered.reshape(ntiles, -1).sum(dim=1, dtype=torch.int64).to(torch.float32)[:, None]


def per_lane_plain(idx: torch.Tensor, rows: torch.Tensor, width: int) -> torch.Tensor:
    """Plain version of P1: per tile, the byte sum of rows ``idx[t*1024 +
    j]`` of the ``width``-byte rows of ``rows`` → float32 [ntiles, 1]."""
    ntiles = idx.shape[0] // TILE
    got = rows.reshape(-1, width).index_select(0, idx[: ntiles * TILE].to(torch.int64))
    return _tile_sums(got, ntiles)


def coalesced_plain(
    idx: torch.Tensor, rows: torch.Tensor, width: int, run: int
) -> torch.Tensor:
    """Plain version of P2: per tile, the byte sum of the ``run`` rows from
    each of ``idx[t*1024 + b]``, ``b < 1024 / run`` → float32 [ntiles, 1]."""
    ntiles = idx.shape[0] // TILE
    starts = idx[: ntiles * TILE].reshape(ntiles, TILE)[:, : TILE // run].to(torch.int64)
    offs = torch.arange(run, dtype=torch.int64, device=idx.device)
    got = rows.reshape(-1, width).index_select(0, (starts[..., None] + offs).reshape(-1))
    return _tile_sums(got, ntiles)


_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p,
]


def _used(idx: torch.Tensor, run: int) -> torch.Tensor:
    """The index entries a kernel reads: all of them for P1 (``run`` 0),
    the first ``1024 / run`` of each tile for P2."""
    return idx if run == 0 else idx.reshape(-1, TILE)[:, : TILE // run]


def _check_bounds(idx: torch.Tensor, nrows: int, run: int) -> None:
    """Raise unless every row the kernel will read lies in the table (one
    reduction and one device-to-host copy)."""
    lo, hi = (int(v) for v in torch.aminmax(_used(idx, run)))
    if lo < 0 or hi + max(run, 1) > nrows:
        raise ValueError(f"index reads rows [{lo}, {hi + max(run, 1)}) of a {nrows}-row table")


def _launch(idx: torch.Tensor, rows: torch.Tensor, width: int, run: int,
            lib=None) -> torch.Tensor:
    """Launch P1 (``run`` 0) or P2 on bounds-checked indices and count the
    launch.  ``lib``: another library with the same ``ds_gather_probe``
    entry point (the designs ``variants`` times)."""
    if idx.dtype != torch.int32 or idx.dim() != 1 or idx.shape[0] % TILE:
        raise ValueError(f"idx must be int32 [ntiles * {TILE}]")
    if rows.dtype != torch.uint8 or rows.dim() != 1 or rows.shape[0] % width:
        raise ValueError("rows must be uint8 [nrows * width]")
    if width % 16 or rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned and width a multiple of 16")
    if run and TILE % run:
        raise ValueError(f"run must divide {TILE}")
    if not (idx.is_contiguous() and rows.is_contiguous()):
        raise ValueError("idx and rows must be contiguous")
    check_on(idx.device, rows)
    ntiles = idx.shape[0] // TILE
    out = torch.empty((ntiles, 1), dtype=torch.float32, device=idx.device)
    fn = (lib or cuda_build.load("gather_probe")).ds_gather_probe
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    cuda_build.check(
        fn(cuda_build.ptr(idx), cuda_build.ptr(rows), int(width), ntiles, int(run),
           cuda_build.ptr(out), cuda_build.stream_handle()),
        "gather probe kernel",
    )
    (coalesced if run else per_lane).launches += 1
    return out


def per_lane(idx: torch.Tensor, rows: torch.Tensor, width: int) -> torch.Tensor:
    """P1's wrapper: the kernel for CUDA tensors, ``per_lane_plain`` for
    CPU tensors.  Raises unless every index lies in ``[0, nrows)``."""
    if idx.is_cuda:
        _check_bounds(idx, rows.shape[0] // width, 0)
        return _launch(idx, rows, width, 0)
    return per_lane_plain(idx, rows, width)


def coalesced(idx: torch.Tensor, rows: torch.Tensor, width: int, run: int) -> torch.Tensor:
    """P2's wrapper: the kernel for CUDA tensors, ``coalesced_plain`` for
    CPU tensors.  Raises unless every used start lies in ``[0, nrows -
    run]``."""
    if idx.is_cuda:
        _check_bounds(idx, rows.shape[0] // width, run)
        return _launch(idx, rows, width, run)
    return coalesced_plain(idx, rows, width, run)


#: Kernel launches so far (counted where each kernel is launched).
per_lane.launches = 0
coalesced.launches = 0


def make_case(
    kind: str, nrows: int, width: int, batch: int, run: int = 32, seed: int = 0,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The probe's inputs on ``device``: ``rows`` uint8 [nrows * width],
    random bytes in [0, 255) from ``torch.Generator(seed)``, and the int32
    index of ``kind`` (numpy ``default_rng(seed)``, the tool's layout)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randint(0, 255, (nrows * width,), dtype=torch.uint8, device=dev, generator=gen)
    rng = np.random.default_rng(seed)
    ntiles = batch // TILE
    if kind == "per_lane":
        idx = rng.integers(0, nrows, batch).astype(np.int32)
    elif kind == "coalesced":
        per = TILE // run
        idx = np.zeros((ntiles, TILE), np.int32)
        idx[:, :per] = rng.integers(0, max(1, nrows - run), (ntiles, per))
        idx = idx.reshape(-1)
    else:
        raise ValueError(f"kind must be per_lane or coalesced, got {kind!r}")
    return rows, torch.from_numpy(idx).to(dev)


def _events_ms(fn, args: Sequence) -> float:
    """Mean device ms of ``fn(a)`` over ``args``, one warm-up call first."""
    fn(args[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for a in args:
        fn(a)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(args)


def measure(
    kind: str, nrows: int, width: int, batch: int, run: int = 32, reps: int = 10,
    device="cuda",
) -> Dict:
    """Check one case against the plain version (the sums must be equal)
    and time it on the card with CUDA events, each rep on a distinct index
    set (the index rolled by ``k + 1``, as the Pallas probe does).

    Returns the report entry: ``kind`` (``per_lane`` or ``coalesced_<run>``),
    ``nrows``, ``row_bytes``, ``mrows_per_s``, ``gb_per_s`` (rows gathered,
    repeats included), ``ms``, ``bound_ms`` (the distinct rows the index
    sets name, read once, plus the index and the output, at the HBM rate),
    ``plain_ms`` and ``library_ms`` (``index_select`` + ``sum``, two
    PyTorch calls, on the same index sets).  Raises on a CPU device: the
    probe's numbers are device times."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the gather probe times the card; it has no CPU measurement")
    rows, idx = make_case(kind, nrows, width, batch, run, device=dev)
    if kind == "per_lane":
        run = 0
        plain = lambda i: per_lane_plain(i, rows, width)  # noqa: E731
    else:
        plain = lambda i: coalesced_plain(i, rows, width, run)  # noqa: E731
    salts = [torch.roll(idx, k + 1) for k in range(reps)]
    for i in [idx] + salts:
        _check_bounds(i, nrows, run)
    # The timed launches skip the wrappers' per-call bounds check (a device
    # sync); every index set was checked above.
    kern = lambda i: _launch(i, rows, width, run)  # noqa: E731
    got, want = kern(idx), plain(idx)
    if not torch.equal(got, want):
        raise RuntimeError(f"{kind}: kernel sums differ from the plain version")
    ms = _events_ms(kern, salts)
    plain_ms = _events_ms(plain, salts)
    rows2d = rows.reshape(-1, width)
    offs = torch.arange(max(run, 1), dtype=torch.int64, device=dev)
    lib_idx = [(_used(s, run).to(torch.int64)[..., None] + offs).reshape(-1) for s in salts]
    library_ms = _events_ms(lambda i: rows2d.index_select(0, i).sum(dtype=torch.int64), lib_idx)
    ntiles = batch // TILE
    distinct = float(np.mean([torch.unique(i).numel() for i in lib_idx]))
    n_bytes = distinct * width + _used(idx, run).numel() * 4 + ntiles * 4
    return {
        "kind": kind if kind == "per_lane" else f"coalesced_{run}",
        "nrows": nrows,
        "row_bytes": width,
        "mrows_per_s": batch / (ms * 1e-3) / 1e6,
        "gb_per_s": batch * width / (ms * 1e-3) / 1e9,
        "ms": ms,
        "distinct_rows": distinct,
        "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "max_abs_err": float((got - want).abs().max().item()),
    }


def variants(cases=VARIANT_CASES, reps: int = 10, device="cuda") -> Dict:
    """P1 in each design of ``P1_DESIGNS`` on each case: the sums must
    equal ``per_lane_plain``'s; each design's ms (CUDA events over ``reps``
    index sets, as ``measure``) measured in turns, forward then backward
    over the designs, twice.  Returns ``{case: {design: {"equal", "ms"}}}``
    with cases named ``<nrows>x<width>B``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the gather probe times the card; it has no CPU measurement")
    lib = cuda_build.load("gather_variants")
    lib.ds_gather_design.argtypes = [ctypes.c_int]
    lib.ds_gather_design.restype = None
    out: Dict[str, Dict] = {}
    for nrows, width, batch in cases:
        rows, idx = make_case("per_lane", nrows, width, batch, device=dev)
        salts = [torch.roll(idx, k + 1) for k in range(reps)]
        for i in [idx] + salts:
            _check_bounds(i, nrows, 0)
        want = per_lane_plain(idx, rows, width)
        case: Dict[str, Dict] = {}
        fns = {}
        for name, design in P1_DESIGNS.items():
            def run(i, design=design):
                lib.ds_gather_design(design)
                return _launch(i, rows, width, 0, lib=lib)

            case[name] = {"equal": torch.equal(run(idx), want), "ms": []}
            fns[name] = run
        names = list(fns)
        for name in (names + names[::-1]) * 2:
            case[name]["ms"].append(_events_ms(fns[name], salts))
        out[f"{nrows}x{width}B"] = case
    return out


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the probe's cases on the card, print one line each, and return
    the report (``tile``, ``device``, ``results``); with ``--json PATH``
    also write it there."""
    argv = sys.argv[1:] if argv is None else argv
    out_json = argv[argv.index("--json") + 1] if "--json" in argv else None
    dev = resolve_device("cuda")
    report = {"tile": TILE, "device": torch.cuda.get_device_name(dev)}
    results = []
    for nrows, width, batch in CASES:
        for kind, run in [("per_lane", 0)] + [("coalesced", r) for r in RUNS]:
            r = measure(kind, nrows, width, batch, run=run, device=dev)
            print(
                f"{r['kind']} {nrows}x{width}B: {r['mrows_per_s']:.1f} Mrows/s "
                f"{r['gb_per_s']:.1f} GB/s ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                f"index_select+sum_ms={r['library_ms']:.4f}",
                flush=True,
            )
            results.append(r)
    report["results"] = results
    if out_json:
        with open(out_json, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {out_json}")
    return report


if __name__ == "__main__":
    main()
