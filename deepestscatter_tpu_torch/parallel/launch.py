"""Run a function on several ranks, a process each, over one process group.

``run("package.module:function", world_size, device=..., **kwargs)``
starts ``world_size`` Python processes (``python -m
deepestscatter_tpu_torch.parallel.launch``), each of which joins the
group at ``tcp://localhost:<a free port>`` with its rank, calls
``function(device=device, **kwargs)`` and returns what it returned
(through a file).
The backend is NCCL where every rank has a card of its own, else gloo
(the CPU, or ranks that share one card).  The tests, ``chip_smoke.py``
and ``graft.dryrun_multichip`` drive their worlds through it; under
``torchrun`` a program calls ``mesh.initialize_distributed`` instead.
"""

from __future__ import annotations

import datetime
import importlib
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

#: The directory that holds the package (put on the ranks' PYTHONPATH).
_ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def backend_for(world_size: int, device="cuda") -> str:
    """NCCL where each of the ranks has a card of its own, else gloo."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def run(target: str, world_size: int, device="cuda", backend: Optional[str] = None,
        timeout: float = 600.0, threads: int = 2, **kwargs) -> List[Any]:
    """``target`` (``"module:function"``) on ``world_size`` ranks, each
    process joining one group (``backend`` default ``backend_for``) →
    the ranks' return values, in rank order.  Raises with a failed rank's
    error output, after stopping the others; or when ``timeout`` seconds
    pass.  ``threads``: torch's CPU threads a rank."""
    dev = resolve_device(device)
    backend = backend or backend_for(world_size, dev)
    with tempfile.TemporaryDirectory(prefix="ds_ranks_") as tmp:
        job = Path(tmp) / "job.pt"
        torch.save(dict(target=target, world_size=world_size, port=free_port(),
                        backend=backend, device=str(dev),
                        kwargs=dict(kwargs, device=str(dev)), threads=threads,
                        timeout=timeout, out=str(Path(tmp) / "rank{}.pt")), job)
        env = dict(os.environ, OMP_NUM_THREADS=str(threads))
        env["PYTHONPATH"] = os.pathsep.join(
            [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        procs = []
        for rank in range(world_size):
            err = open(Path(tmp) / f"rank{rank}.err", "w+")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "deepestscatter_tpu_torch.parallel.launch", str(job),
                 str(rank)], env=env, stdout=err, stderr=subprocess.STDOUT, cwd=tmp), err))
        t_end = time.time() + timeout
        try:
            while any(p.poll() is None for p, _ in procs) and time.time() < t_end:
                if any(p.poll() not in (None, 0) for p, _ in procs):
                    break  # a rank failed: stop the others
                time.sleep(0.05)
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
            for p, _ in procs:
                p.wait()
        logs = []
        for _, err in procs:
            err.seek(0)
            logs.append(err.read())
            err.close()
        bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
        if bad:
            # The first rank that exited on its own (not killed), else rank bad[0].
            r = next((r for r in bad if procs[r][0].returncode > 0), bad[0])
            raise RuntimeError(f"{target} on {world_size} ranks ({backend}): rank {r} failed "
                               f"(exit {procs[r][0].returncode}; timeout {timeout} s):\n"
                               f"{logs[r][-6000:]}")
        return [torch.load(str(Path(tmp) / f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]


def _rank_main(job_path: str, rank: int) -> None:
    job = torch.load(job_path, weights_only=False)
    torch.set_num_threads(job["threads"])
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        job["backend"], init_method=f"tcp://localhost:{job['port']}",
        world_size=job["world_size"], rank=rank,
        timeout=datetime.timedelta(seconds=job["timeout"]))
    try:
        module, name = job["target"].split(":")
        out = getattr(importlib.import_module(module), name)(**job["kwargs"])
        torch.save(out, job["out"].format(rank))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
