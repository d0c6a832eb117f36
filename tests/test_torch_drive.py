"""The port's drive script (``drive_render_torch.py``) on the CPU.

It runs at ``--device cpu`` on the 64^3 cumulus (the smallest of the
procedural clouds with empty occupancy blocks, so that the block skip's
tick has steps to skip) at 600 m, 8 x 4 pixels, one tick of one subframe,
``max_depth`` 8, and must end with ``ALL DRIVE STEPS PASSED``; its default
device is the card, so without one it raises; it imports nothing of JAX.
"""

import ast
from pathlib import Path

import pytest
import torch

import drive_render_torch

SCRIPT = Path(drive_render_torch.__file__)
TINY = ["--device", "cpu", "--res", "64", "--width", "8", "--height", "4", "--ticks", "1",
        "--subframes", "1", "--max-depth", "8", "--size-m", "600"]


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_drive_passes_on_the_cpu(capsys, tmp_path):
    assert drive_render_torch.main(TINY + ["--out", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "ALL DRIVE STEPS PASSED"
    assert any(line.startswith("PT tick, cell jump") for line in lines)
    assert any(line.startswith("PT tick, block skip") for line in lines)
    assert (tmp_path / "pt.exr").is_file() and (tmp_path / "nn.exr").is_file()


def test_drive_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        drive_render_torch.main([])


def test_drive_imports_no_jax():
    tree = ast.parse(SCRIPT.read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "deepestscatter_tpu")]
