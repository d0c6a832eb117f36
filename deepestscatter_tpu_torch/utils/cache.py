"""Where the kernels' builds persist.

The port of ``deepestscatter_tpu.utils.cache``: the JAX package turns on
XLA's on-disk compilation cache; this package's compiled programs are its
kernel libraries, which ``cuda_build`` builds at first use into a
directory keyed by a digest of the sources (``_build/`` beside the
package by default), so that every process after the first loads them.
"""

from __future__ import annotations

import os
from pathlib import Path

from .. import cuda_build

#: The environment variable that names the build directory.
ENV = "DS_TORCH_BUILD_DIR"


def enable_persistent_cache(path: str | None = None) -> str:
    """Point ``cuda_build`` at ``path`` (else ``$DS_TORCH_BUILD_DIR``, else
    the package's ``_build/``) → the directory.  Idempotent; the directory
    is made at the first build."""
    build = Path(path or os.environ.get(ENV) or cuda_build._PKG / "_build").resolve()
    cuda_build.BUILD_DIR = build
    return str(build)
