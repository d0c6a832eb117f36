"""The RPNN ("Deep Scattering") neural renderer.

The port of ``deepestscatter_tpu.render.neural`` (reference:
DisneyRenderer.cpp, disneyCamera.cu, disneyDescriptorMaterial.cu):

- two-pass conditional scatter: march once for the total transmittance T,
  then draw the scatter point from ``od = 1 - u (1 - T)``;
- direct radiance = NEE at the scatter point with the full Mie phase;
- the 10-layer descriptor with omega appended, through ``DisneyModel``;
- composite ``(predicted + direct) * (1 - T)`` for scattered rays; black for
  box hits that do not scatter; sun / sky for misses.

Both marches run in kernel K1 (``ops.march.camera_march``), the descriptor
in K2 (``ops.descriptor.network_inputs``); the MLP is ``torch.nn.Linear``
in full float32 (TF32 switched off on the card).

``DisneyRenderer.render_frame`` is the frame schedule: a whole-frame box
pass, the pass-1 march compacted to box hits, the pass-2 march compacted
to ``hit & T < 1`` (exactly the rays that can scatter, since od lies in
(T, 1]), then descriptor + MLP on the scattered pixels only, in tiles of
``TILE`` rows to bound the descriptor tensor.  Compaction is
``torch.nonzero`` plus index scatter; each stage launches once over its
compacted rays (the JAX package's fixed-shape tiles are a compile-cache
device, not needed here).  ``render_disney`` is the megabatch render of the
same frame, the schedule's oracle.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from ..device import check_on, resolve_device
from ..models.rpnn import DisneyModel
from ..ops import descriptor as desc_ops
from ..ops import march as march_ops
from ..scene import SceneParams, SceneStatic
from . import camera as camera_ops


class ConditionalScatter(NamedTuple):
    """Per-ray result of the neural camera."""

    transmittance: torch.Tensor  # [N] total T through the cloud
    scatter_pos: torch.Tensor  # [N, 3] local coords
    has_scattered: torch.Tensor  # [N] bool
    direct: torch.Tensor  # [N, 3] NEE radiance at the scatter point


def exact_float32_matmul() -> None:
    """Full float32 products on the card: no TF32 in matmuls or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def march_pass1(params, static, entry, dirs) -> torch.Tensor:
    """Total-transmittance march of a ray batch (od = 0, never scatters)."""
    return march_ops.camera_march(params, static, entry, dirs).transmittance


def march_pass2(params, static, entry, dirs, seed, ray_ids, trans):
    """Conditional scatter draw + NEE of a ray batch, keyed by global ray
    id → (scatter_pos, ok, direct)."""
    m = march_ops.camera_march(
        params, static, entry, dirs, seed=seed, ray_ids=ray_ids, trans_total=trans
    )
    return m.scatter_pos, m.ok, m.direct


def conditional_scatter(
    params: SceneParams,
    static: SceneStatic,
    entry: torch.Tensor,
    dirs: torch.Tensor,
    hit: torch.Tensor,
    seed,
    ray_ids: torch.Tensor,
) -> ConditionalScatter:
    """Both camera marches over every ray of a batch (the megabatch form)."""
    trans = march_pass1(params, static, entry, dirs)
    pos, ok, direct = march_pass2(params, static, entry, dirs, seed, ray_ids, trans)
    ok = ok & hit
    direct = torch.where(ok[:, None], direct, torch.zeros_like(direct))
    return ConditionalScatter(trans, pos, ok, direct)


def composite(
    predicted: torch.Tensor,
    cs: ConditionalScatter,
    miss: torch.Tensor,
    hit: torch.Tensor,
) -> torch.Tensor:
    """``(predicted + direct) * (1 - T)`` for scattered rays; black for
    non-scattering hits; sun/sky for misses."""
    scattered_rgb = (predicted[:, None] + cs.direct) * (
        1.0 - cs.transmittance[:, None]
    )
    out = torch.where(
        cs.has_scattered[:, None], scattered_rgb, torch.zeros_like(scattered_rgb)
    )
    return torch.where(hit[:, None], out, miss)


def shade_disney(
    params: SceneParams,
    static: SceneStatic,
    model: DisneyModel,
    pos: torch.Tensor,
    dirs: torch.Tensor,
) -> torch.Tensor:
    """Descriptor + RPNN forward at shading points → predicted radiance [N]."""
    inputs = desc_ops.network_inputs(params, static, pos, dirs)
    return model(inputs)[:, 0]


def compact_apply(
    mask: torch.Tensor,
    arrays: Sequence[torch.Tensor],
    fn: Callable[..., Any],
    tile: Optional[int] = None,
) -> Tuple[Optional[torch.Tensor], Any, int]:
    """Run ``fn`` on the rows where ``mask`` holds.

    Returns ``(idx, out, count)``: ``idx`` the [count] row indices, ``out``
    what ``fn`` returned for the gathered rows (an array or a tuple, rows
    concatenated over tiles of at most ``tile`` rows), or
    ``(None, None, 0)`` when the mask is empty."""
    idx = torch.nonzero(mask).flatten()
    count = int(idx.numel())
    if count == 0:
        return None, None, 0
    gathered = [a.index_select(0, idx) for a in arrays]
    step = count if tile is None else tile
    outs = [fn(*(g[s : s + step] for g in gathered)) for s in range(0, count, step)]
    if len(outs) == 1:
        return idx, outs[0], count
    if isinstance(outs[0], tuple):
        return idx, tuple(torch.cat(o) for o in zip(*outs)), count
    return idx, torch.cat(outs), count


class CompactCamera:
    """The compacted neural camera: box pass over the frame, pass 1 over
    box hits, pass 2 over ``hit & T < 1``.  Produces the same
    ``(cs, hit, miss)`` as the megabatch ``conditional_scatter``."""

    def __init__(self):
        #: (n_rays, box hits, scatterable T<1) of the last frame.
        self.last_counts = (0, 0, 0)

    def run(
        self,
        params: SceneParams,
        static: SceneStatic,
        origins: torch.Tensor,
        directions: torch.Tensor,
        seed,
        ray_ids: torch.Tensor,
    ):
        n = origins.shape[0]
        dev = origins.device
        hit, t_hit = camera_ops.intersect_box(
            origins, directions, static, params.bbox_size
        )
        entry = camera_ops.entry_points(origins, directions, t_hit, params.bbox_size)
        miss = camera_ops.miss_radiance(params, static, directions)
        trans = torch.ones((n,), dtype=torch.float32, device=dev)
        pos = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        scat = torch.zeros((n,), dtype=torch.bool, device=dev)
        direct = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        idx, t_c, n_hit = compact_apply(
            hit, (entry, directions),
            lambda e, d: march_pass1(params, static, e, d),
        )
        n_scat = 0
        if idx is not None:
            trans[idx] = t_c
            idx2, out2, n_scat = compact_apply(
                hit & (trans < 1.0),
                (entry, directions, ray_ids, trans),
                lambda e, d, i, t: march_pass2(params, static, e, d, seed, i, t),
            )
            if idx2 is not None:
                p_c, ok_c, d_c = out2
                pos[idx2] = p_c
                scat[idx2] = ok_c
                direct[idx2] = d_c
        self.last_counts = (n, n_hit, n_scat)
        return ConditionalScatter(trans, pos, scat, direct), hit, miss


def shade_compacted(
    shade_one: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    cs: ConditionalScatter,
    directions: torch.Tensor,
    tile: int,
) -> torch.Tensor:
    """Run the shade stage only where the camera scattered, ``tile`` rows at
    a time; rows elsewhere predict 0.  Every shade op is row-independent,
    so values equal shading the whole buffer."""
    n = directions.shape[0]
    pred = torch.zeros((n,), dtype=torch.float32, device=directions.device)
    idx, out, _ = compact_apply(
        cs.has_scattered, (cs.scatter_pos, directions), shade_one, tile
    )
    if idx is not None:
        pred[idx] = out
    return pred


def _prepare(device, params: SceneParams, model: DisneyModel) -> torch.device:
    dev = resolve_device(device)
    check_on(dev, params.density_mips[0], next(model.parameters()))
    if dev.type == "cuda":
        exact_float32_matmul()
    return dev


def render_disney(
    params: SceneParams,
    static: SceneStatic,
    model: DisneyModel,
    origins: torch.Tensor,
    directions: torch.Tensor,
    seed: int = 0,
    ray_ids: Optional[torch.Tensor] = None,
    device="cuda",
) -> torch.Tensor:
    """One RPNN render of a ray batch → radiance [N, 3], every ray marched
    and shaded in one batch.  Deterministic given ``seed``."""
    dev = _prepare(device, params, model)
    check_on(dev, origins, directions)
    n = origins.shape[0]
    if ray_ids is None:
        ray_ids = torch.arange(n, dtype=torch.int64, device=dev)
    with torch.inference_mode():
        hit, t_hit = camera_ops.intersect_box(
            origins, directions, static, params.bbox_size
        )
        entry = camera_ops.entry_points(origins, directions, t_hit, params.bbox_size)
        cs = conditional_scatter(params, static, entry, directions, hit, seed, ray_ids)
        predicted = shade_disney(params, static, model, cs.scatter_pos, directions)
        predicted = torch.where(
            cs.has_scattered, predicted, torch.zeros_like(predicted)
        )
        miss = camera_ops.miss_radiance(params, static, directions)
        return composite(predicted, cs, miss, hit)


class DisneyRenderer:
    """Frame-level renderer (the reference's DisneyRenderer strategy
    object): holds the model and renders full frames with the compacted
    schedule."""

    #: Shade rows per descriptor + MLP launch: bounds the [TILE, 10, 226]
    #: float32 descriptor tensor (~148 MB at 16384 rows).
    TILE = 16384

    def __init__(self, model: DisneyModel, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self._camera = CompactCamera()

    @property
    def last_counts(self):
        """(n_rays, box hits, scattered) of the last frame."""
        return self._camera.last_counts

    def render_frame(
        self,
        params: SceneParams,
        static: SceneStatic,
        width: int,
        height: int,
        basis: camera_ops.CameraBasis,
        seed: int = 0,
    ) -> torch.Tensor:
        dev = _prepare(self.device, params, self.model)
        with torch.inference_mode():
            origins, directions = camera_ops.generate_rays(basis, width, height, dev)
            ray_ids = torch.arange(origins.shape[0], dtype=torch.int64, device=dev)
            cs, hit, miss = self._camera.run(
                params, static, origins, directions, seed, ray_ids
            )
            predicted = shade_compacted(
                lambda p, d: shade_disney(params, static, self.model, p, d),
                cs,
                directions,
                self.TILE,
            )
            out = composite(predicted, cs, miss, hit)
            return out.reshape(height, width, 3)
