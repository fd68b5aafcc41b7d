"""Top-down map rendering and agent/path overlays (port of
``mass_tpu.utils.visualization``).

Density and class-color renders of the voxel maps, with the agent drawn
as an oriented triangle and the planned path as polylines.  The map
reductions run on the map's device and only an ``[H, W]`` array crosses
to the host: a full-width semantic map is 3.06 GB of float32, its
density 590 KB, its class labels 295 KB.  The drawing is the JAX
package's numpy, cv2-free (triangles rasterize by half-plane tests,
lines by dense sampling); colour lookups and resizes gather with
``np.take``, several times faster than fancy indexing on a host core,
and give the same values.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from mass_tpu_torch import taxonomy


def _draw_line(image: np.ndarray, p0, p1, color, thickness: int = 1):
    h, w = image.shape[:2]
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    n = int(np.linalg.norm(p1 - p0) * 2) + 2
    ts = np.linspace(0.0, 1.0, n)
    pts = p0[None] + ts[:, None] * (p1 - p0)[None]
    r = max(thickness // 2, 0)
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            xs = np.clip(np.round(pts[:, 0] + dx), 0, w - 1).astype(int)
            ys = np.clip(np.round(pts[:, 1] + dy), 0, h - 1).astype(int)
            image[ys, xs] = color
    return image


def _fill_triangle(image: np.ndarray, verts, color):
    h, w = image.shape[:2]
    v = np.asarray(verts, np.float32)
    x0, y0 = np.floor(v.min(0)).astype(int)
    x1, y1 = np.ceil(v.max(0)).astype(int)
    x0, y0 = max(x0, 0), max(y0, 0)
    x1, y1 = min(x1, w - 1), min(y1, h - 1)
    if x1 < x0 or y1 < y0:
        return image
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    pts = np.stack([xs, ys], -1).astype(np.float32)

    def edge(a, b, p):
        return ((b[0] - a[0]) * (p[..., 1] - a[1]) -
                (b[1] - a[1]) * (p[..., 0] - a[0]))

    e0, e1, e2 = (edge(v[0], v[1], pts), edge(v[1], v[2], pts),
                  edge(v[2], v[0], pts))
    inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | \
             ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
    region = image[y0:y1 + 1, x0:x1 + 1]
    region[inside] = color
    return image


def draw_agent(image: np.ndarray, y: float, x: float, yaw: float,
               size: int = 6, fill=(1.0, 0.0, 0.0),
               outline=(0.0, 0.0, 0.0)):
    """Oriented triangle at (x, y) image coords, pointing along ``-yaw``
    (image y grows downward; reference:
    mass/utils/visualization.py:7-87)."""
    a = -yaw
    verts = [
        (x + size / 1.5 * np.cos(a + np.pi * 4 / 3),
         y + size / 1.5 * np.sin(a + np.pi * 4 / 3)),
        (x + size * np.cos(a), y + size * np.sin(a)),
        (x + size / 1.5 * np.cos(a - np.pi * 4 / 3),
         y + size / 1.5 * np.sin(a - np.pi * 4 / 3)),
    ]
    _fill_triangle(image, verts, fill)
    for i in range(3):
        _draw_line(image, verts[i], verts[(i + 1) % 3], outline)
    return image


def render_occupancy(vm, position_cell=None, yaw: float = 0.0,
                     path_cells: Optional[np.ndarray] = None,
                     z_start: int = 4, z_stop: int = 32) -> np.ndarray:
    """White free space / dark density render with path and agent overlay
    (reference: mass/utils/visualization.py:90-180).  The L2 norm over
    the features and the max over the z slice reduce the map on its
    device; the ``[H, W]`` density is normalized on the host."""
    sl = vm.grid()[:, :, z_start:z_stop]
    density = torch.linalg.vector_norm(sl, ord=2, dim=-1).amax(dim=-1)
    density = density.cpu().numpy()
    peak = density.max()
    if peak > 0:
        density = np.clip(density / peak, 0, 1)
    image = np.repeat((1.0 - density)[..., None], 3, axis=-1)

    if path_cells is not None and len(path_cells) > 1:
        for i in range(len(path_cells) - 1):
            _draw_line(image, path_cells[i][:2], path_cells[i + 1][:2],
                       (1.0, 0.0, 0.0))
    if position_cell is not None:
        snapped = np.pi / 4 * np.round(yaw / (np.pi / 4))
        draw_agent(image, float(position_cell[1]),
                   float(position_cell[0]), snapped)
    return image.astype(np.float32, copy=False)


def render_semantic(vm, z_start: int = 0, z_stop: int = 32,
                    boxes: Optional[Sequence] = None) -> np.ndarray:
    """Class-color render of the top-down semantic map; white where
    empty; detection boxes outlined (reference:
    mass/nn/applications/semantic_projection_layer.py:218-255).  The
    top-down view, its argmax (the first maximum, as numpy's) and the
    empty mask are taken on the map's device; an empty cell comes back
    as the label one past the classes, whose colour is white."""
    colors = taxonomy.class_colors_array()
    top = vm.top_down(z_start, z_stop)
    empty = ~(top != 0).any(dim=-1)
    labels = torch.where(empty, len(colors), torch.argmax(top, dim=-1))
    table = np.concatenate([colors, np.ones((1, 3), np.float32)])
    image = np.take(table, labels.to(torch.int16).cpu().numpy(), axis=0)
    if boxes is not None:
        for x, y, w, h in boxes:
            for p0, p1 in (((x, y), (x + w, y)),
                           ((x + w, y), (x + w, y + h)),
                           ((x + w, y + h), (x, y + h)),
                           ((x, y + h), (x, y))):
                _draw_line(image, p0, p1, (1.0, 0.0, 0.0))
    return image


def episode_frame(rgb: np.ndarray, *panels: np.ndarray) -> np.ndarray:
    """Side-by-side frame: camera view + map panels, heights matched by
    nearest-neighbor resize (reference: agent.py:51-104)."""
    h = rgb.shape[0]
    row = [rgb]
    for panel in panels:
        ph, pw = panel.shape[:2]
        scale = h / ph
        ys = np.clip((np.arange(h) / scale), 0, ph - 1).astype(int)
        xs = np.clip((np.arange(int(pw * scale)) / scale), 0,
                     pw - 1).astype(int)
        row.append(np.take(np.take(panel, ys, axis=0), xs, axis=1))
    return np.concatenate(row, axis=1)


def render_feature_query(vm, query_embeddings: np.ndarray,
                         z_start: int = 0, z_stop: int = 32,
                         temperature: float = 100.0) -> np.ndarray:
    """Text/feature-query similarity heat-map over a feature map's top-
    down view (the CLIP map's query visualization, reference:
    mass/nn/applications/clip_projection_layer.py:227-281): softmax over
    queries of scaled cosine similarity, rendered as the first query's
    probability.  Computed on the map's device; ``[H, W]`` comes back."""
    top = vm.top_down(z_start, z_stop)                        # [H, W, F]
    feat = top / (torch.linalg.vector_norm(top, dim=-1, keepdim=True)
                  + 1e-9)
    q = torch.as_tensor(np.asarray(query_embeddings, np.float32),
                        device=top.device)
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-9)
    logits = temperature * torch.einsum("hwf,qf->hwq", feat, q)
    heat = torch.softmax(logits, dim=-1)[..., 0].cpu().numpy()
    empty = (~(top != 0).any(dim=-1)).cpu().numpy()
    image = np.stack([heat, np.zeros_like(heat), 1.0 - heat], axis=-1)
    image[empty] = 1.0
    return image.astype(np.float32)
