"""Draw detector-dataset annotations over their images (port of
``mass_tpu.tools.visualize_dataset``; reference: visualize_dataset.py,
which uses detectron2's Visualizer).  Images are read through cv2
(``tools/detector_dataset.read_png``); matplotlib is imported only when
a record is drawn.

    python -m mass_tpu_torch.tools.visualize_dataset --dataset d --out viz
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from mass_tpu_torch import taxonomy
from mass_tpu_torch.tools.detector_dataset import read_png


def draw_record(record, out_dir: str) -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import patches

    rgb = read_png(record["file_name"])
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(rgb)
    colors = taxonomy.class_colors_array()
    for ann in record["annotations"]:
        x, y, w, h = ann["bbox"]
        cls = ann["category_id"] + 1  # detector ids skip OccupiedSpace
        color = colors[cls]
        ax.add_patch(patches.Rectangle((x, y), w, h, fill=False,
                                       edgecolor=color, linewidth=2))
        ax.text(x, max(y - 2, 0), taxonomy.CLASS_NAMES[cls],
                color=color, fontsize=8)
        for poly in ann.get("segmentation", []):
            pts = np.asarray(poly).reshape(-1, 2)
            ax.add_patch(patches.Polygon(pts, fill=False,
                                         edgecolor=color,
                                         linewidth=1, linestyle=":"))
    ax.axis("off")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir,
                       f"viz-{record['image_id']}.png")
    fig.savefig(out, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out


def main(argv=None):
    p = argparse.ArgumentParser("dataset visualizer")
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--limit", type=int, default=16)
    args = p.parse_args(argv)
    with open(os.path.join(args.dataset, "training.json")) as f:
        records = json.load(f)
    for rec in records[:args.limit]:
        print(draw_record(rec, args.out))


if __name__ == "__main__":
    main()
