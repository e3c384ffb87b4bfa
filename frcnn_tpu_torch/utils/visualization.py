"""Box drawing (``frcnn_tpu/utils/visualization.py``) with PIL, for the
ground-truth image summary.  PIL is imported inside the call, so the
package imports without it; the train driver skips the image where PIL is
missing."""

from __future__ import annotations

import numpy as np

STANDARD_COLORS = [
    "AliceBlue", "Chartreuse", "Aqua", "Aquamarine", "Azure", "Beige",
    "Bisque", "BlanchedAlmond", "BlueViolet", "BurlyWood", "CadetBlue",
    "AntiqueWhite", "Chocolate", "Coral", "CornflowerBlue", "Cornsilk",
    "Crimson", "Cyan", "DarkCyan", "DarkGoldenRod", "DarkGrey", "DarkKhaki",
    "DarkOrange", "DarkOrchid", "DarkSalmon", "DarkSeaGreen", "DarkTurquoise",
    "DarkViolet", "DeepPink", "DeepSkyBlue", "DodgerBlue", "FireBrick",
    "FloralWhite", "ForestGreen", "Fuchsia", "Gainsboro", "GhostWhite",
    "Gold", "GoldenRod", "Salmon", "Tan", "HoneyDew", "HotPink", "IndianRed",
]


def draw_bounding_boxes(image, boxes, labels, class_names=None):
    """image (H, W, 3) uint8 RGB, boxes (N, 4) [x1, y1, x2, y2], labels (N,)
    class ids → a new (H, W, 3) uint8 array with the boxes and their class
    names drawn."""
    from PIL import Image, ImageDraw, ImageFont

    pil = Image.fromarray(image.astype(np.uint8))
    draw = ImageDraw.Draw(pil)
    font = ImageFont.load_default()
    for box, label in zip(np.asarray(boxes), np.asarray(labels)):
        cls = int(label)
        color = STANDARD_COLORS[cls % len(STANDARD_COLORS)]
        x1, y1, x2, y2 = [float(v) for v in box[:4]]
        draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
        if class_names is not None:
            draw.text((x1 + 2, max(0.0, y1 - 12)), class_names[cls], fill=color, font=font)
    return np.asarray(pil)
