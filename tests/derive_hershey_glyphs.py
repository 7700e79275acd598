"""Write `jdet_torch/utils/hershey_simplex.npz`, the glyph table of the
port's `put_text`, from cv2's own renderings.

    python tests/derive_hershey_glyphs.py

For each scale the reference draws text at (0.5 and 0.4) and each
printable ASCII character, cv2 draws the character alone, white on black,
with `FONT_HERSHEY_SIMPLEX`, thickness 1 and LINE_AA: the drawn values
are its coverage (cv2 blends `(bg * (255 - a) + color * a + 127) // 255`).
The table keeps the mask's bounding box, the box's corner relative to the
pen (the text origin), and the pen's advance, `getTextSize(c)[0] - 1`
(cv2 5.0 places each glyph at an integer pen position; its widths add up).
`tests/test_torch_vis.py` holds `put_text` to cv2 on strings.
"""
from __future__ import annotations

import os

import cv2
import numpy as np

SCALES = (0.5, 0.4)
OUT = os.path.join(os.path.dirname(__file__), "..", "jdet_torch", "utils",
                   "hershey_simplex.npz")


def glyph(ch, scale, canvas=96, org=(32, 64)):
    img = np.zeros((canvas, canvas, 3), np.uint8)
    cv2.putText(img, ch, org, cv2.FONT_HERSHEY_SIMPLEX, scale, (255, 255, 255), 1,
                cv2.LINE_AA)
    a = img[..., 0]
    assert (a == img[..., 1]).all() and (a == img[..., 2]).all()
    ys, xs = np.nonzero(a)
    if len(ys) == 0:
        return np.zeros((0, 0), np.uint8), (0, 0)
    assert ys.min() > 0 and xs.min() > 0 and ys.max() < canvas - 1 and xs.max() < canvas - 1
    y0, x0 = ys.min(), xs.min()
    return a[y0:ys.max() + 1, x0:xs.max() + 1], (x0 - org[0], y0 - org[1])


def main():
    chars = [chr(c) for c in range(32, 127)]
    masks = [[glyph(ch, s) for ch in chars] for s in SCALES]
    gh = max(m.shape[0] for row in masks for m, _ in row)
    gw = max(m.shape[1] for row in masks for m, _ in row)
    alpha = np.zeros((len(SCALES), len(chars), gh, gw), np.uint8)
    origin = np.zeros((len(SCALES), len(chars), 2), np.int16)
    size = np.zeros((len(SCALES), len(chars), 2), np.int16)
    advance = np.zeros((len(SCALES), len(chars)), np.int16)
    for j, s in enumerate(SCALES):
        for i, ch in enumerate(chars):
            m, o = masks[j][i]
            alpha[j, i, :m.shape[0], :m.shape[1]] = m
            origin[j, i] = o
            size[j, i] = (m.shape[1], m.shape[0])
            advance[j, i] = cv2.getTextSize(ch, cv2.FONT_HERSHEY_SIMPLEX, s, 1)[0][0] - 1
    np.savez_compressed(OUT, scales=np.asarray(SCALES), alpha=alpha, origin=origin,
                        size=size, advance=advance)
    print(f"wrote {os.path.normpath(OUT)}: {len(chars)} glyphs x {len(SCALES)} scales, "
          f"masks {gh} x {gw}")


if __name__ == "__main__":
    main()
