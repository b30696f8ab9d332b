"""Terminal image rendering (port of ``extended_gan_tpu/utils/term.py``).

The reference prints prediction frames into the terminal through the
``climage`` package; this renders them with ANSI 256-colour half-block
characters (two pixels a character cell), without dependencies.
"""

from __future__ import annotations

import numpy as np

_RESET = "\x1b[0m"


def _gray_code(v: float) -> int:
    """[0, 1] onto the ANSI 256-colour grey ramp (232..255)."""
    return 232 + int(np.clip(v, 0.0, 1.0) * 23.999)


def render_image(img: np.ndarray, width: int = 40) -> str:
    """A 2-D array as ANSI half-blocks, normalised to its range."""
    img = np.asarray(img, np.float32)
    lo, hi = float(img.min()), float(img.max())
    img = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
    _, w = img.shape
    step = max(1, w // width)
    img = img[:: step * 2 // 2][:, ::step]  # the JAX package's subsampling
    # pairs of rows: the upper pixel the foreground (▀), the lower the
    # background
    rows = []
    for r in range(0, img.shape[0] - 1, 2):
        line = []
        for c in range(img.shape[1]):
            fg = _gray_code(img[r, c])
            bg = _gray_code(img[r + 1, c])
            line.append(f"\x1b[38;5;{fg}m\x1b[48;5;{bg}m▀")
        rows.append("".join(line) + _RESET)
    return "\n".join(rows)


def term_display(y, y_hat, width: int = 40) -> str:
    """Truth and prediction side by side, printed and returned; the first
    2-D slice of each (..., H, W) array is shown."""
    def first_2d(a):
        a = np.asarray(a)
        while a.ndim > 2:
            a = a[0]
        return a

    left = render_image(first_2d(y), width).split("\n")
    right = render_image(first_2d(y_hat), width).split("\n")
    out = ["y" + " " * (width - 1) + " | y_hat"]
    for a, b in zip(left, right):
        out.append(f"{a} | {b}")
    text = "\n".join(out)
    print(text)
    return text
