"""Image resize + colour-jitter augmentation in numpy alone.

The JAX package's ``data/augment.py`` resizes with OpenCV's
``cv2.resize(..., INTER_LINEAR)`` and jitters with Pillow's
``ImageEnhance`` and HSV conversion (reference dataset/KittiDataset.py:
209-218, 290-293). The card's host has neither library, so this module
computes the same integer arithmetic itself:

* :func:`resize_image`: OpenCV's bilinear resize of uint8 images (the
  datasets' dumps), with its 11-bit fixed-point weights and its rounding,
  and its 2x2 box average where the size halves exactly, which OpenCV
  takes for ``INTER_LINEAR`` at an integer scale of 2;
* :func:`color_jitter`: Pillow's ``Image.blend`` (an f32 interpolation,
  truncated), its ``L`` conversion (ITU-R 601-2 in 16-bit fixed point),
  its contrast mean (the ``L`` histogram's mean, rounded half up) and its
  RGB <-> HSV conversion, in the JAX package's random order with the same
  draws from the same generator.

Both are bit-equal to the two libraries on every input the CPU tests give
them; a mismatch would show as at most one grey level per op, and the
generator's draws do not depend on the pixels, so the rest of a sample
stays in step either way.
"""

from __future__ import annotations

import numpy as np

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _linear_taps(dsize: int, ssize: int):
    """OpenCV's per-output source taps and 11-bit fixed-point weights along
    one axis: ``(s0, s1, w0, w1)``. The source coordinate ``(d + 0.5) *
    scale - 0.5`` is computed in f64 and stored in f32, then clamped at
    both edges."""
    scale = 1.0 / (dsize / ssize)
    f = ((np.arange(dsize) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    f[s < 0] = 0
    s[s < 0] = 0
    hi = s >= ssize - 1
    f[hi] = 0
    s[hi] = ssize - 1
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)
                 ).astype(np.int64)
    return s, np.minimum(s + 1, ssize - 1), w0, _COEF_SCALE - w0


def resize_image(img: np.ndarray, scale: float) -> np.ndarray:
    """Bilinear resize of a uint8 HWC image by ``scale``; the output size is
    Python's ``round`` of each side times ``scale``, so a 376 x 1241 KITTI
    frame halves to 188 x 620."""
    if img.dtype != np.uint8 or img.ndim != 3:
        raise TypeError(f"resize_image takes uint8 HWC images, got "
                        f"{img.dtype} {img.shape}")
    src_h, src_w = img.shape[:2]
    h = int(round(src_h * scale))
    w = int(round(src_w * scale))
    if src_h == 2 * h and src_w == 2 * w:
        s = img.astype(np.int32)
        out = (s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2]
               + 2) >> 2
    else:
        ys0, ys1, b0, b1 = _linear_taps(h, src_h)
        xs0, xs1, a0, a1 = _linear_taps(w, src_w)
        s = img.astype(np.int64)
        rows = s[:, xs0] * a0[None, :, None] + s[:, xs1] * a1[None, :, None]
        b0, b1 = b0[:, None, None], b1[:, None, None]
        # the vertical pass as OpenCV's vector path computes it: 16-bit high
        # products of the rows shifted right by 4, then (+2) >> 2
        out = (((b0 * (rows[ys0] >> 4)) >> 16)
               + ((b1 * (rows[ys1] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


# ---- Pillow's arithmetic on uint8 RGB ------------------------------------

def _to_l(img: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L: ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``."""
    i = img.astype(np.int64)
    return ((i[..., 0] * 19595 + i[..., 1] * 38470 + i[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _blend(a: np.ndarray, b: np.ndarray, alpha: float) -> np.ndarray:
    """Pillow's ``Image.blend(a, b, alpha)``: ``a + alpha (b - a)`` in f32,
    truncated (clipped to [0, 255] first where ``alpha`` extrapolates)."""
    af = a.astype(np.float32)
    t = af + np.float32(alpha) * (b.astype(np.float32) - af)
    if not 0.0 <= alpha <= 1.0:
        t = np.clip(t, 0.0, 255.0)
    return t.astype(np.uint8)


def _rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> HSV (colorsys in f32 with f64 steps, as its C code
    mixes them); hue and saturation truncated to [0, 255]."""
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    maxc = np.maximum(r, np.maximum(g, b))
    minc = np.minimum(r, np.minimum(g, b))
    grey = maxc == minc
    cr = (maxc - minc).astype(np.float32)
    crs = np.where(grey, np.float32(1.0), cr)
    s = cr / np.maximum(maxc, 1).astype(np.float32)
    rc = (maxc - r).astype(np.float32) / crs
    gc = (maxc - g).astype(np.float32) / crs
    bc = (maxc - b).astype(np.float32) / crs
    h = np.where(r == maxc, bc - gc,
                 np.where(g == maxc,
                          (2.0 + rc.astype(np.float64) - bc).astype(np.float32),
                          (4.0 + gc.astype(np.float64) - rc).astype(np.float32)))
    h = np.fmod(h.astype(np.float64) / 6.0 + 1.0, 1.0).astype(np.float32)
    uh = np.clip((h.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
    us = np.clip((s.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
    return np.stack([np.where(grey, 0, uh), np.where(grey, 0, us), maxc],
                    axis=-1).astype(np.uint8)


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """C's ``round`` on non-negative values."""
    fl = np.floor(x)
    return np.where(x - fl >= 0.5, fl + 1.0, fl)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Pillow's HSV -> RGB (colorsys's sextants, f32 fractions, C
    ``round``)."""
    h, s, v = (hsv[..., i].astype(np.int64) for i in range(3))
    hh = h.astype(np.float64) * 6.0 / 255.0
    i = np.floor(hh).astype(np.int64)
    f = (hh - i).astype(np.float32).astype(np.float64)
    fs = (s.astype(np.float64) / 255.0).astype(np.float32).astype(np.float64)
    vf = v.astype(np.float64)

    def chan(x):
        return np.clip(_round_half_away(vf * x), 0, 255).astype(np.int64)

    p, q, t = chan(1.0 - fs), chan(1.0 - fs * f), chan(1.0 - fs * (1.0 - f))
    sel = i % 6
    rgb = np.stack([np.choose(sel, [v, q, p, p, t, v]),
                    np.choose(sel, [t, v, v, q, p, p]),
                    np.choose(sel, [p, p, t, v, v, q])], axis=-1)
    return np.where((s == 0)[..., None], v[..., None], rgb).astype(np.uint8)


def color_jitter(rng: np.random.Generator, img: np.ndarray,
                 brightness=(0.8, 1.2), contrast=(0.8, 1.2),
                 saturation=(0.8, 1.2), hue=(-0.1, 0.1)) -> np.ndarray:
    """Brightness / contrast / saturation / hue jitter in random order on a
    uint8 HWC RGB image (torchvision ColorJitter semantics: uniform
    factors, a random order), drawing from ``rng`` exactly as the JAX
    package does: one permutation of the four ops, then one uniform per
    op in that order."""
    out = np.ascontiguousarray(img.astype(np.uint8))
    for op in list(rng.permutation(4)):
        if op == 0:
            f = rng.uniform(*brightness)
            out = _blend(np.zeros_like(out), out, f)
        elif op == 1:
            f = rng.uniform(*contrast)
            lum = _to_l(out)
            mean = int(float(lum.astype(np.int64).sum()) / lum.size + 0.5)
            out = _blend(np.full_like(out, mean), out, f)
        elif op == 2:
            f = rng.uniform(*saturation)
            out = _blend(np.repeat(_to_l(out)[..., None], 3, axis=-1), out, f)
        else:
            f = rng.uniform(*hue)
            hsv = _rgb_to_hsv(out).astype(np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(f * 255)) % 256
            out = _hsv_to_rgb(hsv.astype(np.uint8))
    return out
