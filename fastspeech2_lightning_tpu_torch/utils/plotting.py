"""Validation media as images (counterpart of the JAX package's
``utils/plotting.py``): attention maps and GT-vs-predicted mels with pitch
and energy curves, as [H, W, 3] uint8 RGB arrays that
``utils.tensorboard.SummaryWriter.add_image`` stores as PNG.

The pictures are not matplotlib's figures: there are no titles, axes, ticks
or fonts, and no interpolation. Each array is drawn one cell per pixel (both
axes scaled by one integer factor), origin at the bottom as ``imshow(...,
origin="lower")`` puts it, coloured through a fixed 256-entry table over
each panel's own min-max range, as ``imshow``'s default normalisation does.
The table is viridis (public domain) rounded to 8 bits, with two entries that
rounding made equal moved one step apart, so every index has its own colour
and a picture can be read back into its data. The arrays drawn are those the
JAX functions plot."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..type_definitions import Stats

# viridis, 256 RGB triples (entries 113 and 130 one step bluer apart)
COLORMAP = np.frombuffer(bytes.fromhex(
    "44015444025645045745055946075a46085c460a5d460b5e470d60470e614710634711644713654814674816"
    "6848176948186a481a6c481b6d481c6e481d6f481f7048207148217348237448247548257648267748287848"
    "2979472a7a472c7a472d7b472e7c472f7d46307e46327e46337f463480453581453781453882443983443a83"
    "443b84433d84433e85423f854240864241864142874144874045884046883f47883f48893e49893e4a893e4c"
    "8a3d4d8a3d4e8a3c4f8a3c508b3b518b3b528b3a538b3a548c39558c39568c38588c38598c375a8c375b8d36"
    "5c8d365d8d355e8d355f8d34608d34618d33628d33638d32648e32658e31668e31678e31688e30698e306a8e"
    "2f6b8e2f6c8e2e6d8e2e6e8e2e6f8e2d708e2d718e2c718e2c728e2c738e2b748e2b758e2a768e2a778e2a78"
    "8e29798e297a8e297b8e287c8e287d8e277e8e277f8e27808e26818e26828e26828d25838e25848e25858e24"
    "868e24878e23888e23898e238a8d228b8d228c8d228d8d218e8d218f8d21908d21918c20928c20928b20938c"
    "1f948c1f958b1f968b1f978b1f988b1f998a1f9a8a1e9b8a1e9c891e9d891f9e891f9f881fa0881fa1881fa1"
    "871fa28720a38620a48621a58521a68522a78522a88423a98324aa8325ab8225ac8226ad8127ad8128ae8029"
    "af7f2ab07f2cb17e2db27d2eb37c2fb47c31b57b32b67a34b67935b77937b87838b9773aba763bbb753dbc74"
    "3fbc7340bd7242be7144bf7046c06f48c16e4ac16d4cc26c4ec36b50c46a52c56954c56856c66758c7655ac8"
    "645cc8635ec96260ca6063cb5f65cb5e67cc5c69cd5b6ccd5a6ece5870cf5773d05675d05477d1537ad1517c"
    "d2507fd34e81d34d84d44b86d54989d5488bd6468ed64590d74393d74195d84098d83e9bd93c9dd93ba0da39"
    "a2da37a5db36a8db34aadc32addc30b0dd2fb2dd2db5de2bb8de29bade28bddf26c0df25c2df23c5e021c8e0"
    "20cae11fcde11dd0e11cd2e21bd5e21ad8e219dae319dde318dfe318e2e418e5e419e7e419eae51aece51bef"
    "e51cf1e51df4e61ef6e620f8e621fbe723fde725"
), np.uint8).reshape(256, 3)
PITCH_RGB = (31, 119, 180)  # matplotlib's tab:blue
ENERGY_RGB = (214, 39, 40)  # tab:red
GAP = 4  # white pixels between panels
MAX_SCALE = 4  # the integer factor a small array is scaled up by, at most
MIN_SIDE = 256  # ... until its longer side reaches this many pixels


def expand(values: np.ndarray, durations: np.ndarray) -> np.ndarray:
    """Repeat each phone-level value by its duration (``expand`` of the JAX
    package, for plotting phone-level variance curves)."""
    out = []
    for value, d in zip(values, durations):
        out += [value] * max(0, int(d))
    return np.array(out)


def scale_for(*shape: int) -> int:
    """The integer factor a panel of `shape` cells is drawn at."""
    return int(max(1, min(MAX_SCALE, MIN_SIDE // max(max(shape), 1))))


def colormap_indices(data: np.ndarray) -> np.ndarray:
    """Each cell's colormap index: its place in the array's min-max range
    times 256, cut to 0..255 (matplotlib's ``Normalize`` and lookup; a
    constant array is all 0)."""
    data = np.asarray(data, np.float64)
    lo, hi = np.nanmin(data), np.nanmax(data)
    norm = (data - lo) / (hi - lo) if hi > lo else np.zeros_like(data)
    return np.clip(np.floor(np.nan_to_num(norm) * 256), 0, 255).astype(np.int64)


def heatmap(data: np.ndarray, scale: int) -> np.ndarray:
    """[rows, cols] data as an [rows*scale, cols*scale, 3] image, row 0 at
    the bottom."""
    image = COLORMAP[colormap_indices(data)[::-1]]
    return np.repeat(np.repeat(image, scale, axis=0), scale, axis=1)


def curve_rows(heights: np.ndarray, n_rows: int, scale: int) -> np.ndarray:
    """The image row (from the top) of each point of a curve at `heights`
    in data units over a panel `n_rows` cells high; -1 where the point lies
    outside the panel (``set_ylim(0, n_rows)`` hides it) or is not finite."""
    y = np.round(np.asarray(heights, np.float64) * scale)
    inside = np.isfinite(y) & (y >= 0) & (y < n_rows * scale)
    return np.where(inside, n_rows * scale - 1 - np.nan_to_num(y), -1).astype(np.int64)


def _draw_curve(panel: np.ndarray, heights: np.ndarray, n_rows: int, scale: int, rgb) -> None:
    rows = curve_rows(heights, n_rows, scale)
    for j, r in enumerate(rows[: panel.shape[1] // scale]):
        if r >= 0:
            panel[r, j * scale:(j + 1) * scale] = rgb


def _stack(panels: List[np.ndarray], axis: int) -> np.ndarray:
    """Panels side by side (axis 1) or stacked (axis 0), GAP white pixels
    apart, each padded with white to the longest across the other axis."""
    other = 1 - axis
    size = max(p.shape[other] for p in panels)
    parts = []
    for i, p in enumerate(panels):
        if i:
            gap_shape = [size, size, 3]
            gap_shape[axis] = GAP
            parts.append(np.full(gap_shape, 255, np.uint8))
        pad = [(0, 0)] * 3
        pad[other] = (0, size - p.shape[other])
        parts.append(np.pad(p, pad, constant_values=255))
    return np.concatenate(parts, axis=axis)


def plot_attn_maps(attn_soft: np.ndarray, attn_hard: np.ndarray, mel_lens: np.ndarray,
                   text_lens: np.ndarray, n: int = 1) -> List[np.ndarray]:
    """For each of the first `n` items, its soft and hard attention side by
    side: ``attn[i, :t, :l].T``, text up the vertical axis, mel frames along
    the horizontal."""
    images = []
    for i in range(min(n, attn_soft.shape[0])):
        t, l = int(mel_lens[i]), int(text_lens[i])
        s = scale_for(t, l)
        images.append(_stack([heatmap(np.asarray(a[i, :t, :l], np.float64).T, s)
                              for a in (attn_soft, attn_hard)], axis=1))
    return images


def denormalized_height(values: np.ndarray, info, n_rows: int) -> np.ndarray:
    """The JAX plot's height of a normalised pitch or energy curve over a
    mel of `n_rows` bins: ``(x * std + mean - min) / max(max - min, 1e-9) *
    n_rows``."""
    x = np.asarray(values, np.float64) * info.std + info.mean
    return (x - info.min) / max(info.max - info.min, 1e-9) * n_rows


def plot_mel(entries: List[dict], stats: Optional[Stats], titles: List[str]) -> np.ndarray:
    """The entries' mels (``entry["mel"]`` [K, T]) stacked top to bottom,
    each with its ``pitch`` (blue) and ``energy`` (red) drawn one pixel a
    frame at their denormalised heights, cut to T. `titles` name the panels
    in the JAX figure; this image has no text."""
    del titles
    panels = []
    s = scale_for(*(max(np.shape(e["mel"])) for e in entries))
    for entry in entries:
        mel = np.asarray(entry["mel"], np.float64)
        k, t = mel.shape
        panel = heatmap(mel, s)
        for key, info, rgb in (("pitch", stats.pitch if stats else None, PITCH_RGB),
                               ("energy", stats.energy if stats else None, ENERGY_RGB)):
            if entry.get(key) is not None and info is not None:
                _draw_curve(panel, denormalized_height(entry[key], info, k)[:t], k, s, rgb)
        panels.append(panel)
    return _stack(panels, axis=0)
