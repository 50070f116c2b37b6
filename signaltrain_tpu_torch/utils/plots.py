"""Training plots, with the JAX package's files, titles and layout.

Counterpart of signaltrain_tpu/utils/plots.py (the reference's
io_methods.py:397-498): ``val_data_<i>.png`` triptychs (input / target /
target against predicted, the knobs in world coordinates in the title),
``mag.png`` / ``mag_hat.png`` spectrograms, and the four learned front-end
matrices ``conv_{anal,synth}_{real,imag}.png``.

The images are drawn with Pillow, which both the development machine and
the card's have; matplotlib is not a dependency of the port. The layout
follows matplotlib's defaults at 100 dpi: the triptych is a 600 x 800 figure
of three stacked axes (x from 0 to the input's length, y from -1 to 1, a
legend in each), a spectrogram a 640 x 480 figure with frames across and
bins up (``origin="lower"``), a weight matrix a square figure with row 0 at
the top, both in the viridis colormap over the matrix's range. Pillow is
imported when a figure is drawn, never when this module is imported.
"""

from __future__ import annotations

import math

import numpy as np

from ..training import checkpoint

# viridis at 0, 1/8, ..., 1, interpolated linearly between
_VIRIDIS = np.array([(68, 1, 84), (71, 45, 123), (59, 82, 139), (44, 114, 142), (33, 145, 140),
                     (40, 174, 128), (94, 201, 98), (173, 220, 48), (253, 231, 37)], np.float64)
_BLUE, _RED, _GREEN = (0, 0, 255), (255, 0, 0), (0, 128, 0)  # "b", "r", (0, 0.5, 0)
_LEFT, _RIGHT, _BOTTOM, _TOP, _HSPACE = 0.125, 0.9, 0.11, 0.88, 0.2  # matplotlib's subplot box


def _lut() -> np.ndarray:
    """(256, 3) uint8: the anchors of _VIRIDIS interpolated, as matplotlib's
    256-colour map."""
    pos = np.linspace(0.0, len(_VIRIDIS) - 1, 256)
    i = np.minimum(pos.astype(np.int64), len(_VIRIDIS) - 2)
    f = (pos - i)[:, None]
    return np.round(_VIRIDIS[i] * (1 - f) + _VIRIDIS[i + 1] * f).astype(np.uint8)


def _viridis(m: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """The (rows, cols) samples of m -> (len(rows), len(cols), 3) uint8, over
    the whole matrix's range."""
    m = np.asarray(m, np.float32)
    lo, hi = float(np.nanmin(m)), float(np.nanmax(m))
    m = m[rows[:, None], cols[None, :]]
    t = (m - lo) * (255.0 / (hi - lo)) if hi > lo else np.zeros_like(m)
    return _lut()[np.clip(np.nan_to_num(t), 0, 255).astype(np.uint8)]


def _ticks(lo: float, hi: float, log: bool = False) -> list[float]:
    if log:
        return [10.0**e for e in range(math.ceil(math.log10(lo)), math.floor(math.log10(hi)) + 1)]
    raw = (hi - lo) / 5
    mag = 10 ** math.floor(math.log10(raw)) if raw > 0 else 1.0
    step = next(s * mag for s in (1, 2, 2.5, 5, 10) if s * mag >= raw)
    first = math.ceil(lo / step) * step
    return [first + k * step for k in range(int((hi - first) / step + 1e-9) + 1)]


def _label(v: float, log: bool) -> str:
    if log:
        return f"1e{round(math.log10(v))}"
    return f"{v:g}" if abs(v) < 1e5 else f"{v:.0e}"


class _Figure:
    """A white canvas of width x height pixels with Pillow's default font."""

    def __init__(self, width: int, height: int):
        from PIL import Image, ImageDraw, ImageFont

        self.image = Image.new("RGB", (width, height), "white")
        self.draw = ImageDraw.Draw(self.image)
        self.font = ImageFont.load_default()
        self.width, self.height = width, height

    def text(self, xy, s: str, fill=(0, 0, 0), center: bool = False, right: bool = False) -> None:
        x, y = xy
        left, top, r, bottom = self.draw.textbbox((0, 0), s, font=self.font)
        if center:
            x -= (r - left) / 2
        elif right:
            x -= r - left
        self.draw.text((x, y - (bottom - top) / 2), s, fill=fill, font=self.font)

    def title(self, s: str, y: float) -> None:
        for k, line in enumerate(s.split("\n")):
            self.text((self.width / 2, y + 14 * k), line, center=True)

    def axes(self, left: float, top: float, right: float, bottom: float) -> "_Axes":
        box = (round(left * self.width), round(top * self.height), round(right * self.width),
               round(bottom * self.height))
        return _Axes(self, box)

    def copy(self) -> "_Figure":
        """A new figure drawn on a copy of this one's canvas."""
        from PIL import ImageDraw

        fig = object.__new__(_Figure)
        fig.image, fig.font = self.image.copy(), self.font
        fig.draw = ImageDraw.Draw(fig.image)
        fig.width, fig.height = self.width, self.height
        return fig

    def save(self, filename: str) -> None:
        self.image.save(filename, compress_level=1)


class _Axes:
    def __init__(self, fig: _Figure, box):
        self.fig, self.box = fig, box
        self.xlim, self.ylim, self.xlog = (0.0, 1.0), (0.0, 1.0), False
        self.entries: list[tuple[str, tuple]] = []

    def limits(self, xlim, ylim, xlog: bool = False) -> None:
        self.xlim, self.ylim, self.xlog = tuple(map(float, xlim)), tuple(map(float, ylim)), xlog

    def _px(self, x, y):
        l, t, r, b = self.box
        fx = np.log10(x) if self.xlog else np.asarray(x, np.float64)
        x0, x1 = (math.log10(v) for v in self.xlim) if self.xlog else self.xlim
        px = l + (fx - x0) / (x1 - x0) * (r - l)
        py = b - (np.asarray(y, np.float64) - self.ylim[0]) / (self.ylim[1] - self.ylim[0]) * (b - t)
        return np.clip(px, l, r), np.clip(py, t, b)

    def line(self, x, y, color, label: str | None = None, fig: _Figure | None = None) -> None:
        """y against x (x increasing), drawn on ``fig`` (the axes' own by
        default). Where several points share a pixel column the line is drawn
        through their least and largest value, the strokes a line through all
        of them leaves."""
        px, py = self._px(np.asarray(x, np.float64), np.asarray(y, np.float64))
        keep = np.isfinite(px) & np.isfinite(py)
        px, py = px[keep], py[keep]
        col = np.floor(px)
        if len(col) > 2 * (self.box[2] - self.box[0]):
            starts = np.r_[0, np.flatnonzero(np.diff(col)) + 1]
            px = np.repeat(col[starts], 2)
            py = np.stack([np.minimum.reduceat(py, starts),
                           np.maximum.reduceat(py, starts)], 1).ravel()
        if len(px) > 1:
            (fig or self.fig).draw.line(np.stack([px, py], 1).ravel().tolist(), fill=color, width=1)
        if label is not None:
            self.entries.append((label, color))

    def image(self, matrix: np.ndarray, origin: str) -> None:
        from PIL import Image

        l, t, r, b = self.box
        rows, cols = matrix.shape
        ri = ((np.arange(b - t) + 0.5) * rows / (b - t)).astype(np.int64)  # nearest sample
        ci = ((np.arange(r - l) + 0.5) * cols / (r - l)).astype(np.int64)
        rgb = _viridis(matrix, ri, ci)
        if origin == "lower":
            rgb = rgb[::-1]
        self.fig.image.paste(Image.fromarray(np.ascontiguousarray(rgb)), (l, t))
        self.limits((-0.5, cols - 0.5), (-0.5, rows - 0.5) if origin == "lower" else (rows - 0.5, -0.5))

    def finish(self, xlabel: str = "", ylabel: str = "") -> None:
        """The frame, the ticks and their labels, the axis labels, the legend."""
        fig, (l, t, r, b) = self.fig, self.box
        fig.draw.rectangle((l, t, r, b), outline=(0, 0, 0))
        lo, hi = sorted(self.xlim)
        for v in _ticks(lo, hi, self.xlog):
            px, _ = self._px(v, self.ylim[0])
            fig.draw.line((px, b, px, b + 4), fill=(0, 0, 0))
            fig.text((px, b + 12), _label(v, self.xlog), center=True)
        lo, hi = sorted(self.ylim)
        for v in _ticks(lo, hi):
            _, py = self._px(self.xlim[0], v)
            fig.draw.line((l - 4, py, l, py), fill=(0, 0, 0))
            fig.text((l - 6, py), _label(v, False), right=True)
        if xlabel:
            fig.text(((l + r) / 2, b + 30), xlabel, center=True)
        if ylabel:
            fig.text((l - 45, (t + b) / 2), ylabel, right=True)
        for k, (label, color) in enumerate(self.entries):
            y = t + 12 + 16 * k
            fig.draw.line((r - 110, y, r - 85, y), fill=color, width=2)
            fig.text((r - 80, y), label)


def plot_valdata(x_val, knobs_val, y_val, y_val_hat, effect, epoch: int, loss_val: float,
                 file_prefix: str = "val_data", num_plots: int = 50,
                 target_size: int | None = None) -> None:
    """Input / target / predicted triptychs of the first ``num_plots``
    validation examples (numpy arrays, batch-major), ``<file_prefix>_<i>.png``."""
    x_val, y_val, y_val_hat = np.asarray(x_val), np.asarray(y_val), np.asarray(y_val_hat)
    knobs_val = np.asarray(knobs_val)
    num_plots = min(num_plots, x_val.shape[0])
    x_size = x_val.shape[1]
    y_size = y_val.shape[1] if target_size is None else target_size
    t_small = np.arange(x_size - y_size, x_size)
    height = (_TOP - _BOTTOM) / (3 + 2 * _HSPACE)
    # the effect's knobs_wc on the host: the writer thread puts nothing on the card
    kr = np.asarray(effect.knob_ranges, np.float32)
    # the axes, ticks and legends are the same in every figure: drawn once
    template = _Figure(600, 800)
    panels = []
    for k, labels in enumerate(((("Input", _BLUE),), (("Target", _RED),),
                                (("Target", _RED), ("Predicted", _GREEN)))):
        top = 1 - _TOP + k * height * (1 + _HSPACE)
        ax = template.axes(_LEFT, top, _RIGHT, top + height)
        ax.limits((0, x_size), (-1, 1))
        ax.entries = list(labels)
        ax.finish()
        panels.append(ax)
    for plot_i in range(num_plots):
        knobs_w = kr[:, 0] + (knobs_val[plot_i, :].astype(np.float32) + 0.5) * (kr[:, 1] - kr[:, 0])
        fig = template.copy()
        titlestr = f"{effect.name} Val data, epoch {epoch + 1}, loss_val = {float(loss_val):.3e}\n"
        titlestr += ", ".join(f"{name} = {knobs_w[i]:.2f}" for i, name in enumerate(effect.knob_names))
        fig.title(titlestr, 0.05 * fig.height)
        target = y_val[plot_i, -y_size:]
        panels[0].line(np.arange(x_size), x_val[plot_i, :], _BLUE, fig=fig)
        panels[1].line(t_small, target, _RED, fig=fig)
        panels[2].line(t_small, target, _RED, fig=fig)
        panels[2].line(t_small, y_val_hat[plot_i, -y_size:], _GREEN, fig=fig)
        fig.save(f"{file_prefix}_{plot_i}.png")


def spectrogram_images(state_dict, mag_val, mag_val_hat) -> dict:
    """What ``plot_spectrograms`` draws: {filename: (title, matrix, origin)}.
    ``mag_val`` / ``mag_val_hat`` are batch-major (B, T, F) / (B, OT, F), as
    the gemm front-end returns them; the matrices of the front-end are the
    JAX package's (ft, ft) ``w_real`` / ``w_imag``, the analysis's real one
    offset by +1.0."""
    p = checkpoint.state_dict_to_params(state_dict)["params"]
    images = {"mag.png": ("Initial magnitude", np.asarray(mag_val)[0].T, "lower"),
              "mag_hat.png": ("Processed magnitude", np.asarray(mag_val_hat)[0].T, "lower")}
    for side, tag, title, offset in (
        ("dft_analysis", "anal_real", "Conv-Analysis Real", 1.0),
        ("dft_analysis", "anal_imag", "Conv-Analysis Imag", 0.0),
        ("dft_synthesis", "synth_real", "Conv-Synthesis Real", 0.0),
        ("dft_synthesis", "synth_imag", "Conv-Synthesis Imag", 0.0),
    ):
        part = "w_real" if "real" in tag else "w_imag"
        images[f"conv_{tag}.png"] = (title, np.asarray(p[side][part], dtype=float) + offset, "upper")
    return images


def plot_spectrograms(state_dict, mag_val, mag_val_hat) -> None:
    """Magnitude spectrograms of validation example 0 and the learned
    front-end matrices (``spectrogram_images``), from a port ``state_dict``."""
    for filename, (title, matrix, origin) in spectrogram_images(state_dict, mag_val,
                                                                mag_val_hat).items():
        fig = _Figure(640, 480) if origin == "lower" else _Figure(480, 480)
        fig.title(title, 0.06 * fig.height)
        ax = fig.axes(_LEFT, 1 - _TOP, _RIGHT, 1 - _BOTTOM)
        ax.image(matrix, origin)
        ax.finish()
        fig.save(filename)


def plot_curve(x, y, filename: str, title: str, xlabel: str, ylabel: str,
               xlog: bool = False) -> None:
    """One line (``semilogx`` with ``xlog``) in a 640 x 480 figure."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    fig = _Figure(640, 480)
    fig.title(title, 0.06 * fig.height)
    ax = fig.axes(_LEFT, 1 - _TOP, _RIGHT, 1 - _BOTTOM)
    finite = y[np.isfinite(y)]
    lo, hi = (float(finite.min()), float(finite.max())) if finite.size else (0.0, 1.0)
    pad = 0.05 * (hi - lo) if hi > lo else 0.5
    ax.limits((x.min(), x.max()) if x.max() > x.min() else (x.min() * 0.9, x.min() * 1.1),
              (lo - pad, hi + pad), xlog=xlog)
    ax.line(x, y, _BLUE)
    ax.finish(xlabel, ylabel)
    fig.save(filename)
