"""Card components and the HTML renderer.

Counterpart of ``tpuflow/flow/cards.py`` (``Markdown``, ``Table``,
``Image``, ``CardBuffer``, ``metrics_table``, ``training_curve_card``),
without matplotlib: ``Image.from_array`` encodes a numpy array as a PNG
itself (``png_bytes``, numpy and zlib), and the charts are inline SVG
drawn from the numbers (``BarChart``, ``LineChart``). A step decorated
with ``@card`` gets ``current.card``, an appendable buffer rendered to
``card.html`` in the task directory when the step completes.
"""

from __future__ import annotations

import base64
import html
import struct
import zlib
from typing import Any, Sequence

import numpy as np


class Markdown:
    """Markdown component: headers, bold and plain lines."""

    def __init__(self, text: str):
        self.text = text

    def _render(self) -> str:
        lines = []
        for line in self.text.split("\n"):
            stripped = line.strip()
            if stripped.startswith("#"):
                level = min(len(stripped) - len(stripped.lstrip("#")), 6)
                lines.append(f"<h{level}>{html.escape(stripped[level:].strip())}"
                             f"</h{level}>")
            elif stripped:
                text = html.escape(stripped)
                while "**" in text:
                    text = text.replace("**", "<b>", 1).replace("**", "</b>", 1)
                lines.append(f"<p>{text}</p>")
        return "\n".join(lines)


def png_bytes(arr) -> bytes:
    """A PNG of ``arr``: (H, W) grayscale or (H, W, 3) RGB. uint8 is taken
    as it is; any other dtype is scaled from its min..max to 0..255 (a
    constant image is black). 8 bits a channel, no filter, one zlib
    stream."""
    a = np.asarray(arr)
    if a.ndim not in (2, 3) or (a.ndim == 3 and a.shape[2] != 3):
        raise ValueError(f"png_bytes takes (H, W) or (H, W, 3), got {a.shape}")
    if a.dtype != np.uint8:
        a = a.astype(np.float64)
        lo, hi = float(a.min()), float(a.max())
        a = np.round((a - lo) * (255.0 / max(hi - lo, 1e-12)))
        a = np.clip(a, 0, 255).astype(np.uint8)
    h, w = a.shape[:2]
    raw = b"".join(b"\x00" + row.tobytes() for row in a.reshape(h, -1))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    color = 0 if a.ndim == 2 else 2
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))


class Image:
    """Image component: PNG bytes shown inline."""

    def __init__(self, png: bytes):
        self.png_bytes = png

    @classmethod
    def from_array(cls, arr, *, scale: int = 1) -> "Image":
        """``arr`` as a PNG (``png_bytes``), each pixel repeated ``scale``
        times in both directions."""
        a = np.asarray(arr)
        if scale > 1:
            a = np.repeat(np.repeat(a, scale, axis=0), scale, axis=1)
        return cls(png_bytes(a))

    def _render(self) -> str:
        b64 = base64.b64encode(self.png_bytes).decode()
        return f'<img src="data:image/png;base64,{b64}"/>'


class Table:
    """Table of rows; cells may be components or plain values."""

    def __init__(self, rows: Sequence[Sequence[Any]],
                 headers: Sequence[str] = ()):
        self.rows = rows
        self.headers = headers

    def _render(self) -> str:
        parts = ["<table border='1' cellpadding='4' "
                 "style='border-collapse:collapse'>"]
        if self.headers:
            parts.append("<tr>" + "".join(
                f"<th>{html.escape(str(h))}</th>" for h in self.headers)
                + "</tr>")
        for row in self.rows:
            cells = [
                f"<td>{c._render()}</td>" if hasattr(c, "_render")
                else f"<td>{html.escape(str(c))}</td>" for c in row
            ]
            parts.append("<tr>" + "".join(cells) + "</tr>")
        parts.append("</table>")
        return "\n".join(parts)


# Categorical colors of the JAX package's charts: series 1 and 2, the grid.
_BLUE, _ORANGE, _GRID = "#2a78d6", "#eb6834", "#e5e4e0"


def _num(v: float) -> str:
    return f"{v:.4g}"


class BarChart:
    """Horizontal bars, one a value, labelled, as inline SVG; bars grow
    from the zero line (negative values to its left)."""

    def __init__(self, values: Sequence[float], labels: Sequence[str], *,
                 width: int = 260, bar_h: int = 11):
        self.values = [float(v) for v in values]
        self.labels = [str(x) for x in labels]
        self.width, self.bar_h = width, bar_h

    def _render(self) -> str:
        label_w, pad = 70, 4
        plot_w = self.width - label_w - pad
        lo = min(0.0, *self.values) if self.values else 0.0
        hi = max(0.0, *self.values) if self.values else 1.0
        span = max(hi - lo, 1e-12)
        zero = label_w + plot_w * (-lo / span)
        h = len(self.values) * (self.bar_h + 2) + 2
        parts = [f"<svg xmlns='http://www.w3.org/2000/svg' width='{self.width}'"
                 f" height='{h}' style='font:9px sans-serif'>"]
        for i, (v, name) in enumerate(zip(self.values, self.labels)):
            y = 1 + i * (self.bar_h + 2)
            x0 = min(zero, zero + plot_w * v / span)
            parts.append(
                f"<text x='{label_w - 3}' y='{y + self.bar_h - 2}' "
                f"text-anchor='end'>{html.escape(name)}</text>"
                f"<rect x='{x0:.1f}' y='{y}' width='"
                f"{max(plot_w * abs(v) / span, 0.5):.1f}' "
                f"height='{self.bar_h}' fill='{_BLUE}'>"
                f"<title>{html.escape(name)}: {_num(v)}</title></rect>")
        parts.append(f"<line x1='{zero:.1f}' y1='0' x2='{zero:.1f}' "
                     f"y2='{h}' stroke='#8a8782' stroke-width='0.5'/></svg>")
        return "".join(parts)


class LineChart:
    """Lines over shared x values, one an entry of ``series`` (name ->
    y values), with a legend, as inline SVG."""

    def __init__(self, xs: Sequence[float], series: dict[str, Sequence[float]],
                 *, xlabel: str = "", ylabel: str = "", width: int = 480,
                 height: int = 240):
        self.xs = [float(x) for x in xs]
        self.series = {k: [float(y) for y in v] for k, v in series.items()}
        self.xlabel, self.ylabel = xlabel, ylabel
        self.width, self.height = width, height

    def _render(self) -> str:
        left, right, top, bottom = 56, 12, 22, 34
        pw = self.width - left - right
        ph = self.height - top - bottom
        ys = [y for v in self.series.values() for y in v if np.isfinite(y)]
        y0, y1 = (min(ys), max(ys)) if ys else (0.0, 1.0)
        if y1 - y0 < 1e-12:
            y0, y1 = y0 - 0.5, y1 + 0.5
        x0, x1 = (min(self.xs), max(self.xs)) if self.xs else (0.0, 1.0)
        xspan = max(x1 - x0, 1e-12)

        def px(x):
            return left + pw * ((x - x0) / xspan if x1 > x0 else 0.5)

        def py(y):
            return top + ph * (1.0 - (y - y0) / (y1 - y0))

        parts = [f"<svg xmlns='http://www.w3.org/2000/svg' width='{self.width}'"
                 f" height='{self.height}' style='font:10px sans-serif;"
                 "background:#fcfcfb'>"]
        for i in range(5):  # horizontal grid and y ticks
            y = y0 + (y1 - y0) * i / 4
            parts.append(f"<line x1='{left}' x2='{left + pw}' y1='{py(y):.1f}'"
                         f" y2='{py(y):.1f}' stroke='{_GRID}' "
                         "stroke-width='0.5'/><text x='"
                         f"{left - 4}' y='{py(y) + 3:.1f}' text-anchor='end'>"
                         f"{_num(y)}</text>")
        for x in self.xs:
            parts.append(f"<text x='{px(x):.1f}' y='{top + ph + 13}' "
                         f"text-anchor='middle'>{_num(x)}</text>")
        for i, (name, vals) in enumerate(self.series.items()):
            color = (_BLUE, _ORANGE)[i % 2]
            pts = " ".join(f"{px(x):.1f},{py(y):.1f}"
                           for x, y in zip(self.xs, vals) if np.isfinite(y))
            parts.append(f"<polyline points='{pts}' fill='none' "
                         f"stroke='{color}' stroke-width='2'/>")
            for x, y in zip(self.xs, vals):
                if np.isfinite(y):
                    parts.append(f"<circle cx='{px(x):.1f}' cy='{py(y):.1f}' "
                                 f"r='2.5' fill='{color}'/>")
            parts.append(f"<rect x='{left + 8 + 110 * i}' y='6' width='10' "
                         f"height='3' fill='{color}'/><text x='"
                         f"{left + 22 + 110 * i}' y='10'>{html.escape(name)}"
                         "</text>")
        parts.append(f"<text x='{left + pw / 2:.1f}' y='{self.height - 4}' "
                     f"text-anchor='middle'>{html.escape(self.xlabel)}</text>"
                     f"<text x='12' y='{top + ph / 2:.1f}' text-anchor='middle'"
                     f" transform='rotate(-90 12 {top + ph / 2:.1f})'>"
                     f"{html.escape(self.ylabel)}</text></svg>")
        return "".join(parts)


def metrics_table(records: Sequence[dict]) -> Table:
    """A Table of per-epoch metric dicts with the JAX package's float
    format: 4 decimals, 1 decimal for magnitudes >= 100 (token rates)."""

    def fmt(v):
        if isinstance(v, float):
            return f"{v:.1f}" if abs(v) >= 100 else f"{v:.4f}"
        return v

    headers = list(records[0].keys()) if records else []
    return Table([[fmt(r.get(h)) for h in headers] for r in records],
                 headers=headers)


class CardBuffer:
    """``current.card``: append components during the step."""

    def __init__(self):
        self.components: list[Any] = []

    def append(self, component: Any) -> None:
        self.components.append(component)

    def render_html(self, title: str = "tpuflow card") -> str:
        body = "\n".join(
            c._render() if hasattr(c, "_render")
            else f"<p>{html.escape(str(c))}</p>" for c in self.components
        )
        return (
            "<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title>"
            "<style>body{font-family:sans-serif;margin:2em}"
            "table{font-size:13px}</style></head>"
            f"<body>{body}</body></html>"
        )


def training_curve_card(buf, records: Sequence[dict]) -> None:
    """The training-curve card: a final-perplexity headline, the per-epoch
    train and val loss on one axis (both in nats per token; perplexity
    stays in the table), and the metrics table. Appends into ``buf``
    (``current.card``)."""
    if not records:
        return
    buf.append(Markdown("# Training curves"))
    last = records[-1]
    if last.get("ppl") is not None:
        buf.append(Markdown(
            f"Final **val perplexity {last['ppl']:.2f}** (val loss "
            f"{last['val_loss']:.4f}) after {len(records)} epoch(s)."))
    series = {"train loss": [r["train_loss"] for r in records]}
    if last.get("val_loss") is not None:
        series["val loss"] = [r["val_loss"] for r in records]
    buf.append(LineChart([r["epoch"] for r in records], series,
                         xlabel="epoch", ylabel="loss (nats/token)"))
    buf.append(metrics_table(records))
