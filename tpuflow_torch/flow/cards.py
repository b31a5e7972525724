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


# ------------------------------------------------------------ timeline
class _GanttBar:
    """One timeline bar: offset and width as percentages of the run span
    (nested divs, so the bar scales with the column)."""

    def __init__(self, left_pct: float, width_pct: float, color: str):
        self.left_pct = left_pct
        self.width_pct = width_pct
        self.color = color

    def _render(self) -> str:
        return (
            "<div style='position:relative;width:240px;height:12px;"
            "background:#f1f0ec'>"
            f"<div style='position:absolute;left:{self.left_pct:.2f}%;"
            f"width:{max(self.width_pct, 0.5):.2f}%;height:12px;"
            f"background:{self.color}'></div></div>"
        )


# Goodput bucket -> color of the stacked goodput bar: productive green,
# lost time in the subsystem hues, the residual near the background.
_GOODPUT_COLORS = (
    ("step", "#2e9960"),
    ("replay", "#c2b33a"),
    ("compile", "#2a78d6"),
    ("restore", "#9268d4"),
    ("data_wait", "#eb6834"),
    ("ckpt", "#8a8782"),
    ("resize", "#d08a3a"),
    ("requeue_gap", "#d05252"),
    ("other", "#e5e4e0"),
)


class _GoodputBar:
    """One 100%-stacked bar over the goodput buckets (hover a segment for
    its bucket and seconds)."""

    def __init__(self, goodput: dict):
        self.goodput = goodput

    def _render(self) -> str:
        wall = max(float(self.goodput.get("wall_s", 0.0)), 1e-9)
        buckets = self.goodput.get("buckets", {})
        cells = []
        for bucket, color in _GOODPUT_COLORS:
            v = float(buckets.get(bucket, 0.0))
            if v <= 0:
                continue
            cells.append(
                f"<div title='{bucket}: {v:.3f}s' "
                f"style='width:{100.0 * v / wall:.2f}%;"
                f"background:{color};height:16px'></div>")
        return ("<div style='display:flex;width:480px;height:16px;"
                "background:#f1f0ec'>" + "".join(cells) + "</div>")


# Span-name prefix -> bar color: one hue a subsystem.
_TIMELINE_COLORS = {
    "flow.": "#8a8782",
    "train.": "#2a78d6",
    "ckpt.": "#eb6834",
    "data.": "#2e9960",
    "infer.": "#9268d4",
    "serve.": "#d08a3a",
    "fleet.": "#3a9ec2",
    "device.": "#c2b33a",
}


def _span_color(name: str) -> str:
    for prefix, color in _TIMELINE_COLORS.items():
        if name.startswith(prefix):
            return color
    return "#8a8782"


def _events_named(events, name: str) -> list[dict]:
    return [e for e in events
            if e.get("kind") == "event" and e.get("name") == name]


def _headline_section(buf, headline: dict) -> None:
    def fmt(k, v):
        if "bytes" in k:
            return f"{v / 1e6:.1f} MB"
        if "gbps" in k:
            return f"{v:.2f} GB/s"
        if k.endswith("_s"):
            return f"{v:.4f} s"
        if "rate" in k or "mfu" in k:
            return f"{v:.3f}"
        return f"{v:,.1f}" if isinstance(v, float) else str(v)

    buf.append(Markdown("## Headline"))
    buf.append(Table([[k, fmt(k, v)] for k, v in sorted(headline.items())],
                     headers=["metric", "value"]))


def _health_section(buf, health: dict) -> None:
    buf.append(Markdown("## Training health"))
    rows = []
    for a in health.get("anomalies", []):
        detail = ", ".join(f"{k}={v}" for k, v in sorted(a.items())
                           if k not in ("ts", "proc", "detector", "step"))
        rows.append(["anomaly", a.get("detector", "?"), a.get("step", ""),
                     detail])
    for r in health.get("rollbacks", []):
        rows.append(["rollback", r.get("detector", "?"), r.get("step", ""),
                     f"from step {r.get('from_step', '?')}, "
                     f"lr_scale {r.get('lr_scale', 1.0)}"])
    for p in health.get("profiles", []):
        rows.append(["profile", "trace",
                     f"{p.get('start_step', '?')}–{p.get('stop_step', '?')}",
                     p.get("dir", "")])
    buf.append(Table(rows, headers=["event", "kind", "step", "detail"]))
    last = health.get("last") or {}
    if last:
        buf.append(Table([[k, f"{v:.6g}"] for k, v in sorted(last.items())
                          if k != "step"],
                         headers=["last gauge", "value"]))


def _goodput_section(buf, goodput: dict) -> None:
    wall = goodput["wall_s"]
    buf.append(Markdown("## Goodput"))
    buf.append(Markdown(
        f"**{100.0 * goodput.get('fraction', 0.0):.1f}%** of "
        f"{wall:.1f} s wall went to productive train steps."))
    buf.append(_GoodputBar(goodput))
    buf.append(Table(
        [[bucket, f"{goodput['buckets'].get(bucket, 0.0):.3f}s",
          f"{100.0 * goodput['buckets'].get(bucket, 0.0) / wall:.1f}%"]
         for bucket, _c in _GOODPUT_COLORS
         if goodput["buckets"].get(bucket)],
        headers=["bucket", "seconds", "share"]))
    attempts = goodput.get("attempts") or []
    if len(attempts) > 1:
        buf.append(Markdown("## Attempt lanes"))
        buf.append(Table(
            [[f"attempt {a['attempt']}",
              " ".join(f"p{p}" for p in a.get("procs", [])),
              f"+{a['start_s']:.3f}s", f"{a['dur_s']:.3f}s",
              _GanttBar(100.0 * a["start_s"] / wall,
                        100.0 * a["dur_s"] / wall, "#2a78d6")]
             for a in attempts],
            headers=["attempt", "procs", "start", "dur", ""]))


def _serving_section(buf, counters: dict, gauges: dict) -> None:
    rows = []
    for name, label in (("serve.requests", "requests completed"),
                        ("serve.tokens", "tokens served"),
                        ("serve.slo_violations", "SLO violations")):
        if counters.get(name):
            rows.append([label, f"{counters[name]:,.0f}"])
    for name, label, spec in (
        ("serve.queue_depth", "queue depth (last/max)", "{:.0f}"),
        ("serve.slot_occupancy", "slot occupancy (last/max)", "{:.2f}"),
        ("serve.ttft_s", "TTFT s (last/max)", "{:.4f}"),
        ("serve.idle_fraction", "ledger: idle fraction", "{:.3f}"),
        ("serve.decode_fraction", "ledger: decode fraction", "{:.3f}"),
        ("serve.prefill_fraction", "ledger: prefill fraction", "{:.3f}"),
        ("serve.decode_utilization", "decode utilization", "{:.3f}"),
        ("serve.masked_row_waste", "masked-row waste", "{:.3f}"),
        ("serve.spec_accept_rate", "spec accept rate", "{:.3f}"),
        ("serve.pages_free", "pages free (last)", "{:.0f}"),
    ):
        g = gauges.get(name)
        if not g:
            continue
        val = spec.format(g.get("last", 0.0))
        if "last/max" in label:
            val += f" / {spec.format(g.get('max', 0.0))}"
        rows.append([label, val])
    buf.append(Markdown("## Serving"))
    if rows:
        buf.append(Table(rows, headers=["serving metric", "value"]))


def _fleet_section(buf, gauges: dict, stale_events: list[dict]) -> None:
    buf.append(Markdown("## Fleet"))
    rows = []
    g = gauges.get("fleet.size")
    if g:
        rows.append(["replicas tracked (last/max)",
                     f"{g.get('last', 0.0):.0f} / {g.get('max', 0.0):.0f}"])
    g = gauges.get("fleet.qps")
    if g:
        rows.append(["fleet QPS (last)", f"{g.get('last', 0.0):.3g}"])
    if stale_events:
        rows.append(["replica-stale events", f"{len(stale_events):,d}"])
        culprits = sorted({str(e.get("replica")) for e in stale_events
                           if e.get("replica")})
        if culprits:
            rows.append(["stale replicas", ", ".join(culprits[:8])])
    if rows:
        buf.append(Table(rows, headers=["fleet metric", "value"]))


def _device_section(buf, gauges: dict, prog_events: list[dict],
                    cap_events: list[dict],
                    budget_events: list[dict]) -> None:
    buf.append(Markdown("## Device"))
    rows = []
    for name, label in (("device.hbm_used", "HBM used (last/max)"),
                        ("device.hbm_peak", "HBM peak (max)"),
                        ("device.hbm_limit", "HBM limit")):
        g = gauges.get(name)
        if not g:
            continue
        val = f"{g.get('last', 0.0) / 2**30:.3f} GiB"
        if "last/max" in label:
            val += f" / {g.get('max', 0.0) / 2**30:.3f} GiB"
        elif "(max)" in label:
            val = f"{g.get('max', 0.0) / 2**30:.3f} GiB"
        rows.append([label, val])
    used_g = gauges.get("device.hbm_peak") or gauges.get("device.hbm_used")
    limit_g = gauges.get("device.hbm_limit")
    if used_g and limit_g and limit_g.get("last"):
        rows.append(["HBM peak fraction",
                     f"{used_g.get('max', 0.0) / limit_g['last']:.3f}"])
    if prog_events:
        programs = sorted({str(e.get("program")) for e in prog_events
                           if e.get("program")})
        rows.append(["compiled programs in ledger", f"{len(programs)}"])
        rows.append(["programs", ", ".join(programs[:12])])
    if budget_events:
        b = budget_events[-1]
        verdict = (f"{float(b.get('resident_bytes', 0.0)) / 2**30:.3f} GiB "
                   "resident")
        if b.get("resident_frac") is not None:
            verdict += f" = {100.0 * float(b['resident_frac']):.1f}% of limit"
        if b.get("over"):
            verdict += " [OVER]"
        rows.append(["static HBM budget", verdict])
    if cap_events:
        rows.append(["triggered captures", f"{len(cap_events):,d}"])
        reasons = [str(e.get("reason")) for e in cap_events
                   if e.get("reason")]
        if reasons:
            rows.append(["capture reasons", ", ".join(reasons[:8])])
    if rows:
        buf.append(Table(rows, headers=["device metric", "value"]))


def _alerts_section(buf, fired: list[dict], resolved: list[dict]) -> None:
    """One row a fired alert: its severity, message, runbook anchor and
    whether a resolve matched it before the run ended."""
    buf.append(Markdown("## Alerts"))
    resolved_count: dict[str, int] = {}
    for e in resolved:
        rule = str(e.get("rule"))
        resolved_count[rule] = resolved_count.get(rule, 0) + 1
    rows = []
    for e in fired:
        rule = str(e.get("rule"))
        if resolved_count.get(rule, 0) > 0:
            resolved_count[rule] -= 1
            state = "resolved"
        else:
            state = "STILL ACTIVE at run end"
        rows.append([rule, str(e.get("severity", "?")),
                     str(e.get("message", ""))[:80], state,
                     f"#{e.get('runbook', '')}"])
    buf.append(Table(
        rows, headers=["alert", "severity", "message", "state", "runbook"]))


def _gantt_section(buf, spans: list[dict]) -> None:
    t0 = min(e["ts"] for e in spans)
    t1 = max(e["ts"] + e["dur_s"] for e in spans)
    total = max(t1 - t0, 1e-9)
    buf.append(Markdown("## Timeline"))
    rows = []
    # The run span covers everything: only the inner structure is drawn.
    for e in sorted(spans, key=lambda e: e["ts"]):
        if e["name"] == "flow.run":
            continue
        label = e["name"]
        if e.get("step"):
            label += f" [{e['step']}]"
        detail = []
        if e.get("bytes"):
            detail.append(f"{float(e['bytes']) / 1e6:.1f} MB")
        if e.get("gbps"):
            detail.append(f"{float(e['gbps']):.2f} GB/s")
        if e.get("tokens_per_s"):
            detail.append(f"{float(e['tokens_per_s']):.0f} tok/s")
        rows.append([label, f"p{e.get('proc', 0)}", f"+{e['ts'] - t0:.3f}s",
                     f"{e['dur_s']:.3f}s", " ".join(detail),
                     _GanttBar(100.0 * (e["ts"] - t0) / total,
                               100.0 * e["dur_s"] / total,
                               _span_color(e["name"]))])
    buf.append(Table(rows,
                     headers=["span", "proc", "start", "dur", "detail", ""]))


def timeline_card(buf, events: Sequence[dict],
                  summary: dict | None = None) -> None:
    """The run-level telemetry card (the JAX ``timeline_card``): the
    headline metrics, the training-health events, the goodput bar and its
    buckets (with one lane a launch attempt), the serving, fleet and
    device sections when the stream has them, the Alerts section when an
    alert fired or resolved during the run, a Gantt-style table of the
    spans (one bar a span; ``train.compile``, ``train.epoch``,
    ``train.validation``, ``ckpt.save`` ... in their subsystem's color),
    then the span, counter and histogram aggregates. The flow runner
    renders it into ``timeline.html`` at the run root. Appends into
    ``buf``; callers wrap it, a card never fails the run."""
    from tpuflow_torch.obs.timeline import summarize

    if not events:
        return
    if summary is None:
        summary = summarize(events)
    buf.append(Markdown("# Run timeline"))
    if summary.get("headline"):
        _headline_section(buf, summary["headline"])
    health = summary.get("health") or {}
    if (health.get("anomalies") or health.get("rollbacks")
            or health.get("profiles")):
        _health_section(buf, health)
    goodput = summary.get("goodput") or {}
    if goodput.get("wall_s") and goodput.get("steps_timed"):
        _goodput_section(buf, goodput)
    counters = summary.get("counters", {})
    gauges = summary.get("gauges", {})
    if counters.get("serve.requests") or "serve.queue_depth" in gauges:
        _serving_section(buf, counters, gauges)
    stale = _events_named(events, "fleet.replica_stale")
    if "fleet.size" in gauges or stale:
        _fleet_section(buf, gauges, stale)
    progs = _events_named(events, "device.program")
    caps = _events_named(events, "prof.capture")
    if "device.hbm_used" in gauges or progs or caps:
        _device_section(buf, gauges, progs, caps,
                        _events_named(events, "device.hbm_budget"))
    fired = _events_named(events, "alert.fired")
    resolved = _events_named(events, "alert.resolved")
    if fired or resolved:
        _alerts_section(buf, fired, resolved)
    spans = [e for e in events
             if e.get("kind") == "span" and e.get("dur_s", 0) > 0]
    if spans:
        _gantt_section(buf, spans)
    agg = summary.get("spans", {})
    if agg:
        buf.append(Markdown("## Span aggregates"))
        buf.append(Table(
            [[n, s["count"], f"{s['total_s']:.3f}s", f"{s['mean_s']:.4f}s",
              f"{s['max_s']:.4f}s"] for n, s in sorted(agg.items())],
            headers=["span", "count", "total", "mean", "max"]))
    hists = summary.get("histograms", {})
    if counters or hists:
        buf.append(Markdown("## Counters and histograms"))
        rows = [[n, "counter", f"{v:,.0f}", "", ""]
                for n, v in sorted(counters.items())]
        rows += [[n, "histogram", h["count"], f"{h['p50']:.5f}",
                  f"{h['max']:.5f}"] for n, h in sorted(hists.items())]
        buf.append(Table(rows, headers=["name", "kind", "count/total", "p50",
                                        "max"]))
