"""Script preview: funscript visualizer + synced video player, as HTML (the
port's copy of the JAX package's ``gui/preview.py``).

The reference ships a Qt preview tab: a custom-painted polyline visualizer
with grid/playhead/zoom/pan/click-to-seek (FunScriptVisualizer,
FunscriptFlow.pyw:398-665), a QMediaPlayer video widget (:1871-1992), and a
detached always-on-top motion-indicator bar (:1675-1719). A GPU server
has no Qt; this module renders the same feature set as one self-contained
HTML page (canvas visualizer + <video> + motion bar) that any browser plays:

* polyline of actions over time with grid and playhead (reference :523-612)
* wheel zoom 1-50x anchored at the cursor, drag pan (:486-520)
* click-to-seek (:482-484)
* 20 Hz playhead sync + linear interpolation of the current script value
  driving the motion indicator (:2563-2592, 50 ms QTimer :1985-1987)

``write_preview`` drops ``<video>.preview.html`` next to the funscript;
``serve_preview`` opens a local HTTP server so the browser can stream the
video file.
"""

from __future__ import annotations

import json
import os

from ..io.funscript import funscript_path, load_funscript

__all__ = ["render_preview_html", "write_preview", "serve_preview"]

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Funscript Preview — {title}</title>
<style>
 body {{ background: #101418; color: #dde; font-family: sans-serif; margin: 0; padding: 12px; }}
 #wrap {{ max-width: 1200px; margin: auto; }}
 video {{ width: 100%; background: #000; }}
 #vis {{ width: 100%; height: 220px; background: #181c22; display: block;
        border: 1px solid #333; cursor: crosshair; }}
 #bar {{ height: 18px; background: #222; border: 1px solid #333; position: relative; }}
 #fill {{ position: absolute; left: 0; bottom: 0; top: 0; width: 0%; background: #4a9; }}
 #hud {{ color: #89a; font-size: 12px; padding: 4px 0; }}
</style></head>
<body><div id="wrap">
<h3>{title}</h3>
<video id="v" src="{video_src}" controls></video>
<div id="bar"><div id="fill"></div></div>
<canvas id="vis" height="220"></canvas>
<div id="hud">zoom: <span id="z">1.0</span>x — wheel to zoom, drag to pan, click to seek</div>
<script>
const ACTIONS = {actions_json};
const v = document.getElementById('v'), c = document.getElementById('vis'),
      ctx = c.getContext('2d'), fill = document.getElementById('fill');
let zoom = 1, panMs = 0, dragging = null;
const durMs = () => (v.duration || (ACTIONS.length ? ACTIONS[ACTIONS.length-1].at/1000 : 1)) * 1000;
function viewSpan() {{ return durMs() / zoom; }}
function msToX(ms) {{ return (ms - panMs) / viewSpan() * c.width; }}
function xToMs(x) {{ return panMs + x / c.width * viewSpan(); }}
function posToY(p) {{ return (100 - p) / 100 * (c.height - 20) + 10; }}
function scriptValue(ms) {{
  if (!ACTIONS.length) return 50;
  if (ms <= ACTIONS[0].at) return ACTIONS[0].pos;
  for (let i = 1; i < ACTIONS.length; i++) {{
    if (ACTIONS[i].at >= ms) {{
      const a = ACTIONS[i-1], b = ACTIONS[i];
      const t = (ms - a.at) / Math.max(1, b.at - a.at);
      return a.pos + t * (b.pos - a.pos);
    }}
  }}
  return ACTIONS[ACTIONS.length-1].pos;
}}
function draw() {{
  c.width = c.clientWidth;
  ctx.clearRect(0, 0, c.width, c.height);
  ctx.strokeStyle = '#2a3038';
  for (let p = 0; p <= 100; p += 25) {{
    const y = posToY(p);
    ctx.beginPath(); ctx.moveTo(0, y); ctx.lineTo(c.width, y); ctx.stroke();
  }}
  const gridMs = Math.pow(10, Math.ceil(Math.log10(viewSpan() / 10)));
  for (let ms = Math.floor(panMs / gridMs) * gridMs; ms < panMs + viewSpan(); ms += gridMs) {{
    const x = msToX(ms);
    ctx.beginPath(); ctx.moveTo(x, 0); ctx.lineTo(x, c.height); ctx.stroke();
    ctx.fillStyle = '#567'; ctx.fillText((ms/1000).toFixed(1) + 's', x + 2, 12);
  }}
  ctx.strokeStyle = '#5bd'; ctx.lineWidth = 1.5; ctx.beginPath();
  let started = false;
  for (const a of ACTIONS) {{
    const x = msToX(a.at);
    if (x < -50 || x > c.width + 50) {{ if (started) break; else continue; }}
    const y = posToY(a.pos);
    if (!started) {{ ctx.moveTo(x, y); started = true; }} else ctx.lineTo(x, y);
  }}
  ctx.stroke(); ctx.lineWidth = 1;
  const px = msToX(v.currentTime * 1000);
  ctx.strokeStyle = '#e66';
  ctx.beginPath(); ctx.moveTo(px, 0); ctx.lineTo(px, c.height); ctx.stroke();
}}
c.addEventListener('wheel', e => {{
  e.preventDefault();
  const anchor = xToMs(e.offsetX);
  zoom = Math.min(50, Math.max(1, zoom * (e.deltaY < 0 ? 1.25 : 0.8)));
  panMs = anchor - e.offsetX / c.width * viewSpan();
  panMs = Math.max(0, Math.min(durMs() - viewSpan(), panMs));
  document.getElementById('z').textContent = zoom.toFixed(1);
  draw();
}});
c.addEventListener('mousedown', e => dragging = {{ x: e.offsetX, pan: panMs, moved: false }});
window.addEventListener('mousemove', e => {{
  if (!dragging) return;
  const dx = e.clientX - (c.getBoundingClientRect().left + dragging.x);
  if (Math.abs(dx) > 3) dragging.moved = true;
  panMs = Math.max(0, Math.min(durMs() - viewSpan(),
                   dragging.pan - dx / c.width * viewSpan()));
  draw();
}});
window.addEventListener('mouseup', e => {{
  if (dragging && !dragging.moved) v.currentTime = xToMs(dragging.x) / 1000;
  dragging = null; draw();
}});
setInterval(() => {{
  fill.style.width = (100 - scriptValue(v.currentTime * 1000)) + '%';
  draw();
}}, 50);
v.addEventListener('loadedmetadata', draw);
draw();
</script>
</div></body></html>
"""


def render_preview_html(video_src: str, actions: list, title: str | None = None) -> str:
    return _PAGE.format(
        title=title or os.path.basename(video_src),
        video_src=video_src,
        actions_json=json.dumps(actions),
    )


def write_preview(video_path: str, out_path: str | None = None) -> str:
    """Generate ``<video>.preview.html`` next to the video + its funscript.

    A missing/unreadable funscript renders the page with no actions instead
    of raising — same tolerance as the embedded player, so the GUI's
    browser-fallback path can preview any video (ADVICE r4)."""
    try:
        fs = load_funscript(funscript_path(video_path))
    except Exception:
        fs = {"actions": []}
    out_path = out_path or os.path.splitext(video_path)[0] + ".preview.html"
    html = render_preview_html(os.path.basename(video_path), fs.get("actions", []),
                               title=os.path.basename(video_path))
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


def serve_preview(video_path: str, port: int = 8765) -> None:
    """Serve the preview page + video over local HTTP (blocking)."""
    import http.server

    directory = os.path.dirname(os.path.abspath(video_path)) or "."
    page = write_preview(video_path)
    handler = lambda *a, **k: http.server.SimpleHTTPRequestHandler(  # noqa: E731
        *a, directory=directory, **k
    )
    print(f"Preview: http://localhost:{port}/{os.path.basename(page)}")
    http.server.HTTPServer(("127.0.0.1", port), handler).serve_forever()
