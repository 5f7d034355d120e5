"""Web viewer: serves interactive renders of a trained model over HTTP (port of
`tpu_splat/viewer.py`).

A stdlib HTTP server renders frames on demand on the CUDA card (or, when asked, the CPU):
orbit with drag, zoom, render modes, point-cloud mode, a world overlay, scene nodes with
visibility and offsets, a crop box and a compare split. Launch with:

    python -m tpu_splat_torch.viewer model.ply [--port 8080] [--width 960] [--height 540]
        [--compare other.sog] [--add more.ply] [--device cpu]

The page and the routes are the JAX viewer's (`/`, `/frame`, `/info`, `/scene`,
`/scene_ctl`; with a Trainer attached: `/frame`, `/status`, `/control`). Frames are PNG
(`image/png`, `io/image.py::encode_png` at zlib level PNG_LEVEL, chosen for latency),
where the JAX viewer sends PIL JPEGs: the port carries no PIL.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch
import torch.nn.functional as F

from .core.geometry import BoundingBox, crop_splat_by_box
from .device import resolve_device
from .io.image import encode_png
from .render import load_model, look_at, render_view
from .utils import events as ev
from .utils.log import get_logger

log = get_logger(__name__)

# zlib level of the frames' PNGs, chosen for latency: on a 960x540 frame of the 1M-Gaussian
# scene, on the host of an H100 machine (chip_smoke.py, `viewer.png_levels`), level 0
# (stored) took 3.4 ms
# for 1.56 MB, level 1 44.5 ms for 0.88 MB, level 6 57.0 ms for 0.86 MB; the viewer binds
# loopback by default, where moving the extra 0.7 MB costs far less than deflating it
PNG_LEVEL = 0

_PAGE = """<!DOCTYPE html>
<html><head><title>tpu_splat_torch viewer</title><style>
body { margin:0; background:#111; color:#ddd; font-family:monospace; }
#hud { position:fixed; top:8px; left:8px; background:#000a; padding:6px 10px; }
#scene { position:fixed; bottom:8px; left:8px; background:#000a; padding:6px 10px; }
#scene input[type=number] { width:54px; background:#222; color:#ddd; border:1px solid #444; }
img { display:block; margin:auto; }
</style></head><body>
<div id="hud">drag: orbit &middot; wheel: dolly &middot; d: depth &middot; p: point cloud
 &middot; g: grid/axes &middot; compare: drag the divider</div>
<div id="scene"></div>
<img id="view" width="__W__" height="__H__"/>
<script>
let theta = 0.6, phi = -0.25, radius = 1.0, mode = "RGB", busy = false, dirty = true;
let compare = false, split = 0.5;  // model-compare split view (draggable divider)
let overlay = false;               // world axes + ground grid
const img = document.getElementById("view");
fetch('/info').then(r => r.json()).then(s => { compare = !!s.compare; dirty = true; })
  .catch(() => {});
function refresh() {
  if (busy || !dirty) { return; }
  busy = true; dirty = false;
  img.src = `/frame?theta=${theta.toFixed(4)}&phi=${phi.toFixed(4)}` +
            `&radius=${radius.toFixed(4)}&mode=${mode}` +
            (compare ? `&split=${split.toFixed(3)}` : ``) +
            (overlay ? `&overlay=1` : ``) + `&t=${Date.now()}`;
  img.onload = () => { busy = false; };
  img.onerror = () => { busy = false; };
}
setInterval(refresh, 60);
let drag = null, dragSplit = false;
img.onmousedown = (e) => {
  const fx = (e.clientX - img.getBoundingClientRect().left) / img.width;
  dragSplit = compare && Math.abs(fx - split) < 0.02;  // grab near the divider
  drag = [e.clientX, e.clientY];
};
window.onmouseup = () => { drag = null; dragSplit = false; };
window.onmousemove = (e) => {
  if (!drag) return;
  if (dragSplit) {
    split = Math.max(0, Math.min(1,
      (e.clientX - img.getBoundingClientRect().left) / img.width));
  } else {
    theta += (e.clientX - drag[0]) * 0.01;
    phi = Math.max(-1.4, Math.min(1.4, phi + (e.clientY - drag[1]) * 0.01));
  }
  drag = [e.clientX, e.clientY]; dirty = true;
};
window.onwheel = (e) => { radius *= Math.exp(e.deltaY * 0.001); dirty = true; };
window.onkeydown = (e) => {
  if (e.target.tagName === "INPUT") return;
  if (e.key === "d") { mode = mode === "RGB" ? "RGB_ED" : "RGB"; dirty = true; }
  if (e.key === "p") { mode = mode === "PC" ? "RGB" : "PC"; dirty = true; }
  if (e.key === "g") { overlay = !overlay; dirty = true; }
};
// ---- scene panel: per-node visibility + translation, world-space crop box
function num(v, step) {
  return `<input type="number" value="${v}" step="${step ?? 0.1}"/>`;
}
async function loadScene() {
  let s;
  try { s = await (await fetch('/scene')).json(); } catch (e) { return; }
  const div = document.getElementById('scene');
  let html = s.nodes.map((n, i) =>
    `<div data-node="${i}"><input type="checkbox" ${n.visible ? "checked" : ""}/> ` +
    `${n.name} (${n.n}) ` + n.offset.map(o => num(o)).join("") + `</div>`).join("");
  html += `<div id="crop"><input type="checkbox" ${s.crop.on ? "checked" : ""}/> crop ` +
    s.crop.min.map(v => num(v)).join("") + " &rarr; " +
    s.crop.max.map(v => num(v)).join("") + `</div>`;
  div.innerHTML = html;
  div.querySelectorAll('div[data-node]').forEach(row => {
    row.querySelectorAll('input').forEach(inp => inp.onchange = () => {
      const vals = [...row.querySelectorAll('input[type=number]')].map(x => x.value);
      fetch(`/scene_ctl?node=${row.dataset.node}` +
            `&visible=${row.querySelector('input[type=checkbox]').checked ? 1 : 0}` +
            `&ox=${vals[0]}&oy=${vals[1]}&oz=${vals[2]}`).then(() => { dirty = true; });
    });
  });
  const crop = document.getElementById('crop');
  crop.querySelectorAll('input').forEach(inp => inp.onchange = () => {
    const v = [...crop.querySelectorAll('input[type=number]')].map(x => x.value);
    fetch(`/scene_ctl?crop=${crop.querySelector('input[type=checkbox]').checked ? 1 : 0}` +
          `&cmin=${v[0]},${v[1]},${v[2]}&cmax=${v[3]},${v[4]},${v[5]}`)
      .then(() => { dirty = true; });
  });
}
loadScene();
dirty = true;
</script></body></html>
"""


def _draw_segment(img: np.ndarray, p0, p1, color) -> None:
    """DDA line into a [3, H, W] float image (host-side overlay rasterization)."""
    h, w = img.shape[1:]
    x0, y0 = p0
    x1, y1 = p1
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    if n > 4 * (h + w):  # off-screen blow-up guard
        return
    t = np.linspace(0.0, 1.0, n + 1)
    xs = np.round(x0 + (x1 - x0) * t).astype(int)
    ys = np.round(y0 + (y1 - y0) * t).astype(int)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[:, ys[keep], xs[keep]] = np.asarray(color, np.float32)[:, None]


def draw_world_overlay(img: np.ndarray, w2c: np.ndarray, fx: float, fy: float,
                       cx: float, cy: float, center: np.ndarray, extent: float) -> None:
    """World axes (x red, y green, z blue, from the scene center) + a ground grid in the
    world y-plane through the center — the reference viewer's grid/axes overlays
    (include/rendering/rendering.hpp:42-57), drawn on the host over the frame."""
    def project(pts):
        c = (w2c[:3, :3] @ pts.T + w2c[:3, 3:4]).T  # [N, 3] camera space
        z = np.maximum(c[:, 2], 1e-6)
        return np.stack([fx * c[:, 0] / z + cx, fy * c[:, 1] / z + cy], 1), c[:, 2] > 0.05

    def seg(a, b, color):
        uv, ok = project(np.stack([a, b]))
        if ok.all():
            _draw_segment(img, uv[0], uv[1], color)

    L = 0.35 * extent
    for axis, color in ((np.array([L, 0, 0]), (1, 0.2, 0.2)),
                        (np.array([0, L, 0]), (0.2, 1, 0.2)),
                        (np.array([0, 0, L]), (0.3, 0.4, 1))):
        seg(center, center + axis, color)
    g, n = 0.8 * extent, 8
    for i in range(-n, n + 1):
        o = i * g / n
        seg(center + np.array([o, 0, -g]), center + np.array([o, 0, g]), (0.35, 0.35, 0.35))
        seg(center + np.array([-g, 0, o]), center + np.array([g, 0, o]), (0.35, 0.35, 0.35))


def draw_camera_frustums(img: np.ndarray, w2c_view: np.ndarray, fx: float, fy: float,
                         cx: float, cy: float, cameras, size: float) -> None:
    """Dataset-camera frustum wireframes (reference: camera frustums in the GL engine,
    rendering.hpp:42-57) — each camera drawn as a 5-corner pyramid of depth `size`."""
    def project(pts):
        c = (w2c_view[:3, :3] @ pts.T + w2c_view[:3, 3:4]).T
        z = np.maximum(c[:, 2], 1e-6)
        return np.stack([fx * c[:, 0] / z + cx, fy * c[:, 1] / z + cy], 1), c[:, 2] > 0.05

    for cam in cameras:
        w2c_i = np.asarray(cam.world_view_transform, np.float32)
        r = w2c_i[:3, :3]
        eye = -r.T @ w2c_i[:3, 3]
        # image-plane corners at depth `size` for a ~55 deg half-spread pyramid
        corners = np.array([[sx * 0.5, sy * 0.35, 1.0]
                            for sx, sy in ((-1, -1), (1, -1), (1, 1), (-1, 1))])
        world = eye[None] + (r.T @ (corners.T * size)).T
        uv, ok = project(np.concatenate([eye[None], world]))
        if not ok.all():
            continue
        for i in range(4):
            _draw_segment(img, uv[0], uv[1 + i], (1.0, 0.85, 0.2))
            _draw_segment(img, uv[1 + i], uv[1 + (i + 1) % 4], (1.0, 0.85, 0.2))


def orbit_w2c(center: np.ndarray, base_radius: float, theta: float, phi: float,
              radius: float) -> np.ndarray:
    """The world-to-camera matrix of the page's orbit camera."""
    eye = center + base_radius * radius * np.array(
        [math.cos(theta) * math.cos(phi), math.sin(phi), math.sin(theta) * math.cos(phi)])
    return look_at(eye.astype(np.float32), center.astype(np.float32))


def quantize(img: np.ndarray) -> np.ndarray:
    """float [3, H, W] in [0, 1] -> uint8 [H, W, 3], truncating (the JAX viewer's
    `(img * 255).astype(uint8)` before its JPEG)."""
    return np.ascontiguousarray((img.transpose(1, 2, 0) * 255).astype(np.uint8))


def _center_and_radius(state) -> tuple[np.ndarray, float]:
    means = state.means[state.alive].cpu().numpy()
    if not len(means):
        return np.zeros(3, np.float32), 5.0
    center = means.mean(axis=0)
    return center, float(np.percentile(np.linalg.norm(means - center, axis=1), 90)) * 2.0


class SceneNode:
    """One model in the viewer's scene graph (reference: src/visualizer/scene/ — multiple
    loaded PLYs with per-node visibility and transform)."""

    def __init__(self, name: str, state):
        self.name = name
        self.state = state
        self.visible = True
        self.offset = np.zeros(3, np.float32)  # world translation (gizmo equivalent)


class ViewerState:
    """A model (or several, as scene nodes) served to the page, rendered on `device`.

    Renders run one at a time (`lock`); `renders` counts the `render_view` calls (each
    launches K1 and K2 once on the card), `frame_ms` keeps the last frames' split into
    render (the frame and its copy to the host) and encode (overlay, quantize, PNG)."""

    def __init__(self, model_path: str, width: int, height: int,
                 compare_path: str | None = None, extra_paths: list[str] | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.nodes = [SceneNode(Path(p).name, load_model(p, self.device))
                      for p in [model_path, *(extra_paths or [])]]
        # model-compare split view (reference: include/rendering/rendering.hpp:42-57):
        # a second model rendered from the SAME camera, composited at a draggable
        # divider column — the standard before/after or prune/full comparison workflow
        self.compare = load_model(compare_path, self.device) if compare_path else None
        self.width = width
        self.height = height
        self.crop_on = False  # world-space AABB crop (SplatData::crop_by_cropbox)
        self.center, self.base_radius = _center_and_radius(self.nodes[0].state)
        self.crop_min = self.center - self.base_radius
        self.crop_max = self.center + self.base_radius
        self._combined = None  # cache; invalidated by scene_ctl
        self.lock = threading.Lock()  # one render at a time on the card
        self.renders = 0
        self.frame_ms: deque[dict] = deque(maxlen=256)

    def scene_json(self) -> dict:
        return {
            "nodes": [dict(name=n.name, n=int(n.state.n_alive()),
                           visible=n.visible, offset=[round(float(v), 3) for v in n.offset])
                      for n in self.nodes],
            "crop": dict(on=self.crop_on,
                         min=[round(float(v), 3) for v in self.crop_min],
                         max=[round(float(v), 3) for v in self.crop_max]),
        }

    def scene_ctl(self, q: dict) -> None:
        with self.lock:
            if "node" in q:
                node = self.nodes[int(q["node"][0])]
                if "visible" in q:
                    node.visible = q["visible"][0] == "1"
                if "ox" in q:
                    node.offset = np.array(
                        [float(q["ox"][0]), float(q["oy"][0]), float(q["oz"][0])],
                        np.float32)
            if "crop" in q:
                self.crop_on = q["crop"][0] == "1"
                if "cmin" in q:
                    self.crop_min = np.array(q["cmin"][0].split(","), np.float32)
                    self.crop_max = np.array(q["cmax"][0].split(","), np.float32)
            self._combined = None

    def scene_state(self):
        """Concatenate visible nodes (offsets applied, shN padded to the widest basis)
        into one renderable SplatState; apply the crop box if enabled."""
        if self._combined is not None:
            return self._combined
        vis = [n for n in self.nodes if n.visible] or self.nodes[:1]
        bases = max(n.state.shN.shape[1] for n in vis)
        deg = max(n.state.max_sh_degree for n in vis)
        parts = []
        for n in vis:
            s = n.state
            parts.append(dict(
                means=s.means + torch.as_tensor(n.offset, device=self.device),
                sh0=s.sh0, shN=F.pad(s.shN, (0, 0, 0, bases - s.shN.shape[1])),
                scaling_raw=s.scaling_raw, rotation_raw=s.rotation_raw,
                opacity_raw=s.opacity_raw, alive=s.alive,
            ))
        merged = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        state = dataclasses.replace(vis[0].state, max_sh_degree=deg, **merged)
        if self.crop_on:
            state = crop_splat_by_box(
                state, BoundingBox(min_bounds=self.crop_min, max_bounds=self.crop_max))
        self._combined = state
        return state

    @torch.no_grad()
    def render_one(self, state, w2c: np.ndarray, mode: str,
                   overlay: bool = False) -> np.ndarray:
        """One frame [3, H, W] float in [0, 1] of `state`: RGB, point cloud ("PC"), or a
        depth mode with the depth on the right half; the overlay drawn over it."""
        pc = mode == "PC"
        out = render_view(state, w2c, self.width, self.height,
                          render_mode="RGB" if pc else mode, point_cloud=pc,
                          device=self.device)
        self.renders += 1
        img = torch.clamp(out.image, 0, 1).cpu().numpy()
        if overlay:
            f = 0.5 * self.width / math.tan(math.radians(60.0) / 2)
            draw_world_overlay(img, np.asarray(w2c), f, f, self.width / 2,
                               self.height / 2, self.center, self.base_radius)
        if mode not in ("RGB", "PC") and out.depth is not None:
            d = out.depth.cpu().numpy()
            dn = (d - d.min()) / max(float(d.max() - d.min()), 1e-9)
            img = np.concatenate([img[:, :, : self.width // 2],
                                  np.repeat(dn[None], 3, 0)[:, :, self.width // 2:]],
                                 axis=2)
        return img

    def frame(self, theta: float, phi: float, radius: float, mode: str,
              split: float | None = None, overlay: bool = False) -> bytes:
        """The page's frame as PNG bytes (zlib level PNG_LEVEL)."""
        t0 = time.perf_counter()
        w2c = orbit_w2c(self.center, self.base_radius, theta, phi, radius)
        with self.lock:
            img = self.render_one(self.scene_state(), w2c, mode, overlay=overlay)
            if self.compare is not None and split is not None:
                c = int(np.clip(split, 0.0, 1.0) * self.width)
                img_b = self.render_one(self.compare, w2c, mode, overlay=overlay)
                img = np.concatenate([img[:, :, :c], img_b[:, :, c:]], axis=2)
                img[:, :, max(c - 1, 0) : min(c + 1, self.width)] = 1.0  # divider
        t1 = time.perf_counter()
        png = encode_png(quantize(img), PNG_LEVEL)
        self.frame_ms.append(dict(render_ms=(t1 - t0) * 1e3,
                                  encode_ms=(time.perf_counter() - t1) * 1e3))
        return png


def _send(handler: BaseHTTPRequestHandler, body: bytes, content_type: str) -> None:
    handler.send_response(200)
    handler.send_header("Content-Type", content_type)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def _page(width: int, height: int, extra: str = "") -> bytes:
    return (_PAGE.replace("__W__", str(width)).replace("__H__", str(height))
            .replace("</body>", extra + "</body>")).encode()


def make_handler(viewer: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                _send(self, _page(viewer.width, viewer.height), "text/html")
            elif url.path == "/frame":
                q = parse_qs(url.query)
                split = q.get("split", [None])[0]
                png = viewer.frame(
                    float(q.get("theta", ["0"])[0]),
                    float(q.get("phi", ["-0.25"])[0]),
                    float(q.get("radius", ["1"])[0]),
                    q.get("mode", ["RGB"])[0],
                    split=None if split is None else float(split),
                    overlay=q.get("overlay", ["0"])[0] == "1",
                )
                _send(self, png, "image/png")
            elif url.path == "/scene":
                _send(self, json.dumps(viewer.scene_json()).encode(), "application/json")
            elif url.path == "/scene_ctl":
                viewer.scene_ctl(parse_qs(url.query))
                _send(self, b'{"ok": true}', "application/json")
            elif url.path == "/info":
                _send(self, json.dumps({
                    "n_alive": int(viewer.nodes[0].state.n_alive()),
                    "width": viewer.width, "height": viewer.height,
                    "compare": viewer.compare is not None,
                    "n_nodes": len(viewer.nodes),
                }).encode(), "application/json")
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def _start(server: ThreadingHTTPServer, name: str) -> ThreadingHTTPServer:
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, name=name, daemon=True).start()
    return server


def serve(model_path: str, port: int = 8080, width: int = 960, height: int = 540,
          host: str = "127.0.0.1", compare_path: str | None = None,
          extra_paths: list[str] | None = None, device: str | torch.device | None = None,
          block: bool = True):
    """Serve the viewer of a PLY/SOG model, rendering on `device` (the CUDA card when
    None). `block`: serve until interrupted; else serve from a daemon thread and return
    the server (its `viewer` attribute is the ViewerState; port 0 picks a free port,
    `server.server_address[1]`)."""
    viewer = ViewerState(model_path, width, height, compare_path=compare_path,
                         extra_paths=extra_paths, device=device)
    server = ThreadingHTTPServer((host, port), make_handler(viewer))
    server.viewer = viewer
    log.info("viewer serving %s%s on http://%s:%d", model_path,
             f" vs {compare_path}" if compare_path else "", host, server.server_address[1])
    if not block:
        return _start(server, "viewer")
    try:
        server.serve_forever()
    finally:
        server.server_close()


# ----------------------------------------------------- training-attached live viewer

_LIVE_HUD = """
<div id="ctl" style="position:fixed;top:8px;right:8px;background:#000a;padding:6px 10px;">
  <span id="stat">-</span><br/>
  <button onclick="fetch('/control?action=pause')">pause</button>
  <button onclick="fetch('/control?action=resume')">resume</button>
  <button onclick="fetch('/control?action=save')">save ckpt</button>
  <button onclick="fetch('/control?action=stop')">stop</button>
</div>
<script>
setInterval(async () => {
  try {
    const s = await (await fetch('/status')).json();
    document.getElementById('stat').textContent =
      `iter ${s.iteration}/${s.total}  loss ${s.loss?.toFixed(4) ?? '-'}  ` +
      `alive ${s.n_alive}  ${s.iters_per_s?.toFixed(2) ?? '-'} it/s`;
  } catch (e) {}
}, 1000);
</script>
"""


class TrainingViewerState:
    """Live view of a RUNNING Trainer — the reference's defining visualizer capability
    (training under a live viewer with shared model access + control events,
    src/visualizer/training_manager.cpp:121,343; trainer.cpp:871-885 handshake).

    Each frame renders `trainer.state.splat` as it stands: an immutable snapshot, since
    the port's train step, refines and optimizer build new tensors and update none in
    place, so the frame needs no lock against the train loop. The frame runs on the HTTP
    thread's current CUDA stream (the default stream, which the train loop uses too, so
    the two are ordered on the card), and it holds its snapshot's tensors until it is done,
    so the caching allocator cannot hand them to the next step. Each render adds one to
    `trainer.viewer_renders`, so the kernels' launch counts stay exact
    (`steps_dispatched` + eval, timelapse and viewer renders). Controls post the same
    cmd events the Trainer's control flags subscribe to.
    """

    def __init__(self, trainer, width: int, height: int, min_interval_s: float = 0.4):
        self.trainer = trainer
        self.device = trainer.device
        self.width = width
        self.height = height
        self.min_interval_s = min_interval_s
        self._last = (0.0, None, None)  # (time, key, png) — throttle card work
        self.lock = threading.Lock()
        self.center, self.base_radius = _center_and_radius(trainer.state.splat)
        self.frame_ms: deque[dict] = deque(maxlen=256)

    def status(self) -> dict:
        tr = self.trainer
        hist = tr._loss_hist
        state = tr.state
        return {
            "iteration": int(state.iteration) - 1,
            "total": tr.total_iterations,
            "loss": float(hist[-1]) if hist else None,
            "n_alive": int(state.splat.n_alive()),
            "iters_per_s": tr._live_rate,
            "paused": tr._pause_flag.is_set(),
        }

    def control(self, action: str) -> None:
        emit = {
            "pause": ev.PauseTraining, "resume": ev.ResumeTraining,
            "save": ev.SaveCheckpoint, "stop": ev.StopTraining,
        }.get(action)
        if emit is not None:
            ev.emit(emit())

    @torch.no_grad()
    def frame(self, theta: float, phi: float, radius: float, mode: str,
              overlay: bool = False) -> bytes:
        with self.lock:
            now = time.time()
            key = (round(theta, 4), round(phi, 4), round(radius, 4), mode, overlay)
            if (self._last[2] is not None and self._last[1] == key
                    and now - self._last[0] < self.min_interval_s):
                return self._last[2]
            splat = self.trainer.state.splat  # immutable snapshot
            w2c = orbit_w2c(self.center, self.base_radius, theta, phi, radius)
            t_r0 = time.perf_counter()
            pc = mode == "PC"
            self.trainer.viewer_renders += 1
            out = render_view(splat, w2c, self.width, self.height,
                              render_mode="RGB" if pc else mode, point_cloud=pc,
                              device=self.device)
            img = torch.clamp(out.image, 0, 1).cpu().numpy()
            render_ms = (time.perf_counter() - t_r0) * 1e3
            t_e0 = time.perf_counter()
            if overlay:
                f = 0.5 * self.width / math.tan(math.radians(60.0) / 2)
                draw_world_overlay(img, w2c, f, f, self.width / 2, self.height / 2,
                                   self.center, self.base_radius)
                draw_camera_frustums(
                    img, w2c, f, f, self.width / 2, self.height / 2,
                    getattr(self.trainer.train_dataset, "cameras", []),
                    0.08 * self.base_radius)
            ev.emit(ev.FrameRendered(width=self.width, height=self.height,
                                     render_ms=render_ms))
            png = encode_png(quantize(img), PNG_LEVEL)
            self.frame_ms.append(dict(render_ms=render_ms,
                                      encode_ms=(time.perf_counter() - t_e0) * 1e3))
            self._last = (now, key, png)
            return png


def make_live_handler(viewer: TrainingViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                _send(self, _page(viewer.width, viewer.height, _LIVE_HUD), "text/html")
            elif url.path == "/frame":
                q = parse_qs(url.query)
                png = viewer.frame(
                    float(q.get("theta", ["0"])[0]),
                    float(q.get("phi", ["-0.25"])[0]),
                    float(q.get("radius", ["1"])[0]),
                    q.get("mode", ["RGB"])[0],
                    overlay=q.get("overlay", ["0"])[0] == "1",
                )
                _send(self, png, "image/png")
            elif url.path == "/status":
                _send(self, json.dumps(viewer.status()).encode(), "application/json")
            elif url.path == "/control":
                q = parse_qs(url.query)
                viewer.control(q.get("action", [""])[0])
                _send(self, b'{"ok": true}', "application/json")
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def attach(trainer, port: int = 8080, width: int = 960, height: int = 540,
           host: str = "127.0.0.1"):
    """Start a live training viewer on a daemon thread; returns the server (its `viewer`
    attribute is the TrainingViewerState; port 0 picks a free port). It renders on the
    Trainer's device.

    Binds loopback by default: /control can pause/stop training and trigger checkpoint
    writes, so exposing it beyond the host is an explicit opt-in (--viewer-host)."""
    viewer = TrainingViewerState(trainer, width, height)
    server = ThreadingHTTPServer((host, port), make_live_handler(viewer))
    server.viewer = viewer
    log.info("live training viewer on http://%s:%d", host, server.server_address[1])
    return _start(server, "live-viewer")


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpu_splat_torch.viewer")
    p.add_argument("model", help="PLY or SOG model path")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (default loopback; 0.0.0.0 to expose)")
    p.add_argument("--compare", default=None,
                   help="second PLY/SOG model: split view with a draggable divider")
    p.add_argument("--add", action="append", default=None, metavar="MODEL",
                   help="additional PLY/SOG models as scene-graph nodes (repeatable)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' renders on the CPU)")
    args = p.parse_args(argv)
    serve(args.model, args.port, args.width, args.height, host=args.host,
          compare_path=args.compare, extra_paths=args.add, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
