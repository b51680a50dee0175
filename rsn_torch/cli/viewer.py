"""rsn_torch viewer — the port of rsn-viewer (the ns-viewer equivalent): a
browser viewer over websockets.

    python -m rsn_torch.cli.viewer --load-dir RUN [--port 7007] \
        [--downscale 2]

The client holds a persistent WebSocket and the server pushes rendered
frames: the browser streams camera poses up, the server streams
progressively refined PNG frames down, coalescing stale poses whenever
the camera moves faster than the renderer.  The wire layer is the
dependency-free RFC 6455 implementation in rsn_torch/utils/websocket.py;
plain HTTP GET /render stays as a fallback transport.  Each frame is a
product-only render_image (K2 on passes 1 and 3, K1 on 2 and 4 with
bf16; K9 on passes 1 and 3 for a proposal run with use_pallas_proposal),
one render at a time under a lock, encoded to PNG in memory
(rsn_torch.data.png.encode_png).

Streaming quality levels: interactive moves render at 1/4 resolution;
once the camera settles the same pose re-renders at 1/2 then full
resolution.  A render that fails reaches the client: a websocket session
gets a close frame with status 1011 and the error, an HTTP request a 500
reply; the server prints the traceback.

Camera paths: press `p` to record the current pose, `e` to export the
recorded path: the server writes `camera_paths/path-<n>.json` under the
run dir, which renders with
  python -m rsn_torch.cli.render --load-dir RUN --mode path --camera-path FILE

Runs on the CUDA card, and raises when torch sees none; a Python caller
may ask for the CPU with main(argv, device="cpu").
"""
from __future__ import annotations

import json
import os
import select
import struct
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from rsn_torch.utils import websocket as ws_lib

_PAGE = """<!DOCTYPE html>
<html><head><title>rsn viewer</title><style>
body { margin:0; background:#111; color:#ddd; font:13px monospace; }
#hud { position:fixed; top:8px; left:8px; white-space:pre; }
img { display:block; margin:0 auto; image-rendering:pixelated;
      width:min(90vw, 90vh); }
</style></head><body>
<div id="hud">drag: orbit | wheel: zoom | d: depth | p: add pose | e: export path</div>
<img id="view" src="/render?theta=0&phi=0.3&r=1.0&q=0">
<script>
let theta = 0, phi = 0.3, r = 1.0, drag = false, lx = 0, ly = 0;
let mode = "rgb", inflight = false, dirty = false, q = 0;
let path = [], ws = null, wsOk = false;
const img = document.getElementById("view");
const hud = document.getElementById("hud");
function connectWs() {
  try { ws = new WebSocket(`ws://${location.host}/ws`); }
  catch (e) { return; }
  ws.binaryType = "arraybuffer";
  ws.onopen = () => { wsOk = true; sendPose(); };
  ws.onclose = ws.onerror = () => { wsOk = false; };
  ws.onmessage = ev => {
    if (typeof ev.data === "string") {
      const d = JSON.parse(ev.data);
      if (d.type === "path_exported") {
        hud.textContent = `wrote ${d.path}`; path = [];
      }
      return;
    }
    // binary frame: [quality byte][png]; server pushes q=0,1,2
    const bytes = new Uint8Array(ev.data);
    const url = URL.createObjectURL(
      new Blob([bytes.subarray(1)], {type: "image/png"}));
    const old = img.src;
    img.onload = () => { if (old.startsWith("blob:")) URL.revokeObjectURL(old); };
    img.src = url;
  };
}
function sendPose() {
  if (wsOk) {
    ws.send(JSON.stringify({type: "pose", theta, phi, r, mode}));
  } else { q = 0; refresh(); }
}
function refresh() {   // HTTP fallback transport
  if (inflight) { dirty = true; return; }
  inflight = true;
  const src = `/render?theta=${theta}&phi=${phi}&r=${r}&mode=${mode}&q=${q}`;
  const probe = new Image();
  probe.onload = () => {
    img.src = probe.src; inflight = false;
    if (dirty) { dirty = false; q = 0; refresh(); }
    else if (q < 2) { q++; refresh(); }   // progressive refinement
  };
  probe.src = src;
}
function interact() { sendPose(); }
connectWs();
window.addEventListener("mousedown", e => { drag = true; lx = e.x; ly = e.y; });
window.addEventListener("mouseup", () => drag = false);
window.addEventListener("mousemove", e => {
  if (!drag) return;
  theta += (e.x - lx) * 0.01; phi += (e.y - ly) * 0.01;
  phi = Math.max(-1.4, Math.min(1.4, phi));
  lx = e.x; ly = e.y; interact();
});
window.addEventListener("wheel", e => {
  r *= Math.exp(e.deltaY * 0.001); r = Math.max(0.3, Math.min(3, r));
  interact();
});
window.addEventListener("keydown", e => {
  if (e.key === "d") { mode = mode === "rgb" ? "depth" : "rgb"; interact(); }
  if (e.key === "p") {
    path.push({theta: theta, phi: phi, r: r});
    hud.textContent = `path: ${path.length} pose(s) | e: export`;
  }
  if (e.key === "e" && path.length) {
    if (wsOk) {
      ws.send(JSON.stringify({type: "export_path", poses: path}));
    } else {
      fetch("/export_path", {method: "POST", body: JSON.stringify(path)})
        .then(rsp => rsp.json())
        .then(d => { hud.textContent = `wrote ${d.path}`; path = []; });
    }
  }
});
</script></body></html>"""

# progressive quality: resolution divisor per level (relative to the
# --downscale base resolution)
_QUALITY_DIVISORS = (4, 2, 1)


class _State:
    field = None
    proposal = None
    config = None
    cameras = None  # full-quality viewer cameras
    device = torch.device("cpu")
    radius = 4.0
    run_dir = "."
    path_count = 0
    reflect_memo: dict = {}  # render_image's bucket memo, across frames
    lock = threading.Lock()  # serializes renders (one card)
    path_lock = threading.Lock()  # guards path_count / export files


def _scaled_cameras(cams, divisor: int):
    if divisor <= 1:
        return cams
    from rsn_torch.data.cameras import Cameras
    return Cameras(camera_to_worlds=cams.camera_to_worlds,
                   fx=cams.fx / divisor, fy=cams.fy / divisor,
                   cx=cams.cx / divisor, cy=cams.cy / divisor,
                   width=cams.width // divisor,
                   height=cams.height // divisor)


def _pose_matrix(theta: float, phi: float, r: float) -> np.ndarray:
    from rsn_torch.data.synthetic import _look_at_pose

    eye = np.array([np.cos(theta) * np.cos(phi),
                    np.sin(theta) * np.cos(phi),
                    np.sin(phi)], np.float32)
    eye *= _State.radius * r
    return _look_at_pose(eye)


def _render_pose(theta: float, phi: float, r: float, mode: str,
                 q: int) -> bytes:
    """The viewer's frame at a pose and quality level as a PNG: the [0, 1]
    image times 255, truncated to uint8 (as rsn converts it)."""
    from rsn_torch.cli.render import apply_depth_colormap
    from rsn_torch.data.cameras import Cameras
    from rsn_torch.data.png import encode_png
    from rsn_torch.engine.trainer import preferred_eval_chunk, render_image
    from rsn_torch.models.model import final_rgb

    pose = _pose_matrix(theta, phi, r)
    divisor = _QUALITY_DIVISORS[max(0, min(q, len(_QUALITY_DIVISORS) - 1))]
    ref = _scaled_cameras(_State.cameras, divisor)
    cams = Cameras(
        camera_to_worlds=torch.from_numpy(
            np.ascontiguousarray(pose[None, :3, :4])),
        fx=ref.fx[:1], fy=ref.fy[:1], cx=ref.cx[:1], cy=ref.cy[:1],
        width=ref.width, height=ref.height).to(_State.device)
    with _State.lock:  # one render at a time (one card)
        # the viewer shows final_rgb / depth only: product-only render
        out = render_image(_State.field, cams, 0, _State.config,
                           rays_per_chunk=preferred_eval_chunk(
                               _State.config, _State.device),
                           product_only=True,
                           reflect_memo=_State.reflect_memo,
                           proposal=_State.proposal)
    mcfg = _State.config.pipeline.model
    if mode == "depth":
        img = apply_depth_colormap(out["depth_fine"],
                                   out["accumulation_fine"],
                                   mcfg.collider_near_plane,
                                   mcfg.collider_far_plane)
    else:
        img = np.clip(final_rgb(out), 0, 1)
    return encode_png((img * 255).astype(np.uint8))


def export_camera_path(poses, run_dir: str, cameras) -> str:
    """Write a camera-path JSON (rendered by rsn_torch.cli.render --mode
    path) from a list of {theta, phi, r} viewer poses."""
    frames = [{"camera_to_world": _pose_matrix(
        float(p["theta"]), float(p["phi"]), float(p["r"])).tolist()}
        for p in poses]
    path_dir = os.path.join(run_dir, "camera_paths")
    os.makedirs(path_dir, exist_ok=True)
    with _State.path_lock:  # concurrent exports must not share a name
        _State.path_count += 1
        count = _State.path_count
    fname = os.path.join(
        path_dir, f"path-{int(time.time())}-{count}.json")
    doc = {
        "camera_type": "perspective",
        "fx": float(cameras.fx[0]), "fy": float(cameras.fy[0]),
        "cx": float(cameras.cx[0]), "cy": float(cameras.cy[0]),
        "width": int(cameras.width), "height": int(cameras.height),
        "frames": frames,
    }
    with open(fname, "w") as f:
        json.dump(doc, f, indent=1)
    return fname


def _close_payload(code: int, reason: str) -> bytes:
    """A close frame's payload: the status code and as much of the reason
    as fits in a control frame (125 bytes)."""
    return struct.pack(">H", code) + reason.encode()[:123]


class _Handler(BaseHTTPRequestHandler):
    # websocket upgrades are an HTTP/1.1 feature (browsers reject a 101 on
    # an HTTP/1.0 status line); _reply always sets Content-Length, so
    # keep-alive is safe
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def _reply(self, body: bytes, ctype: str, code: int = 200):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # ---- websocket transport (RFC 6455; rsn_torch/utils/websocket.py) --

    def _ws_upgrade(self):
        """101 handshake, then serve push-rendered frames until close."""
        key = self.headers.get("Sec-WebSocket-Key")
        if not key:
            self._reply(b"missing Sec-WebSocket-Key", "text/plain", 400)
            return
        self.send_response(101, "Switching Protocols")
        for name, value in ws_lib.handshake_response_headers(key):
            self.send_header(name, value)
        self.end_headers()
        self.wfile.flush()
        self.close_connection = True
        try:
            self._ws_serve()
        except (ConnectionError, OSError):
            pass  # the peer went away mid-frame; nothing to salvage

    def _ws_send_json(self, obj):
        self.wfile.write(ws_lib.encode_frame(
            json.dumps(obj).encode(), ws_lib.OP_TEXT))
        self.wfile.flush()

    def _ws_dispatch(self, msg):
        """Handle one client message; returns a pose dict to render, or
        None for messages answered inline (export_path)."""
        opcode, payload = msg
        if opcode != ws_lib.OP_TEXT:
            return None
        d = json.loads(payload)
        if d.get("type") == "pose":
            return d
        if d.get("type") == "export_path":
            fname = export_camera_path(d.get("poses", []), _State.run_dir,
                                       _State.cameras)
            self._ws_send_json({"type": "path_exported", "path": fname,
                                "num_frames": len(d.get("poses", []))})
        return None

    def _ws_render(self, pose, q: int) -> bytes:
        """One frame's PNG; a failed render ends the session with a close
        frame (1011, the error) and is raised on, so the server prints
        it."""
        try:
            return _render_pose(
                float(pose.get("theta", 0.0)), float(pose.get("phi", 0.3)),
                float(pose.get("r", 1.0)), str(pose.get("mode", "rgb")), q)
        except Exception as e:
            try:
                self.wfile.write(ws_lib.encode_frame(_close_payload(
                    1011, f"render failed: {type(e).__name__}: {e}"),
                    ws_lib.OP_CLOSE))
                self.wfile.flush()
            except OSError:
                pass
            raise

    def _ws_serve(self):
        """Pose-coalescing render loop: the newest pose always wins.

        Each pose renders progressively (q=0 -> 1 -> 2), pushing a binary
        frame [quality byte][png] per level; between levels any queued
        client messages are drained and a fresh pose restarts refinement
        at q=0."""
        pending = None
        while True:
            if pending is None:
                msg = ws_lib.read_message(self.rfile, self.wfile)
                if msg is None:
                    return
                pending = self._ws_dispatch(msg)
                continue
            pose, pending = pending, None
            for q in range(len(_QUALITY_DIVISORS)):
                png = self._ws_render(pose, q)
                self.wfile.write(ws_lib.encode_frame(bytes([q]) + png,
                                                     ws_lib.OP_BINARY))
                self.wfile.flush()
                # coalesce whatever arrived while rendering (socket-level
                # readiness check; a frame already sitting in the rfile
                # buffer is picked up by the next blocking read)
                while select.select([self.connection], [], [], 0)[0]:
                    msg = ws_lib.read_message(self.rfile, self.wfile)
                    if msg is None:
                        return
                    got = self._ws_dispatch(msg)
                    if got is not None:
                        pending = got
                if pending is not None:
                    break  # a newer pose: restart refinement at q=0

    def do_GET(self):
        url = urlparse(self.path)
        if url.path == "/ws":
            self._ws_upgrade()
        elif url.path == "/":
            self._reply(_PAGE.encode(), "text/html")
        elif url.path == "/render":
            q = parse_qs(url.query)
            try:
                body = _render_pose(
                    float(q.get("theta", ["0"])[0]),
                    float(q.get("phi", ["0.3"])[0]),
                    float(q.get("r", ["1"])[0]),
                    q.get("mode", ["rgb"])[0],
                    int(q.get("q", ["0"])[0]))
            except Exception as e:
                self.close_connection = True
                self._reply(f"render failed: {type(e).__name__}: {e}"
                            .encode(), "text/plain", 500)
                raise
            self._reply(body, "image/png")
        else:
            self._reply(b"not found", "text/plain", 404)

    def do_POST(self):
        url = urlparse(self.path)
        if url.path != "/export_path":
            self._reply(b"not found", "text/plain", 404)
            return
        n = int(self.headers.get("Content-Length", "0"))
        poses = json.loads(self.rfile.read(n) or b"[]")
        fname = export_camera_path(poses, _State.run_dir, _State.cameras)
        self._reply(json.dumps(
            {"path": fname, "num_frames": len(poses)}).encode(),
            "application/json")


def load_state(load_dir: str, device, downscale: int = 2) -> int:
    """Fill _State from a run dir: the field (and proposal) on `device`,
    the train split's cameras at 1/downscale, their mean radius.
    -> the checkpoint's step."""
    from rsn_torch.cli.run_io import load_run_full
    from rsn_torch.data.blender import load_cameras

    field, config, step, extras = load_run_full(load_dir, device)
    dm = config.pipeline.datamanager
    cams = load_cameras(dm.dataparser, dm.data or "", "train",
                        dm.downscale_factor, dm.scale_factor)
    _State.field = field
    _State.proposal = extras.get("proposal")
    _State.config = config
    _State.cameras = _scaled_cameras(cams, downscale)
    _State.device = torch.device(device)
    _State.run_dir = load_dir
    _State.reflect_memo = {}
    _State.radius = float(np.linalg.norm(
        cams.camera_to_worlds.numpy()[:, :3, 3], axis=-1).mean())
    return step


def warm_up(server=None, failures=None) -> None:
    """Render the three quality levels once (the kernels' first launches
    and the reflect bucket).  A failure is printed, recorded in
    `failures` and shuts `server` down."""
    try:
        for q in range(len(_QUALITY_DIVISORS)):
            t0 = time.perf_counter()
            _render_pose(0.0, 0.3, 1.0, "rgb", q)
            print(f"viewer: warmed quality level {q} "
                  f"({time.perf_counter() - t0:.4f} s)", flush=True)
    except Exception as e:
        traceback.print_exc()
        if failures is not None:
            failures.append(e)
        if server is not None:
            server.shutdown()


def main(argv=None, device=None) -> int:
    """The CLI; device: the caller's choice of device (default the card)."""
    import argparse

    from rsn_torch.cli.run_io import entry_device

    p = argparse.ArgumentParser(description="interactive viewer (PyTorch "
                                            "port)")
    p.add_argument("--load-dir", required=True)
    p.add_argument("--port", type=int, default=7007)
    p.add_argument("--downscale", type=int, default=2,
                   help="full-quality resolution divisor (interactive "
                        "levels render at a further /4 and /2)")
    ns = p.parse_args(argv)
    device = entry_device(device)
    step = load_state(ns.load_dir, device, ns.downscale)

    server = ThreadingHTTPServer(("0.0.0.0", ns.port), _Handler)
    print(f"rsn_torch viewer (step {step}) at http://localhost:{ns.port}/",
          flush=True)
    failures: list = []
    threading.Thread(target=warm_up, args=(server, failures),
                     daemon=True).start()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    if failures:
        raise RuntimeError("viewer: the warm-up render failed") \
            from failures[0]
    return 0


if __name__ == "__main__":
    sys.exit(main())
