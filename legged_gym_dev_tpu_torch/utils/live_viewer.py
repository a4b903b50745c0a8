"""Interactive live viewer: browser-served frames + keyboard control.

Counterpart of ``legged_gym_dev_tpu/utils/live_viewer.py`` (the same page,
keys, HTTP routes and render gating). The reference runs an Isaac Gym GL
window with keyboard events and a camera the play script steers (ref:
legged_gym/envs/base/base_task.py:86-148 — QUIT / toggle_viewer_sync
subscriptions, render loop; legged_gym/scripts/play.py:96-110 — camera
follow). A remote card's machine has no display, so the viewer serves the
rendered view over HTTP to any browser and accepts the same keyboard
commands back on the socket:

    viewer = LiveViewer(env.sim.model)      # prints the URL
    ...
    viewer.push_state(base_pos, base_quat, q)   # once per env step
    for ev in viewer.pop_events():              # "quit" ends the loop
        ...

Keys (mirroring the reference's viewer semantics):
    ESC      quit (ref QUIT)
    V        toggle viewer sync — stop rendering, keep simulating
             (ref toggle_viewer_sync)
    SPACE    pause/resume the *viewer loop* (the driver polls ``paused``)
    arrows   orbit camera (azimuth/elevation)
    +/-      camera distance
    F        toggle camera follow (play.py's tracking camera)

Rendering uses the same MuJoCo EGL path as ``utils.video`` (surfaceless
headless GL; ``mujoco`` must be installed, and is imported at the first
frame); frames render only while a client is connected AND sync is on, so
an unattended run pays nothing. ``push_state`` takes numpy arrays or
tensors (copied to the host).
"""
from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>legged_gym_dev_tpu_torch live viewer</title><style>
body { background:#111; color:#ddd; font-family: monospace; }
img { border: 1px solid #333; }
</style></head><body>
<h3>legged_gym_dev_tpu_torch live viewer</h3>
<img id="v" width="%(w)d" height="%(h)d"/>
<pre id="s"></pre>
<pre>keys: ESC quit | V sync | SPACE pause | arrows orbit | +/- zoom | F follow</pre>
<script>
const img = document.getElementById('v'), st = document.getElementById('s');
async function tick() {
  img.src = '/frame.png?' + Date.now();
  try { const r = await fetch('/state.json');
        st.textContent = JSON.stringify(await r.json()); } catch (e) {}
  setTimeout(tick, 100);
}
tick();
document.addEventListener('keydown', (e) => {
  fetch('/key', {method: 'POST', body: JSON.stringify({key: e.key})});
});
</script></body></html>"""

_PNG_1PX = (  # 1x1 black PNG placeholder before the first frame
    b"\x89PNG\r\n\x1a\n\x00\x00\x00\rIHDR\x00\x00\x00\x01\x00\x00\x00\x01"
    b"\x08\x02\x00\x00\x00\x90wS\xde\x00\x00\x00\x0cIDATx\x9cc```\x00\x00"
    b"\x00\x04\x00\x01\xf6\x178U\x00\x00\x00\x00IEND\xaeB`\x82"
)


def _host(x):
    """A tensor's values on the host (numpy); anything else as it is."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else x


def _encode_png(frame: np.ndarray) -> bytes:
    import imageio.v3 as iio

    buf = io.BytesIO()
    iio.imwrite(buf, frame, extension=".png")
    return buf.getvalue()


class LiveViewer:
    """Serve live rendered frames; collect keyboard events (see module
    docstring). ``port=0`` picks a free port."""

    def __init__(self, model, port: int = 0, width: int = 640,
                 height: int = 480, env_index: int = 0,
                 cam_distance: float = 2.5):
        self.model = model
        self.width, self.height = width, height
        self.env_index = env_index
        self.enable_sync = True            # ref enable_viewer_sync
        self.paused = False
        self.follow = True
        self.cam = {"distance": float(cam_distance), "azimuth": 135.0,
                    "elevation": -15.0}
        self._events: List[str] = []
        self._lock = threading.Lock()
        self._png: bytes = _PNG_1PX
        self._frames = 0
        self._last_get = 0.0               # client liveness
        self._renderer = None              # lazy MuJoCo setup

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # silence request logging
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    viewer._last_get = time.time()
                    with viewer._lock:
                        png = viewer._png
                    self._send(200, "image/png", png)
                elif self.path.startswith("/state.json"):
                    self._send(200, "application/json", json.dumps({
                        "paused": viewer.paused,
                        "sync": viewer.enable_sync,
                        "follow": viewer.follow,
                        "cam": viewer.cam,
                        "frames": viewer._frames,
                    }).encode())
                else:
                    self._send(200, "text/html", (_PAGE % {
                        "w": viewer.width, "h": viewer.height}).encode())

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    key = json.loads(self.rfile.read(n)).get("key", "")
                except Exception:
                    key = ""
                viewer._handle_key(key)
                self._send(200, "application/json", b"{}")

        self._server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        print(f"live viewer: http://localhost:{self.port}/", flush=True)

    # -- keyboard semantics (ref base_task.py:120-148) --------------------
    def _handle_key(self, key: str) -> None:
        if key == "Escape":
            with self._lock:
                self._events.append("quit")
        elif key in ("v", "V"):
            self.enable_sync = not self.enable_sync
        elif key == " ":
            self.paused = not self.paused
        elif key == "ArrowLeft":
            self.cam["azimuth"] -= 10.0
        elif key == "ArrowRight":
            self.cam["azimuth"] += 10.0
        elif key == "ArrowUp":
            self.cam["elevation"] = min(self.cam["elevation"] + 5.0, 89.0)
        elif key == "ArrowDown":
            self.cam["elevation"] = max(self.cam["elevation"] - 5.0, -89.0)
        elif key in ("+", "="):
            self.cam["distance"] = max(self.cam["distance"] * 0.8, 0.3)
        elif key == "-":
            self.cam["distance"] = min(self.cam["distance"] * 1.25, 30.0)
        elif key in ("f", "F"):
            self.follow = not self.follow

    def pop_events(self) -> List[str]:
        with self._lock:
            ev, self._events = self._events, []
        return ev

    @property
    def client_connected(self) -> bool:
        return (time.time() - self._last_get) < 3.0

    # -- rendering --------------------------------------------------------
    def _ensure_renderer(self):
        if self._renderer is not None:
            return
        import os

        os.environ.setdefault("MUJOCO_GL", "egl")
        os.environ.setdefault("EGL_PLATFORM", "surfaceless")
        import mujoco

        from ..sim.mjcf import build_mjcf_from_model

        m = mujoco.MjModel.from_xml_string(
            build_mjcf_from_model(self.model, visual=True))
        d = mujoco.MjData(m)
        cam = mujoco.MjvCamera()
        mujoco.mjv_defaultFreeCamera(m, cam)
        qadr = {m.joint(i).name: int(m.joint(i).qposadr[0])
                for i in range(m.njnt)}
        self._dof_adr = [qadr[name] for name in self.model.dof_names]
        self._mj = (mujoco, m, d, cam)
        self._renderer = mujoco.Renderer(m, height=self.height,
                                         width=self.width)

    def push_state(self, base_pos, base_quat, q,
                   force_render: bool = False) -> None:
        """Feed one step's state of the viewed env (batch or single).

        Renders only when a client polled recently AND viewer sync is on
        (ref: the reference also skips gym rendering when sync is off) —
        the training/rollout loop pays nothing unattended.
        """
        if not force_render and not (self.enable_sync
                                     and self.client_connected):
            return
        self._ensure_renderer()
        mujoco, m, d, cam = self._mj
        bp, bq, qq = (np.asarray(_host(x), np.float64)
                      for x in (base_pos, base_quat, q))
        if bp.ndim == 2:                    # batched: view one env
            bp, bq, qq = (bp[self.env_index], bq[self.env_index],
                          qq[self.env_index])
        d.qpos[:3] = bp
        d.qpos[3:7] = [bq[3], bq[0], bq[1], bq[2]]   # xyzw -> wxyz
        for j, adr in enumerate(self._dof_adr):
            d.qpos[adr] = qq[j]
        mujoco.mj_forward(m, d)
        cam.distance = self.cam["distance"]
        cam.azimuth = self.cam["azimuth"]
        cam.elevation = self.cam["elevation"]
        if self.follow:
            cam.lookat[:] = bp
        self._renderer.update_scene(d, camera=cam)
        png = _encode_png(self._renderer.render())
        with self._lock:
            self._png = png
            self._frames += 1

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._renderer is not None:
            self._renderer.close()
            self._renderer = None
