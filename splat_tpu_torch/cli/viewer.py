#!/usr/bin/env python
"""Interactive scene viewer, the ns-viewer equivalent (port of `cli/viewer.py`):
loads a trained checkpoint and serves a browser-based orbit viewer over HTTP;
frames are rendered server-side by the model on demand (drag to orbit, wheel
to zoom, sliders for exposure / rolling shutter to preview the motion
compensation on novel views, a crop box, and a cropped .ply download).

  python -m splat_tpu_torch.cli.viewer --load-config <run>/config.json [--port 7007]

It renders on the device the run was trained on (`device` in its config.json).

The viewer renders from a snapshot of the Gaussians, never from the live
tensors: the trainer's Adam updates its leaves in place and refine and
capacity growth resize them, so during training (`fit --vis viewer`) the
training loop publishes a detached copy between steps (`ViewerState.publish`)
and a request renders whichever copy was published last.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

PAGE = """<!DOCTYPE html>
<html><head><title>splat_tpu_torch viewer</title><style>
body { margin:0; background:#111; color:#ddd; font-family:monospace; }
#hud { position:fixed; top:8px; left:8px; background:#000a; padding:8px; border-radius:6px; }
img { width:100vw; height:100vh; object-fit:contain; display:block; }
label { display:block; margin-top:4px; }
</style></head><body>
<img id="view" draggable="false">
<div id="hud">
  <div>drag: orbit &middot; wheel: zoom</div>
  <label>exposure <input id="exp" type="range" min="0" max="0.5" step="0.01" value="0"></label>
  <label>rolling shutter <input id="rs" type="range" min="0" max="0.1" step="0.005" value="0"></label>
  <details><summary>crop box</summary>
    <label>x <input id="cx0" class="crop" type="range" min="0" max="1" step="0.02" value="0">
           <input id="cx1" class="crop" type="range" min="0" max="1" step="0.02" value="1"></label>
    <label>y <input id="cy0" class="crop" type="range" min="0" max="1" step="0.02" value="0">
           <input id="cy1" class="crop" type="range" min="0" max="1" step="0.02" value="1"></label>
    <label>z <input id="cz0" class="crop" type="range" min="0" max="1" step="0.02" value="0">
           <input id="cz1" class="crop" type="range" min="0" max="1" step="0.02" value="1"></label>
  </details>
  <div><a id="plylink" href="/export.ply" download style="color:#8cf">download .ply (3DGS, cropped)</a></div>
  <div id="stat"></div>
</div>
<script>
let yaw=0.6, pitch=0.4, radius=2.5, drag=null, busy=false, dirty=true;
const img=document.getElementById('view');
function refresh(){
  if(busy){dirty=true;return;}
  busy=true;dirty=false;
  const t0=performance.now();
  const exp=document.getElementById('exp').value, rs=document.getElementById('rs').value;
  const crop=['cx0','cx1','cy0','cy1','cz0','cz1'].map(i=>`${i}=${document.getElementById(i).value}`).join('&');
  document.getElementById('plylink').href=`/export.ply?${crop}`;
  fetch(`/render?yaw=${yaw}&pitch=${pitch}&r=${radius}&exp=${exp}&rs=${rs}&${crop}`)
   .then(r=>r.blob()).then(b=>{
     img.src=URL.createObjectURL(b);
     document.getElementById('stat').textContent=`${(performance.now()-t0).toFixed(0)} ms`;
     busy=false; if(dirty) refresh();
   }).catch(()=>{busy=false;});
}
img.addEventListener('mousedown',e=>{drag=[e.clientX,e.clientY];});
window.addEventListener('mouseup',()=>{drag=null;});
window.addEventListener('mousemove',e=>{
  if(!drag) return;
  yaw += (e.clientX-drag[0])*0.01; pitch += (e.clientY-drag[1])*0.01;
  pitch=Math.max(-1.4,Math.min(1.4,pitch)); drag=[e.clientX,e.clientY]; refresh();
});
window.addEventListener('wheel',e=>{radius*=Math.exp(e.deltaY*0.001);refresh();});
document.getElementById('exp').addEventListener('input',refresh);
document.getElementById('rs').addEventListener('input',refresh);
for(const el of document.querySelectorAll('.crop')) el.addEventListener('input',refresh);
refresh();
</script></body></html>"""


class ViewerState:
    def __init__(self, config_path: Path, res: int):
        from .evaluate import load_trainer_from_config

        cfg, trainer = load_trainer_from_config(config_path)
        self._init(cfg, trainer, res)

    @classmethod
    def from_trainer(cls, cfg, trainer, res: int) -> "ViewerState":
        """Live-training viewer (ns-train --vis viewer equivalent): the
        training loop calls `publish(trainer)` between steps, and renders
        read the newest published snapshot."""
        self = cls.__new__(cls)
        self._init(cfg, trainer, res)
        return self

    def _init(self, cfg, trainer, res: int):
        self.cfg = cfg
        self.res = res
        self.device = trainer.device
        self._lock = threading.Lock()          # guards the snapshot
        self._render_lock = threading.Lock()   # one render at a time
        self.publish(trainer)
        # orbit target: scene centroid of alive gaussians
        g = self.snapshot()[0].gaussians
        alive = g.alive.cpu().numpy() > 0.5
        means = g.means.cpu().numpy()[alive]
        self.center = means.mean(axis=0)
        # robust scene AABB for the crop-box sliders (fractions -> world)
        self.aabb_lo = np.percentile(means, 1, axis=0)
        self.aabb_hi = np.percentile(means, 99, axis=0)

    @torch.no_grad()
    def publish(self, trainer) -> None:
        """Copy trainer's Gaussians and background (detached; no per-camera
        corrections: viewer cameras are novel views) as the snapshot renders
        read. Call it on the training thread, between steps. A step already
        published is not copied again."""
        from ..models import splatfacto as sf

        last = getattr(self, "_snapshot", None)
        if last is not None and last[1] == int(trainer.step):
            return
        p = trainer.params
        params = sf.ModelParams(
            gaussians=sf.GaussianParams(*(t.detach().clone() for t in p.gaussians)),
            background_logit=p.background_logit.detach().clone(),
            camera_opt={}, velocity_opt={}, eval_camera_opt={}, eval_velocity_opt={})
        with self._lock:
            self._snapshot = (params, int(trainer.step))

    def snapshot(self):
        """(ModelParams, step) of the newest published snapshot."""
        with self._lock:
            return self._snapshot

    def crop_to_world(self, crop):
        """(x0,x1,y0,y1,z0,z1) AABB fractions -> (lo, hi) world coords."""
        f = np.asarray(crop, np.float32).reshape(3, 2)
        span = self.aabb_hi - self.aabb_lo
        return self.aabb_lo + f[:, 0] * span, self.aabb_lo + f[:, 1] * span

    def camera(self, yaw, pitch, radius, exposure, rs_time):
        """The orbit camera at (yaw, pitch, radius) around the centroid, moving
        tangentially when exposure or rolling shutter is previewed."""
        from ..cameras import paths as pth
        from ..cameras.cameras import Cameras

        pos = self.center + radius * np.array(
            [np.cos(pitch) * np.cos(yaw), np.cos(pitch) * np.sin(yaw), np.sin(pitch)]
        )
        c2w_gl = pth.look_at(pos, self.center)
        f32 = dict(dtype=torch.float32, device=self.device)
        R_cv, p = Cameras.gl_to_cv_c2w(torch.as_tensor(c2w_gl[None], **f32))
        res = self.res
        fl = res * 1.0
        full = lambda v: torch.full((1,), float(v), **f32)  # noqa: E731
        # tangential orbit motion for blur/RS preview
        vel = np.array([1.0, 0.0, 0.0]) * (0.5 if exposure > 0 or rs_time > 0 else 0.0)
        return Cameras(
            R_cv, p, full(fl), full(fl), full(res / 2), full(res / 2), res, res,
            lin_vel=torch.as_tensor(vel[None], **f32),
            ang_vel=torch.zeros((1, 3), **f32),
            exposure_time=full(exposure),
            rolling_shutter_time=full(rs_time),
            cam_idx=torch.zeros((1,), dtype=torch.int64, device=self.device),
        )

    def render(self, yaw, pitch, radius, exposure, rs_time, crop=None) -> bytes:
        """PNG of the snapshot from the orbit camera; a crop box other than
        the whole AABB zeroes `alive` outside it."""
        from ..data.png import encode_png
        from ..models import splatfacto as sf
        from .render_model import to_uint8
        from .render_video import render_frame

        cam = self.camera(yaw, pitch, radius, exposure, rs_time)
        mcfg = dataclasses.replace(
            self.cfg.model,
            blur_samples=5 if exposure > 0 else 0,
            rolling_shutter_compensation=True,
        )
        params, step = self.snapshot()
        if crop is not None and tuple(crop) != (0.0, 1.0, 0.0, 1.0, 0.0, 1.0):
            lo, hi = self.crop_to_world(crop)
            g = params.gaussians
            as_t = lambda a: torch.as_tensor(a, dtype=g.means.dtype, device=g.means.device)  # noqa: E731
            inside = torch.all((g.means >= as_t(lo)) & (g.means <= as_t(hi)), dim=1)
            params = params._replace(
                gaussians=g._replace(alive=g.alive * inside.to(g.alive.dtype)))
        sh_deg = int(sf.active_sh_degree(mcfg, step))
        with self._render_lock:
            img = render_frame(params, cam, mcfg, sh_deg)
        return encode_png(to_uint8(img))

    def export_ply(self, query: dict) -> bytes:
        """The snapshot's Gaussians as a 3DGS PLY; `query` (parsed URL query)
        may hold minop, a world box (xmin..zmax) or the crop sliders'
        fractions (cx0..cz1)."""
        from .export import export_gaussians, export_mask

        g = self.snapshot()[0].gaussians
        minop = float(query.get("minop", [0])[0])
        axes = ("x", "y", "z")
        lo = hi = None
        if all(f"{a}{m}" in query for a in axes for m in ("min", "max")):
            lo = np.array([float(query[f"{a}min"][0]) for a in axes])
            hi = np.array([float(query[f"{a}max"][0]) for a in axes])
        elif any(k in query for k in ("cx0", "cx1", "cy0", "cy1", "cz0", "cz1")):
            # viewer crop-box sliders: AABB fractions
            getf = lambda k, d: float(query.get(k, [d])[0])  # noqa: E731
            lo, hi = self.crop_to_world((
                getf("cx0", 0), getf("cx1", 1), getf("cy0", 0),
                getf("cy1", 1), getf("cz0", 0), getf("cz1", 1),
            ))
        keep = export_mask(g, minop, lo, hi)
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "export.ply"
            export_gaussians(path, g, keep)
            return path.read_bytes()


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code: int, body: bytes, content_type: str | None = None):
            self.send_response(code)
            if content_type:
                self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if url.path == "/":
                self._send(200, PAGE.encode(), "text/html")
            elif url.path == "/render":
                get = lambda k, d: float(q.get(k, [d])[0])  # noqa: E731
                try:
                    png = state.render(
                        get("yaw", 0), get("pitch", 0.3), get("r", 2.5),
                        get("exp", 0), get("rs", 0),
                        crop=(get("cx0", 0), get("cx1", 1), get("cy0", 0),
                              get("cy1", 1), get("cz0", 0), get("cz1", 1)),
                    )
                except Exception as e:  # surface render errors to the client
                    self._send(500, str(e).encode())
                    return
                self._send(200, png, "image/png")
            elif url.path == "/export.ply":
                # ns-export gaussian-splat equivalent, from the newest snapshot
                # (works mid-training)
                self._send(200, state.export_ply(q), "application/octet-stream")
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def serve(state: ViewerState, host: str = "0.0.0.0", port: int = 7007,
          block: bool = False):
    """Start the viewer HTTP server; block=False runs it on a daemon thread
    (what `fit --vis viewer` does for live-training viewing). Returns the
    server (`server.server_address[1]` is the port when 0 was asked for)."""
    server = ThreadingHTTPServer((host, port), make_handler(state))
    print(f"viewer at http://{host}:{server.server_address[1]}/", flush=True)
    if block:
        server.serve_forever()
        return server
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--load-config", required=True)
    ap.add_argument("--port", type=int, default=7007)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--resolution", type=int, default=256)
    args = ap.parse_args(argv)

    state = ViewerState(Path(args.load_config), args.resolution)
    serve(state, args.host, args.port, block=True)


if __name__ == "__main__":
    main()
