"""Interactive live viewer — a dependency-free web UI over the running map.

Port of orb_slam2_aruco_tpu/viz/viewer.py. It replaces the reference's
Pangolin/OpenCV GUI thread (src/Viewer.cc:57-,
src/MapDrawer.cc:118+, cv::imshow of FrameDrawer output at Viewer.cc:143)
with a stdlib HTTP server + an in-browser canvas renderer: the host loop
calls ``MapViewer.update(system, frame_rgb)`` once per frame (cheap numpy
snapshot under a lock), and any browser pointed at the port gets

  * a 3D map view with orbit/zoom/pan: map points, keyframe frusta, the
    covisibility graph, ArUco marker quads with ids, and the current
    camera (MapDrawer::DrawMapPoints/DrawKeyFrames/DrawGraph/DrawAruco/
    DrawCurrentCamera),
  * the current-frame overlay image (FrameDrawer::DrawFrame),
  * the reference's menu toggles (Viewer.cc:71-78): Follow Camera, Show
    Points, Show KeyFrames, Show Graph, Show Aruco, Localization Mode,
    Reset — mode/reset are delivered back to the host loop through
    ``poll_controls()``, mirroring the Viewer→Tracking flag protocol
    (Viewer.cc menuLocalizationMode / menuReset handling),
  * the FrameDrawer status bar (state, KFs, MPs, markers, matches —
    FrameDrawer::DrawTextInfo, FrameDrawer.cc:172-206).

Rendering happens client-side (JS perspective projection). Publishing a map
snapshot DOES copy the map state from the card to the host (a deliberate
read, off the hot path) and run a BLAS covisibility matmul, so ``update``
recomputes it only every ``snapshot_every`` calls — feed frames at a
decimated rate (or raise snapshot_every); the camera pose and frame image
alone are cheap.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from orb_slam2_aruco_tpu_torch.viz.framedrawer import encode_png, host
from orb_slam2_aruco_tpu_torch.worldmap.state import MapState

# canonical marker corners in the marker frame, reference corner order
# (MapAruco.cc:30-37): c0=(-s/2,+s/2,0) c1=(+s/2,+s/2,0) c2=(+s/2,-s/2,0)
# c3=(-s/2,-s/2,0)
_CANON = np.asarray(
    [[-0.5, 0.5, 0.0], [0.5, 0.5, 0.0], [0.5, -0.5, 0.0], [-0.5, -0.5, 0.0]],
    np.float32,
)


def snapshot_map(
    state: MapState,
    max_points: int = 20000,
    covis_min_weight: int = 15,
    max_edges: int = 2048,
) -> Dict:
    """Serializable world snapshot for the client renderer.

    Covisibility weights are recomputed on host from the point<->keyframe
    incidence (shared-MapPoint count, KeyFrame::UpdateConnections semantics,
    edge iff weight >= 15 — KeyFrame.cc:386-476)."""
    kf_valid = host(state.kf_valid)
    pt_valid = host(state.pt_valid)
    mk_valid = host(state.mk_valid)

    kf_idx = np.flatnonzero(kf_valid)
    R = host(state.kf_Rcw)[kf_idx]          # [k,3,3] world->cam
    t = host(state.kf_tcw)[kf_idx]          # [k,3]
    Rwc = np.swapaxes(R, 1, 2)
    centers = -np.einsum("kij,kj->ki", Rwc, t)

    pts = host(state.pt_xyz)[pt_valid]
    if len(pts) > max_points:
        pts = pts[:: len(pts) // max_points + 1]

    # covisibility edges over valid keyframes. float32 so the matmul takes
    # the BLAS path — an integer matmul on a full [20000, 256] incidence is
    # ~1e9 scalar MACs of pure-numpy loop time
    B = host(state.pt_obs_kf)[np.ix_(pt_valid, kf_idx)].astype(np.float32)
    W = (
        (B.T @ B).astype(np.int32)
        if B.size
        else np.zeros((len(kf_idx), len(kf_idx)), np.int32)
    )
    np.fill_diagonal(W, 0)
    ii, jj = np.nonzero(np.triu(W, 1) >= covis_min_weight)
    if len(ii) > max_edges:
        order = np.argsort(-W[ii, jj])[:max_edges]
        ii, jj = ii[order], jj[order]

    mk_idx = np.flatnonzero(mk_valid)
    mk_R = host(state.mk_Rwm)[mk_idx]
    mk_t = host(state.mk_twm)[mk_idx]
    mk_s = host(state.mk_side)[mk_idx]
    mk_id = host(state.mk_id)
    quads = (
        np.einsum("mij,cj->mci", mk_R, _CANON) * mk_s[:, None, None]
        + mk_t[:, None, :]
    )

    return {
        "points": np.round(pts, 4).tolist(),
        "kf_centers": np.round(centers, 4).tolist(),
        "kf_rwc": np.round(Rwc.reshape(len(kf_idx), 9), 5).tolist(),
        "covis_edges": np.stack([ii, jj], axis=1).tolist() if len(ii) else [],
        "markers": [
            {"id": int(mk_id[m]), "quad": np.round(q, 4).tolist()}
            for m, q in zip(mk_idx, quads)
        ],
    }


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>orb_slam2_aruco_tpu_torch viewer</title>
<style>
 body{margin:0;background:#14161a;color:#d8dce2;font:13px system-ui,sans-serif;display:flex;height:100vh}
 #left{flex:1;position:relative}  canvas{display:block;width:100%;height:100%}
 #side{width:360px;padding:10px;overflow:auto;border-left:1px solid #2a2e35}
 #frame{width:100%;border:1px solid #2a2e35;border-radius:4px;background:#000}
 label{display:block;margin:4px 0;cursor:pointer} #status{white-space:pre;color:#9fd49f;margin:8px 0}
 button{background:#2a2e35;color:#d8dce2;border:1px solid #3a3f47;border-radius:4px;padding:4px 10px;margin:2px;cursor:pointer}
 h3{margin:6px 0;font-size:14px;color:#8ab4f8}
</style></head><body>
<div id="left"><canvas id="c"></canvas></div>
<div id="side">
 <h3>orb_slam2_aruco_tpu_torch</h3>
 <img id="frame" src="/frame.png">
 <div id="status">waiting for data…</div>
 <label><input type="checkbox" id="follow"> Follow Camera</label>
 <label><input type="checkbox" id="pts" checked> Show Points</label>
 <label><input type="checkbox" id="kfs" checked> Show KeyFrames</label>
 <label><input type="checkbox" id="graph" checked> Show Graph</label>
 <label><input type="checkbox" id="aruco" checked> Show Aruco</label>
 <label><input type="checkbox" id="locmode"> Localization Mode</label>
 <button id="reset">Reset</button>
 <div style="margin-top:8px;color:#777">drag: orbit &middot; wheel: zoom &middot; shift-drag: pan</div>
</div>
<script>
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let S=null,yaw=-0.6,pitch=0.5,dist=6,cx=0,cy=0,cz=0,drag=null;
cv.addEventListener('mousedown',e=>drag={x:e.clientX,y:e.clientY,shift:e.shiftKey});
window.addEventListener('mouseup',()=>drag=null);
window.addEventListener('mousemove',e=>{if(!drag)return;const dx=e.clientX-drag.x,dy=e.clientY-drag.y;
 if(drag.shift){cx-=dx*dist*0.002;cy+=dy*dist*0.002;}else{yaw+=dx*0.008;pitch+=dy*0.008;}
 drag.x=e.clientX;drag.y=e.clientY;draw();});
cv.addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*0.001);draw();e.preventDefault();});
function proj(p,w,h){
 const cy_=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 let x=p[0]-cx,y=p[1]-cy,z=p[2]-cz;
 let x1=cy_*x+sy*z, z1=-sy*x+cy_*z;
 let y2=cp*y-sp*z1, z2=sp*y+cp*z1+dist;
 if(z2<0.05)return null;
 const f=0.9*Math.min(w,h);
 return [w/2+f*x1/z2,h/2-f*y2/z2,z2];
}
function line(a,b,w,h){const p=proj(a,w,h),q=proj(b,w,h);if(!p||!q)return;
 ctx.beginPath();ctx.moveTo(p[0],p[1]);ctx.lineTo(q[0],q[1]);ctx.stroke();}
function draw(){
 const w=cv.width=cv.clientWidth,h=cv.height=cv.clientHeight;
 ctx.fillStyle='#14161a';ctx.fillRect(0,0,w,h);
 if(!S)return;
 if(document.getElementById('pts').checked){ctx.fillStyle='#c8ccd4';
  for(const p of S.points){const q=proj(p,w,h);if(q)ctx.fillRect(q[0],q[1],1.6,1.6);}}
 if(document.getElementById('graph').checked){ctx.strokeStyle='#3d6b3d';ctx.lineWidth=1;
  for(const e of S.covis_edges)line(S.kf_centers[e[0]],S.kf_centers[e[1]],w,h);}
 if(document.getElementById('kfs').checked){ctx.strokeStyle='#5b8dd6';ctx.lineWidth=1;
  for(let k=0;k<S.kf_centers.length;k++)frustum(S.kf_centers[k],S.kf_rwc[k],0.08,w,h);}
 if(document.getElementById('aruco').checked){ctx.strokeStyle='#e06666';ctx.lineWidth=2;
  ctx.fillStyle='#e06666';
  for(const m of S.markers){const q=m.quad;
   for(let i=0;i<4;i++)line(q[i],q[(i+1)%4],w,h);
   const c=proj([(q[0][0]+q[2][0])/2,(q[0][1]+q[2][1])/2,(q[0][2]+q[2][2])/2],w,h);
   if(c)ctx.fillText('id '+m.id,c[0]+4,c[1]-4);}}
 if(S.cam){ctx.strokeStyle='#6fe06f';ctx.lineWidth=2;frustum(S.cam.c,S.cam.rwc,0.12,w,h);}
}
function frustum(c,r9,s,w,h){
 const ax=[r9[0],r9[3],r9[6]],ay=[r9[1],r9[4],r9[7]],az=[r9[2],r9[5],r9[8]];
 const corner=(u,v)=>[c[0]+s*(u*ax[0]+v*ay[0]+1.6*az[0]),c[1]+s*(u*ax[1]+v*ay[1]+1.6*az[1]),c[2]+s*(u*ax[2]+v*ay[2]+1.6*az[2])];
 const q=[corner(-1,-0.7),corner(1,-0.7),corner(1,0.7),corner(-1,0.7)];
 for(let i=0;i<4;i++){line(c,q[i],w,h);line(q[i],q[(i+1)%4],w,h);}
}
async function tick(){
 try{
  const r=await fetch('/state');const j=await r.json();S=j.map;S.cam=j.cam;
  document.getElementById('status').textContent=j.status;
  document.getElementById('frame').src='/frame.png?'+j.seq;
  if(document.getElementById('follow').checked&&j.cam){cx=j.cam.c[0];cy=j.cam.c[1];cz=j.cam.c[2];}
  draw();
 }catch(e){}
 setTimeout(tick,250);
}
function send(cmd,val){fetch('/control',{method:'POST',body:JSON.stringify({cmd:cmd,value:val})});}
document.getElementById('locmode').addEventListener('change',e=>send('localization',e.target.checked));
document.getElementById('reset').addEventListener('click',()=>send('reset',true));
tick();
</script></body></html>"""

_BLANK_PNG = encode_png(np.zeros((2, 2, 3), np.uint8))


class MapViewer:
    """Background HTTP viewer; attach with update(), read back controls
    with poll_controls() (the Viewer→Tracking flag protocol)."""

    def __init__(self, port: int = 0, snapshot_every: int = 1):
        self._lock = threading.Lock()
        self._state_json = json.dumps(
            {"map": {"points": [], "kf_centers": [], "kf_rwc": [],
                     "covis_edges": [], "markers": []},
             "cam": None, "status": "no data yet", "seq": 0}
        ).encode()
        self._frame_png = _BLANK_PNG
        self._controls: Dict = {}
        self._seq = 0
        self._snapshot_every = max(1, snapshot_every)
        self._last_map = None

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request logging
                pass

            def _reply(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._reply(200, "text/html", _PAGE.encode())
                elif path == "/state":
                    with viewer._lock:
                        body = viewer._state_json
                    self._reply(200, "application/json", body)
                elif path == "/frame.png":
                    with viewer._lock:
                        body = viewer._frame_png
                    self._reply(200, "image/png", body)
                else:
                    self._reply(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path != "/control":
                    self._reply(404, "text/plain", b"not found")
                    return
                # reject cross-origin requests: /control mutates the live
                # system (reset, localization mode), and a POST with JSON
                # text body is a CORS 'simple request' any webpage could
                # send at localhost — require the Origin (when present) to
                # match our own Host
                origin = self.headers.get("Origin")
                host = self.headers.get("Host")
                if origin is not None and origin.split("://")[-1] != host:
                    self._reply(403, "text/plain", b"cross-origin rejected")
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    msg = json.loads(self.rfile.read(n) or b"{}")
                    with viewer._lock:
                        viewer._controls[str(msg.get("cmd"))] = msg.get("value")
                    self._reply(200, "application/json", b"{}")
                except Exception:
                    self._reply(400, "text/plain", b"bad request")

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def update(
        self,
        system=None,
        frame_rgb: Optional[np.ndarray] = None,
        *,
        map_state: Optional[MapState] = None,
        cam_Rcw: Optional[np.ndarray] = None,
        cam_tcw: Optional[np.ndarray] = None,
        status: str = "",
    ) -> None:
        """Publish the current world + camera + frame. Pass a SlamSystem, or
        the pieces explicitly. The map snapshot is recomputed every
        ``snapshot_every`` calls (points move only at BA/loop events; the
        camera updates every call)."""
        if system is not None:
            map_state = system.map
            if getattr(system, "last_pose", None) is not None:
                cam_Rcw = host(system.last_pose[0])
                cam_tcw = host(system.last_pose[1])
            if not status:
                status = (
                    f"state: {system.state.name}\n"
                    f"KFs: {system.n_keyframes}  "
                    f"MPs: {int(system.map.pt_valid.sum())}  "
                    f"markers: {int(system.map.mk_valid.sum())}\n"
                    f"frame: {system.frame_id}  "
                    f"mode: {'LOC' if system.localization_only else 'SLAM'}"
                )

        self._seq += 1
        if map_state is not None and (
            self._last_map is None or self._seq % self._snapshot_every == 0
        ):
            self._last_map = snapshot_map(map_state)
        snap = self._last_map or {
            "points": [], "kf_centers": [], "kf_rwc": [],
            "covis_edges": [], "markers": [],
        }

        cam = None
        if cam_Rcw is not None and cam_tcw is not None:
            Rwc = host(cam_Rcw).T
            c = -Rwc @ host(cam_tcw)
            cam = {"c": np.round(c, 4).tolist(),
                   "rwc": np.round(Rwc.reshape(9), 5).tolist()}

        body = json.dumps(
            {"map": snap, "cam": cam, "status": status, "seq": self._seq}
        ).encode()
        png = encode_png(frame_rgb) if frame_rgb is not None else None
        with self._lock:
            self._state_json = body
            if png is not None:
                self._frame_png = png

    def poll_controls(self) -> Dict:
        """One-shot drain of pending UI commands: {'localization': bool,
        'reset': True} — apply like Viewer.cc's menu flag checks."""
        with self._lock:
            out, self._controls = self._controls, {}
        return out

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
