"""Self-contained interactive 3D camera-pose viewer (HTML export; port of
neural_invertible_warp_tpu/utils/pose_viewer.py, a copy).

Capability parity with the reference's visdom camera-wireframe window
(reference util_vis.py:76-157 ``vis_cameras``: optimized blue vs reference
magenta frustum wireframes, camera-center markers, red pred<->GT center
links) — redesigned for this environment as a single offline HTML file with
NO server and NO external dependencies (visdom requires a running server and
a python client; this artifact opens in any browser, works over a plain file
copy from a remote machine, and additionally lets the user SCRUB through training
iterations, which the live visdom window cannot replay after the fact).

The 3D renderer is ~100 lines of inline canvas JS: orbit (drag), zoom
(wheel), iteration slider + play. Geometry is the same frustum model as
utils/vis.camera_frustums.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .vis import camera_frustums

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>camera poses</title>
<style>
 body {{ margin:0; background:#111; color:#ddd; font:13px sans-serif; }}
 #bar {{ padding:6px 10px; display:flex; gap:10px; align-items:center; }}
 #cv {{ display:block; }}
 input[type=range] {{ width: 40%; }}
</style></head><body>
<div id="bar">
 <button id="play">&#9654;</button>
 <input type="range" id="it" min="0" max="0" value="0" step="1">
 <span id="lab"></span>
 <span style="color:#6af">&#9632; optimized</span>
 <span style="color:#f6f">&#9632; reference</span>
 <span style="color:#f55">&#8212; center error</span>
 <span style="opacity:.6">drag: orbit &middot; wheel: zoom</span>
</div>
<canvas id="cv"></canvas>
<script>
const DATA = {data_json};
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
const slider = document.getElementById('it'), lab = document.getElementById('lab');
let yaw = 0.6, pitch = 0.4, dist = 4.0, frame = 0, playing = false;
slider.max = DATA.iters.length - 1;
function resize() {{ cv.width = innerWidth; cv.height = innerHeight - 40; draw(); }}
addEventListener('resize', resize);
function rot(p) {{
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  const x = cy*p[0] + sy*p[2], z0 = -sy*p[0] + cy*p[2];
  const y = cp*p[1] - sp*z0,  z = sp*p[1] + cp*z0;
  return [x, y, z + dist];
}}
function proj(p) {{
  const q = rot([p[0]-DATA.center[0], p[1]-DATA.center[1], p[2]-DATA.center[2]]);
  const f = 0.9 * Math.min(cv.width, cv.height) / Math.max(q[2], 1e-3);
  return [cv.width/2 + f*q[0], cv.height/2 + f*q[1]];
}}
function seg(a, b) {{ const p=proj(a), q=proj(b);
  ctx.beginPath(); ctx.moveTo(p[0],p[1]); ctx.lineTo(q[0],q[1]); ctx.stroke(); }}
function frustum(v, color) {{
  ctx.strokeStyle = color; ctx.lineWidth = 1;
  for (let i=1;i<5;i++) seg(v[0], v[i]);
  for (let i=1;i<5;i++) seg(v[i], v[i%4+1]);
  const c = proj(v[0]);
  ctx.fillStyle = color; ctx.fillRect(c[0]-1.5, c[1]-1.5, 3, 3);
}}
function draw() {{
  ctx.fillStyle = '#111'; ctx.fillRect(0,0,cv.width,cv.height);
  const fr = DATA.frames[frame];
  if (DATA.ref) {{
    for (const v of DATA.ref) frustum(v, '#f6f');
    ctx.strokeStyle = '#f55'; ctx.lineWidth = 1.2;
    for (let i=0;i<fr.length && i<DATA.ref.length;i++) seg(fr[i][0], DATA.ref[i][0]);
  }}
  for (const v of fr) frustum(v, '#6af');
  lab.textContent = 'iteration ' + DATA.iters[frame];
}}
slider.oninput = () => {{ frame = +slider.value; draw(); }};
document.getElementById('play').onclick = () => {{ playing = !playing; }};
setInterval(() => {{ if (playing) {{
  frame = (frame + 1) % DATA.iters.length; slider.value = frame; draw(); }} }}, 250);
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY];
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {{ if (drag) {{
  yaw += (e.clientX - drag[0]) * 0.01; pitch += (e.clientY - drag[1]) * 0.01;
  drag = [e.clientX, e.clientY]; draw(); }} }});
cv.onwheel = e => {{ dist *= Math.exp(e.deltaY * 0.001); e.preventDefault(); draw(); }};
resize();
</script></body></html>
"""


def export_interactive_poses(out_html, frames, pose_ref=None, cam_depth=0.2):
    """Write the interactive viewer.

    Args:
        frames: list of (iteration, poses [N,3,4] w2c).
        pose_ref: optional [N,3,4] ground-truth poses.
    Returns the output path.
    """
    iters = [int(ep) for ep, _ in frames]
    def frusta(poses):
        return [np.round(v, 4).tolist()
                for v in camera_frustums(poses, depth=cam_depth)]
    frame_data = [frusta(p) for _, p in frames]
    ref_data = frusta(pose_ref) if pose_ref is not None else None
    centers = np.concatenate(
        [np.asarray(f).reshape(-1, 3) for f in frame_data[-1:]] +
        ([np.asarray(ref_data).reshape(-1, 3)] if ref_data else []), axis=0)
    data = dict(iters=iters, frames=frame_data, ref=ref_data,
                center=np.round(centers.mean(axis=0), 4).tolist())
    html = _HTML.format(data_json=json.dumps(data))
    os.makedirs(os.path.dirname(out_html) or ".", exist_ok=True)
    with open(out_html, "w") as f:
        f.write(html)
    return out_html
