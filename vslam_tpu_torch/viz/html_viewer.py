"""Self-contained interactive HTML map/trajectory viewer.

The headless replacement for the reference's Pangolin inspection loop
(src/slam.cpp:534-1004): a single HTML file (no external
assets — works with zero egress) with

- a 3D orbit view of the map: landmarks, estimated keyframe trajectory,
  ground truth, loop edges; drag to rotate, wheel to zoom;
- a per-frame timeline (inliers, keyframe events) with a crosshair
  tooltip; scrubbing the timeline highlights the camera position in 3D.

Written by ``cli.py --viz-html out.html`` and usable directly:
``write_html(path, trajectory=..., landmarks=..., ...)``.
"""

from __future__ import annotations

import json

import numpy as np

_MAX_LANDMARKS = 30000


def _ds(arr, cap):
    arr = np.asarray(arr, np.float32)
    if len(arr) > cap:
        idx = np.linspace(0, len(arr) - 1, cap).astype(int)
        arr = arr[idx]
    return arr


def write_html(path, trajectory, landmarks=None, gt=None, keyframes=None,
               inliers=None, is_keyframe=None, loop_edges=None,
               title="vslam_tpu map"):
    """Write the viewer.

    trajectory [F, 3] (or [F, 7], positions taken), landmarks [L, 3],
    gt [G, 3], keyframes [K, 3], inliers [F], is_keyframe [F] bool,
    loop_edges [(xyz_a, xyz_b)].
    """
    traj = np.asarray(trajectory, np.float32)
    if traj.ndim == 2 and traj.shape[1] >= 3:
        traj = traj[:, :3]
    data = {
        "traj": traj.tolist(),
        "lm": _ds(landmarks, _MAX_LANDMARKS).tolist()
        if landmarks is not None and len(landmarks) else [],
        "gt": _ds(gt, 4000).tolist() if gt is not None and len(gt) else [],
        "kf": np.asarray(keyframes, np.float32)[:, :3].tolist()
        if keyframes is not None and len(keyframes) else [],
        "inl": np.asarray(inliers, np.float64).tolist()
        if inliers is not None else [],
        "iskf": np.asarray(is_keyframe, bool).astype(int).tolist()
        if is_keyframe is not None else [],
        "loops": [[list(map(float, a[:3])), list(map(float, b[:3]))]
                  for a, b in (loop_edges or [])],
        "title": title,
    }
    html = _TEMPLATE.replace("__DATA__", json.dumps(data))
    with open(path, "w") as f:
        f.write(html)
    return path


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>vslam_tpu viewer</title>
<style>
.viz-root {
  color-scheme: light;
  --surface-1: #fcfcfb; --surface-2: #f1f0ec;
  --text-primary: #0b0b0b; --text-secondary: #52514e;
  --grid: #e4e2dc;
  --series-1: #2a78d6;  /* estimated trajectory */
  --series-2: #eb6834;  /* ground truth */
  --series-3: #1baf7a;  /* keyframes */
  --lm: #a8a69e;        /* landmarks (muted ink) */
  --loop: #e34948;      /* loop edges */
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root {
    color-scheme: dark;
    --surface-1: #1a1a19; --surface-2: #242422;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --grid: #33332f;
    --series-1: #3987e5; --series-2: #d95926; --series-3: #199e70;
    --lm: #6d6c66; --loop: #e66767;
  }
}
html, body { margin: 0; height: 100%; }
.viz-root { font: 13px/1.45 system-ui, sans-serif; background: var(--surface-1);
  color: var(--text-primary); height: 100%; display: flex;
  flex-direction: column; }
header { padding: 8px 14px; display: flex; gap: 18px; align-items: baseline; }
header h1 { font-size: 15px; margin: 0; }
.legend { display: flex; gap: 14px; color: var(--text-secondary); }
.legend span::before { content: ""; display: inline-block; width: 10px;
  height: 10px; border-radius: 3px; margin-right: 5px; vertical-align: -1px; }
.l-est::before { background: var(--series-1); }
.l-gt::before { background: var(--series-2); }
.l-kf::before { background: var(--series-3); }
.l-lm::before { background: var(--lm); }
.l-loop::before { background: var(--loop); }
#c3d { flex: 1; min-height: 0; cursor: grab; }
#timeline { height: 130px; }
.hint { color: var(--text-secondary); font-size: 12px; }
#tip { position: fixed; pointer-events: none; background: var(--surface-2);
  color: var(--text-primary); border: 1px solid var(--grid);
  border-radius: 6px; padding: 4px 8px; display: none; font-size: 12px; }
</style></head>
<body><div class="viz-root">
<header><h1 id="title"></h1>
<div class="legend">
  <span class="l-est">estimated</span><span class="l-gt">ground truth</span>
  <span class="l-kf">keyframes</span><span class="l-lm">landmarks</span>
  <span class="l-loop">loop edges</span></div>
<span class="hint">drag = rotate &middot; wheel = zoom &middot;
hover timeline = scrub</span></header>
<canvas id="c3d"></canvas>
<canvas id="timeline"></canvas>
<div id="tip"></div>
<script>
const D = __DATA__;
document.getElementById('title').textContent = D.title;
const css = n => getComputedStyle(document.querySelector('.viz-root'))
  .getPropertyValue(n).trim();

// ---------- 3D orbit view ----------
const c3 = document.getElementById('c3d'), g3 = c3.getContext('2d');
let yaw = 0.6, pitch = 0.4, zoom = 1.0, cursor = -1;
const all = D.traj.concat(D.lm, D.gt);
let cx=0, cy=0, cz=0, span=1;
if (all.length) {
  const mins=[1e9,1e9,1e9], maxs=[-1e9,-1e9,-1e9];
  for (const p of all) for (let i=0;i<3;i++){
    if(p[i]<mins[i])mins[i]=p[i]; if(p[i]>maxs[i])maxs[i]=p[i]; }
  cx=(mins[0]+maxs[0])/2; cy=(mins[1]+maxs[1])/2; cz=(mins[2]+maxs[2])/2;
  span=Math.max(maxs[0]-mins[0],maxs[1]-mins[1],maxs[2]-mins[2],1e-6);
}
function proj(p, W, H) {
  const x=p[0]-cx, y=p[1]-cy, z=p[2]-cz;
  const cy_=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch),
        sp=Math.sin(pitch);
  const x1=cy_*x+sy*z, z1=-sy*x+cy_*z;
  const y2=cp*y-sp*z1, z2=sp*y+cp*z1;
  const s=zoom*Math.min(W,H)*0.8/span;
  return [W/2+x1*s, H/2+y2*s, z2];
}
function draw3d() {
  const W=c3.width=c3.clientWidth*devicePixelRatio,
        H=c3.height=c3.clientHeight*devicePixelRatio;
  g3.clearRect(0,0,W,H);
  g3.fillStyle=css('--lm');
  for (const p of D.lm){ const q=proj(p,W,H);
    g3.fillRect(q[0]-1,q[1]-1,2,2); }
  function line(pts, color, w){
    if(pts.length<2)return;
    g3.strokeStyle=color; g3.lineWidth=w*devicePixelRatio;
    g3.beginPath();
    let q=proj(pts[0],W,H); g3.moveTo(q[0],q[1]);
    for(let i=1;i<pts.length;i++){q=proj(pts[i],W,H);g3.lineTo(q[0],q[1]);}
    g3.stroke();
  }
  line(D.gt, css('--series-2'), 2);
  line(D.traj, css('--series-1'), 2);
  g3.fillStyle=css('--series-3');
  for (const p of D.kf){ const q=proj(p,W,H);
    g3.beginPath(); g3.arc(q[0],q[1],3*devicePixelRatio,0,7); g3.fill(); }
  g3.strokeStyle=css('--loop'); g3.lineWidth=2*devicePixelRatio;
  for (const [a,b] of D.loops){ const qa=proj(a,W,H), qb=proj(b,W,H);
    g3.beginPath(); g3.moveTo(qa[0],qa[1]); g3.lineTo(qb[0],qb[1]);
    g3.stroke(); }
  if (cursor>=0 && cursor<D.traj.length){
    const q=proj(D.traj[cursor],W,H);
    g3.strokeStyle=css('--text-primary'); g3.lineWidth=2*devicePixelRatio;
    g3.beginPath(); g3.arc(q[0],q[1],6*devicePixelRatio,0,7); g3.stroke();
  }
}
let drag=null;
c3.addEventListener('mousedown',e=>{drag=[e.clientX,e.clientY];});
window.addEventListener('mouseup',()=>drag=null);
window.addEventListener('mousemove',e=>{
  if(!drag)return;
  yaw+=(e.clientX-drag[0])*0.008; pitch+=(e.clientY-drag[1])*0.008;
  pitch=Math.max(-1.55,Math.min(1.55,pitch));
  drag=[e.clientX,e.clientY]; draw3d();
});
c3.addEventListener('wheel',e=>{e.preventDefault();
  zoom*=Math.exp(-e.deltaY*0.001); draw3d();},{passive:false});

// ---------- timeline: inliers per frame + keyframe ticks ----------
const ct = document.getElementById('timeline'), gt2 = ct.getContext('2d');
const tip = document.getElementById('tip');
const PADL=46, PADB=18, PADT=10;
function drawTimeline(hoverX) {
  const W=ct.width=ct.clientWidth*devicePixelRatio,
        H=ct.height=ct.clientHeight*devicePixelRatio, dp=devicePixelRatio;
  gt2.clearRect(0,0,W,H);
  const inl=D.inl; if(!inl.length){
    gt2.fillStyle=css('--text-secondary');
    gt2.font=`${12*dp}px system-ui`;
    gt2.fillText('no per-frame stats', 10*dp, 20*dp); return null; }
  const n=inl.length, maxv=Math.max(...inl,1);
  const x=i=>PADL*dp+(W-(PADL+8)*dp)*i/Math.max(n-1,1);
  const y=v=>H-PADB*dp-(H-(PADT+PADB)*dp)*v/maxv;
  gt2.strokeStyle=css('--grid'); gt2.lineWidth=dp;
  gt2.font=`${10*dp}px system-ui`;
  gt2.fillStyle=css('--text-secondary');
  for (const v of [0, Math.round(maxv/2), maxv]) {
    gt2.beginPath(); gt2.moveTo(PADL*dp,y(v)); gt2.lineTo(W-8*dp,y(v));
    gt2.stroke(); gt2.fillText(String(v), 8*dp, y(v)+3*dp);
  }
  gt2.fillText('inliers / frame', PADL*dp, H-4*dp);
  // keyframe event ticks
  gt2.fillStyle=css('--series-3');
  for(let i=0;i<n;i++) if(D.iskf[i])
    gt2.fillRect(x(i)-dp, H-PADB*dp, 2*dp, 6*dp);
  // inlier line
  gt2.strokeStyle=css('--series-1'); gt2.lineWidth=2*dp;
  gt2.beginPath(); gt2.moveTo(x(0),y(inl[0]));
  for(let i=1;i<n;i++) gt2.lineTo(x(i),y(inl[i]));
  gt2.stroke();
  if (hoverX!=null) {
    const i=Math.round((hoverX*dp-PADL*dp)/((W-(PADL+8)*dp)/Math.max(n-1,1)));
    if(i>=0&&i<n){
      gt2.strokeStyle=css('--text-secondary'); gt2.lineWidth=dp;
      gt2.beginPath(); gt2.moveTo(x(i),PADT*dp); gt2.lineTo(x(i),H-PADB*dp);
      gt2.stroke();
      return i;
    }
  }
  return null;
}
ct.addEventListener('mousemove',e=>{
  const r=ct.getBoundingClientRect();
  const i=drawTimeline(e.clientX-r.left);
  if(i!=null){
    cursor=i; draw3d();
    tip.style.display='block';
    tip.style.left=(e.clientX+12)+'px'; tip.style.top=(e.clientY-30)+'px';
    tip.textContent=`frame ${i} — ${D.inl[i]} inliers`+
      (D.iskf[i]?' — keyframe':'');
  }
});
ct.addEventListener('mouseleave',()=>{
  tip.style.display='none'; cursor=-1; drawTimeline(null); draw3d();});
window.addEventListener('resize',()=>{draw3d();drawTimeline(null);});
draw3d(); drawTimeline(null);
</script></div></body></html>
"""
