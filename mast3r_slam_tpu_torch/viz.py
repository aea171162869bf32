"""Renders of the reconstruction: offline PNGs, a self-contained HTML viewer,
and the scene the live viewer serves.

Counterpart of ``mast3r_slam_tpu/viz.py``: ``plot_trajectory`` (:28),
``render_pointcloud`` (:55), ``keyframe_mosaic`` (:101) with matplotlib
(imported at first use, ``Agg``), ``build_scene`` (:124),
``export_html_viewer`` (:189), ``live_html`` (:224) and the page's
templates (kept here byte for byte).

The scene is selected on the device. The JAX package reads every
keyframe's whole pointmap back at each build (2.36 MB a keyframe at
384x512); here one batched ``sim3.act`` gives the world points, the
confidence mask and the per-keyframe even stride (``p[::step][:per_kf]``
of the JAX code, as ranks) pick the points, a scatter packs them without a
host wait, and one readback from pinned memory brings back only the kept
points, their flat indices and the poses. Colours come from the store's
host images at those indices. ``scene_snapshot`` copies the device inputs
into fresh tensors, so that a snapshot taken under the system's lock
stays valid while the store is written in place.
"""

from __future__ import annotations

import base64
import pathlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from .lie import sim3


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, plt, out_path, dpi):
    out_path = pathlib.Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)
    return out_path


def _edges(factor_graph):
    """The active edges' (ii, jj) as host arrays, or None."""
    if factor_graph is None or not factor_graph.n_edges:
        return None
    e = factor_graph.n_edges
    return (factor_graph.ii[:e].cpu().numpy(),
            factor_graph.jj[:e].cpu().numpy())


def plot_trajectory(keyframes, out_path, gt_file=None):
    """Top-down and side plots of the keyframe positions."""
    plt = _mpl()
    n = len(keyframes)
    t = keyframes.T_WC[:n, :3].cpu().numpy()
    fig, axes = plt.subplots(1, 2, figsize=(10, 5))
    for ax, (i, j), name in zip(axes, [(0, 2), (0, 1)], ["x-z", "x-y"]):
        ax.plot(t[:, i], t[:, j], "b.-", ms=3, lw=0.8, label="estimate")
        if gt_file is not None:
            from .eval.ate import load_tum_trajectory

            _, gt_t, _ = load_tum_trajectory(gt_file)
            ax.plot(gt_t[:, i], gt_t[:, j], "g-", lw=0.8, label="gt")
        ax.set_xlabel(name.split("-")[0])
        ax.set_ylabel(name.split("-")[1])
        ax.axis("equal")
        ax.legend()
    fig.suptitle(f"trajectory ({n} keyframes)")
    return _save(fig, plt, out_path, 120)


def render_pointcloud(keyframes, out_path, c_conf_threshold=1.5,
                      max_points=400_000, factor_graph=None):
    """Orthographic scatter of the confident world points, with the
    keyframe positions and the graph's edges. Every confident point is read
    back, then ``max_points`` are drawn at random on the host
    (``default_rng(0)``, as the JAX package draws them)."""
    plt = _mpl()
    n = len(keyframes)
    if n:
        T = keyframes.T_WC[:n]
        valid = keyframes.average_confs(n) > c_conf_threshold
        pts = sim3.act(T[:, None], keyframes.X[:n])[valid].cpu().numpy()
        cols = keyframes.uimg[:n].reshape(n, -1, 3)[valid.cpu().numpy()]
        T = T.cpu().numpy()
    else:
        pts, cols, T = np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 8))
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points,
                                              replace=False)
        pts, cols = pts[sel], cols[sel]
    edges = _edges(factor_graph)
    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    for ax, (i, j) in zip(axes, [(0, 2), (0, 1)]):
        if len(pts):
            ax.scatter(pts[:, i], pts[:, j], s=0.1, c=np.clip(cols, 0, 1),
                       linewidths=0)
        ax.plot(T[:, i], T[:, j], "r.-", ms=4, lw=1.0)
        if edges is not None:
            for a, b in zip(*edges):
                ax.plot([T[a, i], T[b, i]], [T[a, j], T[b, j]], "y-",
                        lw=0.4, alpha=0.5)
        ax.set_aspect("equal")
        ax.set_facecolor("black")
    return _save(fig, plt, out_path, 120)


def keyframe_mosaic(keyframes, out_path, max_tiles=16):
    """Grid of keyframe images."""
    plt = _mpl()
    n = min(len(keyframes), max_tiles)
    if n == 0:
        return None
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 2.2 * rows))
    axes = np.atleast_1d(axes).ravel()
    for i in range(n):
        axes[i].imshow(np.clip(keyframes.uimg[i], 0, 1))
        axes[i].set_title(f"kf {i}", fontsize=8)
    for ax in axes:
        ax.axis("off")
    return _save(fig, plt, out_path, 100)


# -- the scene: snapshot, selection on the device, one readback ---------------


class SceneSnapshot(NamedTuple):
    """What a scene is built from, owned by the snapshot: the device
    tensors are fresh copies (enqueued on the stream that writes the store,
    so later in-place writes cannot reach them) and ``colours`` are host
    arrays that no store write changes. Device memory: n x P x 16 bytes
    (world points and confidences) plus the poses and edges."""

    pW: torch.Tensor                 # (n, P, 3) world points
    conf: torch.Tensor               # (n, P) average confidences
    T_WC: torch.Tensor               # (n, 8)
    ii: Optional[torch.Tensor]       # (E,) edge endpoints, or None
    jj: Optional[torch.Tensor]
    colours: list                    # n arrays (P, 3): float [0, 1] or uint8


def _u8(c):
    """Colours in [0, 1] -> uint8, as the JAX package converts them."""
    return (np.clip(c, 0, 1) * 255).astype(np.uint8)


class ColourCache:
    """Per keyframe row, its image as uint8 colours (P, 3), made once per
    write of the row (``KeyframeStore.uimg_gen``); each entry is a new
    array, so a snapshot that holds one keeps it."""

    def __init__(self):
        self._rows = {}

    def rows(self, keyframes, n):
        out = []
        for i in range(n):
            gen = int(keyframes.uimg_gen[i])
            hit = self._rows.get(i)
            if hit is None or hit[0] != gen:
                hit = (gen, _u8(keyframes.uimg[i].reshape(-1, 3)))
                self._rows[i] = hit
            out.append(hit[1])
        return out


def scene_snapshot(keyframes, factor_graph=None, colours=None):
    """The scene's inputs as a ``SceneSnapshot``; no host wait. Without a
    ``ColourCache`` the colours are views of the store's images (for a
    build that reads them at once)."""
    n = len(keyframes)
    T = keyframes.T_WC[:n].clone()
    e = factor_graph.n_edges if factor_graph is not None else 0
    return SceneSnapshot(
        pW=sim3.act(T[:, None], keyframes.X[:n]),
        conf=keyframes.average_confs(n),
        T_WC=T,
        ii=factor_graph.ii[:e].clone() if e else None,
        jj=factor_graph.jj[:e].clone() if e else None,
        colours=(colours.rows(keyframes, n) if colours is not None else
                 [keyframes.uimg[i].reshape(-1, 3) for i in range(n)]))


# the frustum of a keyframe camera, its 8 segments, the lines' colours
_FRUSTUM = np.array([[0, 0, 0], [-.5, -.375, 1], [.5, -.375, 1],
                     [.5, .375, 1], [-.5, .375, 1]]) * 0.15
_SEG_A = [0, 0, 0, 0, 1, 2, 3, 4]
_SEG_B = [1, 2, 3, 4, 2, 3, 4, 1]
_GREEN, _RED, _YELLOW = (0.2, 0.9, 0.2), (0.9, 0.2, 0.2), (0.9, 0.9, 0.1)


def _readback(tensors):
    """One device-to-host transfer of ``tensors`` (through pinned memory on
    the GPU), ending in one wait. Returns numpy arrays and the bytes."""
    cuda = tensors[0].device.type == "cuda"
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=cuda)
    if cuda:
        torch.cuda.current_stream(tensors[0].device).synchronize()
    return ([h.numpy() for h in host],
            sum(t.numel() * t.element_size() for t in tensors))


def render_scene(snap: SceneSnapshot, c_conf_threshold=1.5,
                 max_points=600_000):
    """The scene of ``build_scene`` from a snapshot. Adds ``"readback_bytes"``
    to the dict: what came back from the device."""
    n = snap.T_WC.shape[0]
    dev = snap.T_WC.device
    P = snap.conf.shape[1] if n else 0
    per_kf = max(1, max_points // max(n, 1))
    S = n * min(per_kf, P)        # the most points the selection keeps
    if n * P >= 2 ** 31:
        raise ValueError(f"{n} keyframes of {P} points overflow int32")
    valid = snap.conf > c_conf_threshold
    rank = torch.cumsum(valid, dim=1) - 1
    count = valid.sum(dim=1, keepdim=True)
    step = torch.where(count > per_kf,
                       torch.div(count, per_kf, rounding_mode="floor"),
                       torch.ones_like(count))
    keep = (valid & (rank % step == 0)
            & (torch.div(rank, step, rounding_mode="floor") < per_kf))
    keep = keep.reshape(-1)
    # pack the kept points in order into S rows; the others go to row S
    slot = torch.cumsum(keep, dim=0) - 1
    dest = torch.where(keep, slot, torch.full_like(slot, S))
    pts = torch.empty((S + 1, 3), dtype=torch.float32, device=dev)
    pts.index_copy_(0, dest, snap.pW.reshape(-1, 3))
    idx = torch.empty(S + 1, dtype=torch.int32, device=dev)
    idx.index_copy_(0, dest, torch.arange(n * P, dtype=torch.int32,
                                          device=dev))
    kept = (slot[-1:] + 1) if n * P else torch.zeros(1, dtype=slot.dtype,
                                                     device=dev)
    parts = [kept, pts[:S], idx[:S], snap.T_WC]
    if snap.ii is not None:
        parts += [snap.ii, snap.jj]
    host, nbytes = _readback(parts)
    k = int(host[0][0])
    pts, idx, T = host[1][:k], host[2][:k], host[3]
    # the frustums' corners on the host (an upload would wait)
    corners = sim3.act(torch.from_numpy(T)[:, None], torch.as_tensor(
        _FRUSTUM, dtype=torch.float32)).numpy()             # (n, 5, 3)

    # colours of the kept points, row by row (idx is sorted)
    row = idx // max(P, 1)
    bounds = np.searchsorted(row, np.arange(n + 1))
    cols = [snap.colours[i][idx[bounds[i]:bounds[i + 1]] - i * P]
            for i in range(n)]
    cols = [c if c.dtype == np.uint8 else _u8(c) for c in cols]
    cols = np.concatenate(cols, 0) if n else np.zeros((0, 3), np.uint8)

    # line segments: frustums (green), trajectory (red), edges (yellow)
    seg = [np.stack([corners[:, _SEG_A], corners[:, _SEG_B]], 2)
           .reshape(-1, 3), np.stack([T[:-1, :3], T[1:, :3]], 1)
           .reshape(-1, 3)]
    lc = [np.tile(_GREEN, (n * 16, 1)), np.tile(_RED, (2 * max(n - 1, 0), 1))]
    if snap.ii is not None:
        ii, jj = host[4], host[5]
        seg.append(np.stack([T[ii, :3], T[jj, :3]], 1).reshape(-1, 3))
        lc.append(np.tile(_YELLOW, (2 * len(ii), 1)))
    lp = np.concatenate(seg, 0).astype(np.float32)
    lc = np.concatenate(lc, 0).astype(np.float32)
    center = (pts.mean(0) if len(pts) else np.zeros(3)).astype(np.float32)
    scale = float(np.percentile(np.linalg.norm(pts - center, axis=1), 90)
                  ) if len(pts) else 1.0
    return {"pts": pts, "cols": cols, "lpts": lp,
            "lcols": (lc * 255).astype(np.uint8), "center": center,
            "scale": max(scale, 1e-3), "readback_bytes": nbytes}


def build_scene(keyframes, c_conf_threshold=1.5, max_points=600_000,
                factor_graph=None):
    """The world-space render scene of the keyframe store (``viz.py:124``):
    ``pts`` (N, 3) f32 world points (per keyframe the confident points at
    an even stride, at most ``max_points // n`` each), ``cols`` (N, 3) u8,
    ``lpts`` (M, 3) f32 line-segment endpoints (frustums green, trajectory
    red, factor-graph edges yellow), ``lcols`` (M, 3) u8, ``center`` (3,)
    f32 and ``scale``; the same points in the same order as the JAX
    package's. Shared by the HTML export and the live server."""
    return render_scene(scene_snapshot(keyframes, factor_graph),
                        c_conf_threshold, max_points)


def export_html_viewer(keyframes, out_path, c_conf_threshold=1.5,
                       max_points=600_000, factor_graph=None):
    """Interactive WebGL viewer of the scene in one self-contained HTML file
    (orbit, pan, zoom, point size; no server, no external scripts)."""
    sc = build_scene(keyframes, c_conf_threshold, max_points, factor_graph)

    def b64(a):
        return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()

    c = sc["center"]
    init = _STATIC_INIT_JS.replace("__NPTS__", str(len(sc["pts"])))
    init = init.replace("__PTS__", b64(sc["pts"]))
    init = init.replace("__COLS__", b64(sc["cols"]))
    init = init.replace("__LPTS__", b64(sc["lpts"]))
    init = init.replace("__LCOLS__", b64(sc["lcols"]))
    init = init.replace("__CENTER__", f"[{c[0]},{c[1]},{c[2]}]")
    init = init.replace("__SCALE__", f"{sc['scale']}")
    html = _VIEWER_HTML.replace("__EXTRA_HUD__", "")
    html = html.replace("__INIT_JS__", init)

    out_path = pathlib.Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(html)
    return out_path


def live_html(token=""):
    """The live server's page: the same renderer, the scene polled from
    ``/scene``, a confidence slider and pause/step buttons POSTing to
    ``/ctrl`` with the per-run token."""
    html = _VIEWER_HTML.replace(
        "__EXTRA_HUD__",
        '&nbsp; conf <input id="confs" type="range" min="0" max="5"'
        ' value="1.5" step="0.1">'
        '&nbsp; <button id="pauseb">pause</button>'
        '<button id="stepb">step</button>')
    return html.replace("__INIT_JS__",
                        _LIVE_INIT_JS.replace("__TOKEN__", token))


_VIEWER_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>mast3r_slam_tpu reconstruction</title>
<style>body{margin:0;background:#000;color:#ccc;font:12px monospace;overflow:hidden}
#hud{position:fixed;top:8px;left:8px;z-index:2;background:#000a;padding:6px}
canvas{display:block}</style></head><body>
<div id="hud"><span id="stat"></span> &nbsp; drag=orbit, shift-drag=pan, wheel=zoom
&nbsp; size <input id="psz" type="range" min="1" max="6" value="2" step="0.5">__EXTRA_HUD__</div>
<canvas id="c"></canvas>
<script>
"use strict";
function dec(b64){const s=atob(b64);const a=new Uint8Array(s.length);
for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return a;}
let NP=0, NL=0, center=[0,0,0], scale=1;
const cv=document.getElementById("c");
const gl=cv.getContext("webgl");
const vs=`attribute vec3 p;attribute vec3 col;uniform mat4 mvp;
uniform float psz;varying vec3 vc;
void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=psz;vc=col;}`;
const fs=`precision mediump float;varying vec3 vc;
void main(){gl_FragColor=vec4(vc,1.0);}`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
gl.compileShader(o);return o;}
const pr=gl.createProgram();
gl.attachShader(pr,sh(gl.VERTEX_SHADER,vs));
gl.attachShader(pr,sh(gl.FRAGMENT_SHADER,fs));
gl.linkProgram(pr);gl.useProgram(pr);
const aP=gl.getAttribLocation(pr,"p"),aC=gl.getAttribLocation(pr,"col");
const uM=gl.getUniformLocation(pr,"mvp"),uS=gl.getUniformLocation(pr,"psz");
const bP=gl.createBuffer(),bC=gl.createBuffer(),
      bLP=gl.createBuffer(),bLC=gl.createBuffer();
let az=0.5,el=0.4,dist=3,tgt=[0,0,0];
function up(b,data){gl.bindBuffer(gl.ARRAY_BUFFER,b);
gl.bufferData(gl.ARRAY_BUFFER,data,gl.DYNAMIC_DRAW);}
function setScene(pts,cols,lpts,lcols,c,s,recenter){
NP=pts.length/3;NL=lpts.length/3;
up(bP,pts);up(bC,cols);up(bLP,lpts);up(bLC,lcols);
if(recenter){center=c;scale=s;dist=scale*3;tgt=center.slice();}}
function mat(){const w=cv.width,h=cv.height,f=1.5;const a=w/h;
const ca=Math.cos(az),sa=Math.sin(az),ce=Math.cos(el),se=Math.sin(el);
const eye=[tgt[0]+dist*ce*sa,tgt[1]+dist*se,tgt[2]+dist*ce*ca];
const zx=eye[0]-tgt[0],zy=eye[1]-tgt[1],zz=eye[2]-tgt[2];
const zl=Math.hypot(zx,zy,zz);const z=[zx/zl,zy/zl,zz/zl];
const x=[z[2],0,-z[0]];const xl=Math.hypot(...x);x[0]/=xl;x[1]/=xl;x[2]/=xl;
const y=[z[1]*x[2]-z[2]*x[1],z[2]*x[0]-z[0]*x[2],z[0]*x[1]-z[1]*x[0]];
const n=0.01*scale,fa=100*scale;
const view=[x[0],y[0],z[0],0,x[1],y[1],z[1],0,x[2],y[2],z[2],0,
-(x[0]*eye[0]+x[1]*eye[1]+x[2]*eye[2]),
-(y[0]*eye[0]+y[1]*eye[1]+y[2]*eye[2]),
-(z[0]*eye[0]+z[1]*eye[1]+z[2]*eye[2]),1];
const proj=[f/a,0,0,0, 0,f,0,0, 0,0,(fa+n)/(n-fa),-1, 0,0,2*fa*n/(n-fa),0];
const m=new Float32Array(16);
for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
for(let k=0;k<4;k++)s+=view[i*4+k]*proj[k*4+j];m[i*4+j]=s;}
return m;}
function draw(){cv.width=innerWidth;cv.height=innerHeight;
gl.viewport(0,0,cv.width,cv.height);
gl.clearColor(0,0,0,1);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
gl.enable(gl.DEPTH_TEST);
gl.uniformMatrix4fv(uM,false,mat());
gl.uniform1f(uS,parseFloat(document.getElementById("psz").value));
gl.bindBuffer(gl.ARRAY_BUFFER,bP);
gl.enableVertexAttribArray(aP);gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
gl.bindBuffer(gl.ARRAY_BUFFER,bC);
gl.enableVertexAttribArray(aC);gl.vertexAttribPointer(aC,3,gl.UNSIGNED_BYTE,true,0,0);
gl.drawArrays(gl.POINTS,0,NP);
gl.bindBuffer(gl.ARRAY_BUFFER,bLP);gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
gl.bindBuffer(gl.ARRAY_BUFFER,bLC);gl.vertexAttribPointer(aC,3,gl.UNSIGNED_BYTE,true,0,0);
gl.drawArrays(gl.LINES,0,NL);
requestAnimationFrame(draw);}
let drag=false,pan=false,lx=0,ly=0;
cv.onmousedown=e=>{drag=true;pan=e.shiftKey;lx=e.clientX;ly=e.clientY;};
onmouseup=()=>drag=false;
onmousemove=e=>{if(!drag)return;const dx=e.clientX-lx,dy=e.clientY-ly;
lx=e.clientX;ly=e.clientY;
if(pan){const s=dist*0.002;tgt[0]-=dx*s*Math.cos(az);tgt[2]+=dx*s*Math.sin(az);
tgt[1]+=dy*s;}else{az-=dx*0.005;el=Math.max(-1.5,Math.min(1.5,el+dy*0.005));}};
onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);};
__INIT_JS__
draw();
</script></body></html>
"""

_STATIC_INIT_JS = """
setScene(new Float32Array(dec("__PTS__").buffer),dec("__COLS__"),
new Float32Array(dec("__LPTS__").buffer),dec("__LCOLS__"),
__CENTER__,__SCALE__,true);
document.getElementById("stat").textContent="points: __NPTS__";
"""

# live mode: poll /scene (binary layout packed by viz_server.pack_scene),
# re-upload buffers, recenter only on the first scene; pause/step -> /ctrl
_LIVE_INIT_JS = """
let first=true;
async function poll(){
try{
const r=await fetch("/scene",{cache:"no-store"});
const b=await r.arrayBuffer();
const h=new Uint32Array(b,0,8);
const hf=new Float32Array(b,32,4);
const npts=h[2],nlines=h[3],nkf=h[4],frame=h[5],paused=h[6];
let off=48;
const pts=new Float32Array(b,off,npts*3);off+=npts*12;
const cols=new Uint8Array(b,off,npts*3);off+=npts*3;
off=(off+3)&~3;
const lpts=new Float32Array(b,off,nlines*3);off+=nlines*12;
const lcols=new Uint8Array(b,off,nlines*3);
setScene(pts,cols,lpts,lcols,[hf[0],hf[1],hf[2]],hf[3],first&&npts>0);
if(npts>0)first=false;   // keep recentering armed until a real scene lands
document.getElementById("stat").textContent=
"kf "+nkf+" frame "+frame+" pts "+npts;
document.getElementById("pauseb").textContent=paused?"resume":"pause";
}catch(e){}
setTimeout(poll,1500);}
poll();
const ctrl=q=>fetch("/ctrl?"+q+"&t=__TOKEN__",{method:"POST"});
document.getElementById("pauseb").onclick=()=>ctrl("toggle=1");
document.getElementById("stepb").onclick=()=>ctrl("step=1");
document.getElementById("confs").onchange=e=>ctrl("conf="+e.target.value);
"""
