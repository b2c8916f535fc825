"""Interactive web editor: the engine-honest slice of the reference editor
(port of nodey_tpu.app.server).

``python -m nodey_tpu_torch serve project.json`` serves one HTML page that
renders the node graph (nodes/pins/links at their saved editor positions —
the imnodes canvas, reference: src/frontend/app.cpp:1606-1697), live run
state and queue occupancy (the diagnostics overlay, app.cpp:1493-1600, with
the per-link fill gauge of app.cpp:1574-1595 mapped to the streaming
executor's queues), and the spectrum of the live preview. A "preview"
button drives a real ``StreamingSession`` through the chunk-flow executor;
an export runs ``Runner.export_streamed``. Both run on the viewer's device
(``cuda`` unless the caller asks for the CPU; a CUDA device without a card
raises when the viewer is made, so ``serve`` fails at start-up), each in a
job thread bound to that device and a CUDA stream of its own.

Editing mirrors the reference app's mutations end to end: add node from the
registry with singleton disable (app.cpp:1700-1717), drag to move, link
creation with validate-and-rollback (app.cpp:1819-1839), unlink/remove via
the node panel, parameter edits, undo/redo snapshots (app.cpp:919-1041) and
project save — all through JSON endpoints backed by the same SessionService
the CLI uses.

The page ``_PAGE`` is nodey_tpu/app/server.py:38-798 (its title names the
port), ``_AudioListener`` :799, ``_wav_stream_header`` :833, ``ViewerState``
:846-1438, ``make_handler`` :1440-1731 and ``serve`` :1733; the routes, the
token check and the cross-origin guard are the JAX package's. Stdlib HTTP
(http.server + embedded HTML/JS); the engine API stays UI-independent.
"""

from __future__ import annotations

import contextlib
import hmac
import json
import os
import queue as _queue
import secrets
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from nodey_tpu_torch import config as cfg
from nodey_tpu_torch.app.notifications import NotificationCenter
from nodey_tpu_torch.app.session import SessionService, apply_params
from nodey_tpu_torch.core import registry
from nodey_tpu_torch.core.compiler import resolve_device
from nodey_tpu_torch.core.errors import (InvalidFileError, NodeyError,
                                         RunCancelled)
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.core.runner import Runner
from nodey_tpu_torch.core.streaming import StreamingSession

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>nodey_tpu_torch — %TITLE%</title>
<style>
 body { background:#181a1f; color:#d6d8de; font:13px system-ui, sans-serif;
        margin:0; display:flex; height:100vh; }
 #canvas { flex:1; overflow:auto; }
 #side { width:340px; border-left:1px solid #2c2f36; padding:12px;
         overflow-y:auto; }
 .node { fill:#23262d; stroke:#3a3f4a; rx:8; cursor:move; }
 .node.sel { stroke:#9ecbff; stroke-width:2; }
 .title { fill:#9ecbff; font-weight:600; pointer-events:none; }
 .pin-in { fill:#7fd962; cursor:crosshair; }
 .pin-out { fill:#e8a04c; cursor:crosshair; }
 .pin-armed { stroke:#fff; stroke-width:2; }
 .link { stroke:#5a8fd9; stroke-width:2; fill:none; opacity:.85;
         cursor:pointer; }
 .link:hover { stroke:#e06c75; }
 .label { fill:#aab; font-size:11px; pointer-events:none; }
 button { background:#2d6cdf; border:0; color:#fff; padding:6px 10px;
          border-radius:6px; cursor:pointer; margin:1px; }
 button:disabled { background:#444; }
 select, textarea { background:#23262d; color:#d6d8de; border:1px solid
          #3a3f4a; border-radius:6px; width:100%; }
 textarea { height:84px; font:11px monospace; }
 .prow { display:flex; align-items:center; gap:6px; margin:3px 0;
         font-size:11px; }
 .prow label { flex:0 0 92px; color:#aab; }
 .prow input[type=range] { flex:1; accent-color:#2d6cdf; }
 .prow input[type=number] { width:80px; background:#23262d; color:#d6d8de;
         border:1px solid #3a3f4a; border-radius:6px; }
 .prow .pval { flex:0 0 52px; text-align:right; color:#d6d8de; }
 .prow .fname { flex:1; overflow:hidden; text-overflow:ellipsis;
         white-space:nowrap; color:#d6d8de; }
 .prow button { padding:2px 6px; font-size:10px; }
 #rawparams summary { cursor:pointer; color:#8a8f99; font-size:11px;
         margin:6px 0 2px; }
 .gauge { height:10px; background:#2c2f36; border-radius:5px; margin:4px 0; }
 .gauge>i { display:block; height:100%; border-radius:5px;
            background:#7fd962; }
 #spec { width:100%; image-rendering:pixelated; background:#000;
         border-radius:6px; }
 h3 { margin:14px 0 4px; font-size:12px; text-transform:uppercase;
      color:#8a8f99; }
 pre { white-space:pre-wrap; font-size:11px; color:#9aa0ab; }
 #err { color:#e06c75; font-size:11px; min-height:14px; }
 #helpwin { display:none; position:fixed; inset:6% 12%; background:#1e2128;
   border:1px solid #3a3f4a; border-radius:10px; padding:18px;
   overflow-y:auto; z-index:10; box-shadow:0 8px 40px #000a; }
 #helpwin h4 { color:#9ecbff; margin:14px 0 4px; }
 #helpwin code { background:#2c2f36; border-radius:4px; padding:0 4px; }
 .stage { font-size:11px; color:#8a8f99; }
 #ctxmenu { display:none; position:fixed; background:#23262d; border:1px
   solid #3a3f4a; border-radius:8px; padding:4px; z-index:20;
   box-shadow:0 4px 20px #000a; max-height:60vh; overflow-y:auto; }
 #ctxmenu div { padding:5px 14px; border-radius:5px; cursor:pointer;
   font-size:12px; }
 #ctxmenu div:hover { background:#2d6cdf; }
 #ctxmenu div.dis { color:#555; cursor:default; }
 #ctxmenu div.dis:hover { background:none; }
 #fswin { display:none; position:fixed; inset:12% 24%; background:#1e2128;
   border:1px solid #3a3f4b; border-radius:8px; padding:14px; z-index:60;
   display:none; flex-direction:column; }
 #fspath { color:#9ecbff; font-size:12px; margin:4px 0; word-break:break-all; }
 #fslist { flex:1; overflow:auto; border:1px solid #2c2f36; border-radius:4px;
   margin:6px 0; min-height:180px; max-height:50vh; }
 #fslist div { padding:3px 8px; cursor:pointer; font-size:13px; }
 #fslist div:hover { background:#2c3340; }
 #fslist .dir { color:#9ecbff; }
 #fsbar input { width:55%; }
 #setwin { display:none; position:fixed; inset:20% 30%; background:#1e2128;
   border:1px solid #3a3f4a; border-radius:10px; padding:18px; z-index:10;
   box-shadow:0 8px 40px #000a; }
</style></head><body>
<div id="helpwin"><button id="helpclose" style="float:right">close</button>
<div id="helpbody">loading…</div></div>
<div id="ctxmenu"></div>
<div id="setwin"><h3>Settings</h3>
 <textarea id="settext" style="height:160px"></textarea>
 <div style="margin-top:6px"><button id="setapply">apply</button>
 <button id="setclose">cancel</button></div></div>
<div id="canvas"><svg id="svg" width="2400" height="1600">
<defs><pattern id="grid" width="20" height="20" patternUnits="userSpaceOnUse">
<path d="M 20 0 L 0 0 0 20" fill="none" stroke="#22252c" stroke-width="1"/>
</pattern></defs>
<rect id="gridbg" width="100%" height="100%" fill="url(#grid)"
 pointer-events="none"/>
<g id="content"></g>
</svg>
<svg id="minimap" width="180" height="120" style="position:fixed;
 left:12px; bottom:12px; background:#14161b; border:1px solid #2c2f36;
 border-radius:6px"></svg></div>
<div id="side">
 <h3>Project</h3><div id="proj"></div>
 <div><button id="save">save</button><button id="open">open</button>
 <button id="new">new</button>
 <button id="undo">undo</button><button id="redo">redo</button>
 <button id="help">help</button><button id="settings">settings</button></div>
 <div id="err"></div>
 <h3>Add node</h3>
 <select id="addsel"></select> <button id="addbtn">+ add</button>
 <h3>Preview / Export</h3>
 <button id="run">▶ preview</button> <button id="stop">■ stop</button>
 <div style="margin-top:4px">
  <input id="exppath" value="export.mp3" style="width:140px;background:#23262d;
   color:#d6d8de;border:1px solid #3a3f4a;border-radius:6px">
  <select id="expkbps" style="width:70px">
   <option>64</option><option>96</option><option>128</option>
   <option>160</option><option>192</option><option>256</option>
   <option selected>320</option></select>
  <button id="export">⬇ export</button>
 </div>
 <audio id="aud" style="width:100%;margin-top:4px" controls></audio>
 <div>state: <b id="state">idle</b></div>
 <div>egress queue <div class="gauge"><i id="fill" style="width:0"></i></div></div>
 <div id="stages"></div>
 <div id="metrics"></div>
 <h3>Spectrum tap</h3>
 <canvas id="spec" width="512" height="128"></canvas>
 <h3>Events</h3><pre id="notif"></pre>
 <h3>Node</h3><pre id="info">click a node…</pre>
 <div id="editbox" style="display:none">
  <div id="widgets"></div>
  <details id="rawparams"><summary>raw JSON</summary>
   <textarea id="params"></textarea>
   <button id="apply">apply params</button>
  </details>
  <button id="del">remove node</button>
 </div>
</div>
<div id="fswin">
 <h3 id="fstitle">Select file</h3>
 <div id="fspath"></div>
 <div id="fslist"></div>
 <div id="fsbar">
  <input id="fsname" type="text" placeholder="file name">
  <button id="fsok">select</button>
  <button id="fscancel">cancel</button>
 </div>
</div>
<script>
const svg = document.getElementById('svg');
const content = document.getElementById('content');
const err = (m) => document.getElementById('err').textContent = m || '';
// UI settings drive the canvas (reference: App_settings.ui — grid,
// snap-to-grid, minimap, side panel width; settings.hpp:9-33).
let ui = {show_grid: true, grid_size: 20, snap_to_grid: false,
          show_minimap: true, side_panel_width: 300};
async function loadSettings() {
  try {
    const s = await api('/api/settings');
    if (s.ui) ui = Object.assign(ui, s.ui);
  } catch (e) {}
  if (!(ui.grid_size >= 2)) ui.grid_size = 20;  // guard NaN/0 divisors
  document.getElementById('gridbg').style.display =
    ui.show_grid ? '' : 'none';
  const p = document.getElementById('grid');
  p.setAttribute('width', ui.grid_size); p.setAttribute('height', ui.grid_size);
  p.firstElementChild.setAttribute(
    'd', `M ${ui.grid_size} 0 L 0 0 0 ${ui.grid_size}`);
  document.getElementById('minimap').style.display =
    ui.show_minimap ? '' : 'none';
  document.getElementById('side').style.width = ui.side_panel_width + 'px';
}
function renderMinimap() {
  const mm = document.getElementById('minimap');
  mm.textContent = '';
  if (!graph || !ui.show_minimap) return;
  const sx = 180 / 2400, sy = 120 / 1600;
  for (const n of graph.nodes) {
    const r = el('rect', {x: n.x * sx, y: n.y * sy,
      width: Math.max(3, 190 * sx), height: Math.max(2, 40 * sy),
      fill: selected.has(n.id) ? '#9ecbff' : '#4a5160', rx: 1});
    mm.appendChild(r);
  }
}
function el(n, attrs, text) {
  const e = document.createElementNS('http://www.w3.org/2000/svg', n);
  for (const k in attrs) e.setAttribute(k, attrs[k]);
  if (text) e.textContent = text;
  return e;
}
const TOKEN = %TOKEN%;  // per-session auth, injected by the server
async function api(path, body) {
  const r = await fetch(path, body === undefined ?
    {headers:{'X-Nodey-Token': TOKEN}} :
    {method:'POST', headers:{'Content-Type':'application/json',
                             'X-Nodey-Token': TOKEN},
     body: JSON.stringify(body)});
  const j = await r.json();
  if (j && j.error) { err(j.error); throw new Error(j.error); }
  err('');
  return j;
}
function refresh() { loadGraph(); loadRegistry(); }
// Multi-node selection (the reference editor's selected-set semantics:
// shift-click extends, Ctrl+A selects all — app.cpp:1841-1901).
let graph = null, selected = new Set(), primary = null, armedPin = null;
async function loadGraph() {
  graph = await api('/api/graph');
  document.getElementById('proj').textContent =
    graph.title + ' — ' + graph.nodes.length + ' nodes, ' +
    graph.links.length + ' links' + (graph.modified ? '  (unsaved)' : '');
  content.textContent = '';
  const pinPos = {};
  for (const n of graph.nodes) {
    const h = 34 + 18 * n.pins.length;
    const g = el('g', {transform:`translate(${n.x},${n.y})`});
    const r = el('rect', {class:'node' + (selected.has(n.id) ? ' sel' : ''),
                          'data-node': n.id, width:190, height:h, rx:8});
    r.addEventListener('mousedown', (ev) => startDrag(ev, n, g));
    r.addEventListener('click', (ev) => selectNode(n, ev));
    r.addEventListener('contextmenu', (ev) => nodeMenu(ev, n));
    g.appendChild(r);
    g.appendChild(el('text', {class:'title', x:10, y:20}, n.display_name));
    n.pins.forEach((p, i) => {
      const y = 40 + 18 * i, x = p.is_input ? 0 : 190;
      const c = el('circle',
        {class: (p.is_input ? 'pin-in' : 'pin-out') +
                (armedPin === p.id ? ' pin-armed' : ''),
         cx:x, cy:y, r:6});
      c.addEventListener('click', (ev) => { ev.stopPropagation();
                                            pinClick(p); });
      g.appendChild(c);
      g.appendChild(el('text',
        {class:'label', x: p.is_input ? 10 : 130, y: y + 4},
        p.display_name));
      pinPos[p.id] = [n.x + x, n.y + y];
    });
    content.appendChild(g);
  }
  const pinNode = {};
  for (const n of graph.nodes) for (const p of n.pins) pinNode[p.id] = n.id;
  for (const l of graph.links) {
    const a = pinPos[l.from], b = pinPos[l.to];
    if (!a || !b) continue;
    const mx = (a[0] + b[0]) / 2;
    const path = el('path', {class:'link',
      'data-tonode': pinNode[l.to],
      d:`M${a[0]},${a[1]} C${mx},${a[1]} ${mx},${b[1]} ${b[0]},${b[1]}`});
    path.addEventListener('click', async () => {
      await api('/api/edit/unlink', {from_pin: l.from, to_pin: l.to});
      loadGraph();
    });
    content.insertBefore(path, content.firstChild);
  }
  renderMinimap();
}
// Parameter panel: renders each node's param_spec() (the web counterpart
// of the reference's per-node ImGui draw_content widgets — sliders,
// checkboxes, per-slot file rows). Edits POST through /api/edit/set, so
// clamping and coupled behaviors (amix's unlocked-volume renormalization,
// audio-amix.cpp:349-393) run server-side; the panel then re-renders from
// server truth.
async function applyParam(key, value) {
  try { await api('/api/edit/set', {node_id: primary, params: {[key]: value}}); }
  catch (e) { err(String(e.message || e)); }
  await refreshPanel();
}
async function refreshPanel() {
  await loadGraph();
  if (primary === null) return;
  const n = graph.nodes.find(x => x.id === primary);
  if (!n) return;
  document.getElementById('params').value =
    JSON.stringify(n.params === undefined ? {} : n.params, null, 1);
  renderWidgets(n);
}
function renderWidgets(n) {
  const box = document.getElementById('widgets');
  box.textContent = '';
  if (!n.spec) return;
  // Logarithmic drags (reference velocity slider) map the range input's
  // [0,1000] ticks onto min*(max/min)^(t/1000).
  const fromTicks = (f, t) => f.log
    ? f.min * Math.pow(f.max / f.min, t / 1000) : Number(t);
  const toTicks = (f, v) => f.log
    ? Math.round(1000 * Math.log(v / f.min) / Math.log(f.max / f.min)) : v;
  const cur = Object.fromEntries(n.spec.map(s => [s.key, s.value]));
  for (const f of n.spec) {
    if (f.show_if && cur[f.show_if.key] !== f.show_if.value) continue;
    const row = document.createElement('div');
    row.className = 'prow';
    const lab = document.createElement('label');
    lab.textContent = f.label;
    row.appendChild(lab);
    const send = (v) => applyParam(f.key, f.index === undefined ? v : [f.index, v]);
    if (f.kind === 'float' || f.kind === 'int') {
      const ranged = f.min !== undefined && f.max !== undefined;
      const inp = document.createElement('input');
      inp.type = ranged ? 'range' : 'number';
      if (ranged) {
        inp.min = f.log ? 0 : f.min;
        inp.max = f.log ? 1000 : f.max;
        inp.step = f.log ? 1 : (f.step !== undefined ? f.step : (f.kind === 'int' ? 1 : 'any'));
        inp.value = toTicks(f, f.value);
      } else {
        if (f.step !== undefined) inp.step = f.step;
        inp.value = f.value;
      }
      const shown = document.createElement('span');
      shown.className = 'pval';
      const fmt = (v) => f.kind === 'int'
        ? String(Math.round(v)) : Number(v).toFixed(3);
      shown.textContent = fmt(f.value);
      inp.oninput = () => { shown.textContent = fmt(fromTicks(f, inp.value)); };
      inp.onchange = () => {
        const v = fromTicks(f, inp.value);
        send(f.kind === 'int' ? Math.round(v) : v);
      };
      row.appendChild(inp); row.appendChild(shown);
    } else if (f.kind === 'bool') {
      const inp = document.createElement('input');
      inp.type = 'checkbox';
      inp.checked = !!f.value;
      inp.onchange = () => send(inp.checked);
      row.appendChild(inp);
    } else if (f.kind === 'enum') {
      const sel = document.createElement('select');
      for (const c of f.choices) {
        const o = document.createElement('option');
        o.textContent = String(c);
        if (c === f.value) o.selected = true;
        sel.appendChild(o);
      }
      // send the TYPED choice (target_rate is an int), not the DOM string
      sel.onchange = () => send(f.choices[sel.selectedIndex]);
      row.appendChild(sel);
    } else if (f.kind === 'files') {
      // Per-slot rows (reference: Slot i + Browse, audio-io.cpp:345-426)
      row.remove();
      const files = f.value.slice();
      files.forEach((p, i) => {
        const fr = document.createElement('div');
        fr.className = 'prow';
        const name = document.createElement('span');
        name.className = 'fname';
        name.title = p;
        name.textContent = (i + 1) + ': ' + (p ? p.split('/').pop() : '(none)');
        const br = document.createElement('button');
        br.textContent = 'browse…';
        br.onclick = async () => {
          const path = await pickPath('Select input file', '', '');
          if (!path) return;
          const next = files.slice(); next[i] = path;
          applyParam(f.key, next);
        };
        const rm = document.createElement('button');
        rm.textContent = '✕';
        rm.disabled = files.length <= 1;
        rm.onclick = () => {
          const next = files.slice(); next.splice(i, 1);
          applyParam(f.key, next);
        };
        fr.appendChild(name); fr.appendChild(br); fr.appendChild(rm);
        box.appendChild(fr);
      });
      const addRow = document.createElement('div');
      addRow.className = 'prow';
      const add = document.createElement('button');
      add.textContent = 'add input file…';
      add.onclick = async () => {
        const path = await pickPath('Add input file', '', '');
        if (path) applyParam(f.key, files.concat([path]));
      };
      addRow.appendChild(add);
      box.appendChild(addRow);
      continue;
    }
    box.appendChild(row);
  }
}
function selectNode(n, ev) {
  if (ev && ev.shiftKey) {
    if (selected.has(n.id)) selected.delete(n.id); else selected.add(n.id);
  } else {
    selected = new Set([n.id]);
  }
  primary = selected.has(n.id) ? n.id : null;
  const box = document.getElementById('editbox');
  if (primary !== null) {
    document.getElementById('info').textContent =
      n.identifier + ' (#' + n.id + ')' +
      (selected.size > 1 ? '  [+' + (selected.size - 1) + ' selected]' : '') +
      '\\n\\n' + n.description;
    box.style.display = 'block';
    document.getElementById('params').value =
      JSON.stringify(n.params === undefined ? {} : n.params, null, 1);
    renderWidgets(n);
  } else {
    box.style.display = 'none';
    document.getElementById('info').textContent = 'click a node…';
  }
  loadGraph();
}
async function removeSelected() {
  // One request, one undo snapshot — a multi-node delete reverts with a
  // single Ctrl+Z, like the reference's delete-selected.
  try { await api('/api/edit/remove-nodes', {node_ids: [...selected]}); }
  finally {
    selected = new Set(); primary = null;
    document.getElementById('editbox').style.display = 'none';
    refresh();
  }
}
function startDrag(ev, n, g) {
  ev.preventDefault();
  const sx = ev.clientX - n.x, sy = ev.clientY - n.y;
  const snap = (v) => ui.snap_to_grid
    ? Math.round(v / ui.grid_size) * ui.grid_size : v;
  const move = (e) => {
    n.x = snap(e.clientX - sx); n.y = snap(e.clientY - sy);
    g.setAttribute('transform', `translate(${n.x},${n.y})`);
  };
  const up = async () => {
    window.removeEventListener('mousemove', move);
    window.removeEventListener('mouseup', up);
    await api('/api/edit/move', {node_id: n.id, x: n.x, y: n.y});
    loadGraph();
  };
  window.addEventListener('mousemove', move);
  window.addEventListener('mouseup', up);
}
async function pinClick(p) {
  // Reference link flow: pick an output pin, then an input pin; the
  // server validates and rolls back on failure (app.cpp:1819-1839).
  if (armedPin === null) { armedPin = p.id; loadGraph(); return; }
  if (armedPin === p.id) { armedPin = null; loadGraph(); return; }
  const from = p.is_input ? armedPin : p.id;
  const to = p.is_input ? p.id : armedPin;
  armedPin = null;
  try { await api('/api/edit/link', {from_pin: from, to_pin: to}); }
  finally { loadGraph(); }
}
async function loadRegistry() {
  const reg = await api('/api/registry');
  const sel = document.getElementById('addsel');
  sel.textContent = '';
  for (const r of reg) {
    const o = document.createElement('option');
    o.value = r.identifier;
    o.textContent = r.display_name + (r.disabled ? ' (singleton)' : '');
    o.disabled = r.disabled;
    sel.appendChild(o);
  }
}
document.getElementById('addbtn').onclick = async () => {
  const identifier = document.getElementById('addsel').value;
  await api('/api/edit/add-node', {identifier, x: 80, y: 80});
  refresh();
};
document.getElementById('apply').onclick = async () => {
  let params;
  try { params = JSON.parse(document.getElementById('params').value); }
  catch (e) { err('bad JSON: ' + e.message); return; }
  await api('/api/edit/set', {node_id: primary, params});
  refreshPanel();
};
document.getElementById('del').onclick = removeSelected;
document.getElementById('undo').onclick =
  async () => { await api('/api/undo', {}); refresh(); };
document.getElementById('redo').onclick =
  async () => { await api('/api/redo', {}); refresh(); };
// In-editor file browser: the web redesign of the reference's native
// pfd open/save dialogs (dialog-utility.cpp:15-92). Server-backed
// directory listing via GET /api/fs; save mode types a file name.
let fsResolve = null, fsDir = '';
async function fsLoad(path) {
  const r = await fetch('/api/fs?path=' + encodeURIComponent(path || ''),
                        {headers:{'X-Nodey-Token': TOKEN}});
  const d = await r.json();
  if (!r.ok) { err(d.error || 'fs error'); return; }
  fsDir = d.path;
  document.getElementById('fspath').textContent = d.path;
  const list = document.getElementById('fslist');
  list.textContent = '';
  if (d.parent) {
    const up = document.createElement('div');
    up.textContent = '⮍ ..'; up.className = 'dir';
    up.onclick = () => fsLoad(d.parent);
    list.appendChild(up);
  }
  for (const e of d.entries) {
    const row = document.createElement('div');
    row.textContent = (e.dir ? '▸ ' : '') + e.name;
    if (e.dir) { row.className = 'dir'; row.onclick = () => fsLoad(d.path + d.sep + e.name); }
    else row.onclick = () => {
      document.getElementById('fsname').value = e.name;
    };
    list.appendChild(row);
  }
}
function pickPath(title, start, saveName) {
  return new Promise((resolve) => {
    fsResolve = resolve;
    document.getElementById('fstitle').textContent = title;
    document.getElementById('fsname').value = saveName || '';
    document.getElementById('fswin').style.display = 'flex';
    fsLoad(start || '');
  });
}
function fsClose(value) {
  document.getElementById('fswin').style.display = 'none';
  if (fsResolve) { fsResolve(value); fsResolve = null; }
}
document.getElementById('fsok').onclick = () => {
  const name = document.getElementById('fsname').value.trim();
  if (!name) { fsClose(null); return; }
  fsClose(fsDir.replace(/[\\/]+$/, '') + '/' + name);
};
document.getElementById('fscancel').onclick = () => fsClose(null);
async function saveProject() {
  // First save of an empty-canvas session needs a path (save-as); the
  // browser dialog stands in for the native save dialog
  // (dialog-utility.cpp:15-92).
  try { await api('/api/save', {}); }
  catch (e) {
    if (!String(e.message).includes('No project path')) return;
    const path = await pickPath('Save project as', '', 'project.json');
    if (!path) return;
    await api('/api/save', {path});
  }
  loadGraph();
}
document.getElementById('save').onclick = saveProject;
async function openProject() {
  // The open-project flow (reference: open_project + confirm dialog,
  // app.cpp:706-772) through the in-editor file browser.
  if (graph && graph.modified &&
      !confirm('Discard unsaved changes?')) return;
  const path = await pickPath('Open project', '', '');
  if (!path) return;
  await api('/api/open', {path});
  selected = new Set(); primary = null;
  refresh();
}
async function newProject() {
  if (!graph || !graph.nodes.length ||
      confirm('Discard the current graph?')) {
    await api('/api/new', {});
    selected = new Set(); primary = null; refresh();
  }
}
document.getElementById('open').onclick = openProject;
document.getElementById('new').onclick = newProject;
let notifSince = 0;
async function pollNotifications() {
  // The popup-manager analog: structured events stream into the panel.
  const items = await (await fetch('/api/notifications?since=' +
      notifSince, {headers:{'X-Nodey-Token': TOKEN}})).json();
  if (!items.length) return;
  notifSince = Math.max(...items.map(n => n.seq)) + 1;
  const pane = document.getElementById('notif');
  for (const n of items)
    pane.textContent = `[${n.severity}] ${n.message}` +
      (n.explanation ? ` — ${n.explanation}` : '') + '\\n' +
      pane.textContent;
}
async function poll() {
  try {
    await pollNotifications();
    const s = await (await fetch('/api/state',
        {headers:{'X-Nodey-Token': TOKEN}})).json();
    document.getElementById('state').textContent = s.state;
    document.getElementById('fill').style.width =
      Math.round(100 * s.fill_ratio) + '%';
    document.getElementById('metrics').textContent =
      s.blocks + ' blocks, ' + s.seconds.toFixed(1) + ' s' +
      (s.rtf_compute ? ', compute RTF ' + s.rtf_compute.toFixed(0) + 'x' : '');
    // Per-stage queue fills during a streamed export (the reference's
    // per-link channel gauges, app.cpp:1574-1595).
    const st = document.getElementById('stages');
    if (s.stages) {
      let html = '';
      for (const k of ['decode_fill', 'egress_fill', 'host_fill'])
        if (s.stages[k] !== undefined)
          html += '<div class="stage">' + k.replace('_fill', ' queue') +
            ' <div class="gauge"><i style="width:' +
            Math.round(100 * s.stages[k]) + '%"></i></div></div>';
      st.innerHTML = html;
    } else st.innerHTML = '';
    // Per-source run state: sources that reached EOF tint green during a
    // streamed export (reference per-processor state tallies,
    // app.cpp:1556-1568).
    const doneNodes = new Set();
    if (s.stages && s.stages.sources)
      for (const k in s.stages.sources)
        if (s.stages.sources[k].done) doneNodes.add(parseInt(k.slice(1)));
    for (const r of svg.querySelectorAll('rect[data-node]')) {
      const id = parseInt(r.getAttribute('data-node'));
      // Inline stroke would override the .sel class — keep the selection
      // highlight for selected nodes.
      r.style.stroke =
        doneNodes.has(id) && !selected.has(id) ? '#7fd962' : '';
    }
    // Per-edge chunk-flow FIFO fill coloring (the reference's per-link
    // occupancy gauges, app.cpp:1574-1595: green/yellow/red by fill).
    const nodeFill = {};
    if (s.stages && s.stages.edges)
      for (const k in s.stages.edges) {
        const nid = parseInt(k.split('/')[0]);
        nodeFill[nid] = Math.max(nodeFill[nid] || 0, s.stages.edges[k]);
      }
    for (const p of svg.querySelectorAll('path[data-tonode]')) {
      const f = nodeFill[parseInt(p.getAttribute('data-tonode'))];
      if (f === undefined) { p.style.stroke = ''; p.style.strokeWidth = ''; }
      else {
        p.style.stroke = f < 0.5 ? '#7fd962' : f < 0.85 ? '#e5c07b'
                                             : '#e06c75';
        p.style.strokeWidth = '3';
      }
    }
    if (s.spectrum) drawSpec(s.spectrum);
  } catch (e) {}
  setTimeout(poll, 500);
}
function drawSpec(rows) {
  const c = document.getElementById('spec'), ctx = c.getContext('2d');
  const W = rows.length, H = rows[0].length;
  const img = ctx.createImageData(W, H);
  for (let x = 0; x < W; x++) for (let y = 0; y < H; y++) {
    const v = Math.min(1, rows[x][H - 1 - y]);
    const i = 4 * (y * W + x);
    img.data[i] = 20 + 235 * v; img.data[i+1] = 40 + 120 * v;
    img.data[i+2] = 80 + 60 * v; img.data[i+3] = 255;
  }
  c.width = W; c.height = H;
  ctx.putImageData(img, 0, 0);
}
document.getElementById('run').onclick = async () => {
  // ?start=1: the stream endpoint registers its listener BEFORE starting
  // the preview, so the first blocks are never lost to a request race;
  // the click is the user gesture autoplay policies need. The POST is an
  // idempotent backstop in case the media fetch is deferred.
  const aud = document.getElementById('aud');
  aud.src = '/api/preview.wav?start=1&token=' +
      encodeURIComponent(TOKEN) + '&ts=' + Date.now();
  aud.play().catch(() => {});
  await api('/api/preview', {});
};
document.getElementById('stop').onclick = async () => {
  const aud = document.getElementById('aud');
  aud.pause(); aud.removeAttribute('src'); aud.load();
  await api('/api/stop', {});
};
// Help/About (reference: help.cpp:62-101's markdown manual).
function mdToHtml(s) {
  const esc = s.replace(/&/g, '&amp;').replace(/</g, '&lt;');
  return esc.split('\\n').map(l => {
    if (l.startsWith('### ')) return '<h4>' + l.slice(4) + '</h4>';
    if (l.startsWith('## ')) return '<h4>' + l.slice(3) + '</h4>';
    if (l.startsWith('# ')) return '<h4>' + l.slice(2) + '</h4>';
    if (l.startsWith('- ')) return '<div>&bull; ' + l.slice(2) + '</div>';
    return '<div>' + (l || '&nbsp;') + '</div>';
  }).join('')
    .replace(/\\*\\*([^*]+)\\*\\*/g, '<b>$1</b>')
    .replace(/`([^`]+)`/g, '<code>$1</code>');
}
document.getElementById('help').onclick = async () => {
  const h = await api('/api/help');
  let html = '<h4>' + h.about.name + '</h4><div>' + h.about.description +
    '</div><div>' + h.about.project_format + '</div><h4>Node manual</h4>';
  for (const n of h.nodes)
    html += '<h4>' + n.display_name + ' <code>' + n.identifier + '</code>' +
      (n.singleton ? ' (singleton)' : '') + '</h4>' +
      mdToHtml(n.description || '');
  document.getElementById('helpbody').innerHTML = html;
  document.getElementById('helpwin').style.display = 'block';
};
document.getElementById('helpclose').onclick = () =>
  document.getElementById('helpwin').style.display = 'none';
document.getElementById('export').onclick = () => api('/api/export', {
  path: document.getElementById('exppath').value,
  kbps: parseInt(document.getElementById('expkbps').value, 10)});
// Keyboard shortcuts, matching the reference editor (app.cpp:1841-1901).
window.addEventListener('keydown', async (e) => {
  if (e.target.tagName === 'TEXTAREA' || e.target.tagName === 'INPUT') return;
  const mod = e.ctrlKey || e.metaKey;
  if (mod && e.key === 'z') { e.preventDefault();
    await api('/api/undo', {}); refresh(); }
  else if (mod && e.key === 'y') { e.preventDefault();
    await api('/api/redo', {}); refresh(); }
  else if (mod && e.key === 's') { e.preventDefault();
    await saveProject(); }
  else if (mod && e.key === 'c' && selected.size) { e.preventDefault();
    await api('/api/copy', {node_ids: [...selected]}); }
  else if (mod && e.key === 'v') { e.preventDefault();
    await api('/api/paste', {}); refresh(); }
  else if (mod && e.key === 'a') { e.preventDefault();
    selected = new Set(graph.nodes.map(n => n.id)); loadGraph(); }
  else if (mod && e.key === 'o') { e.preventDefault(); await openProject(); }
  else if (mod && e.key === 'n') { e.preventDefault(); await newProject(); }
  else if (e.key === 'Delete' && selected.size) { e.preventDefault();
    await removeSelected(); }
  else if (e.key === 'Escape') { armedPin = null; selected = new Set();
    primary = null; hideMenu(); loadGraph(); }
});
// Context menus (reference: app.cpp:1720-1786 — background menu adds
// nodes at the cursor; node menu duplicates/removes the selection).
const menuEl = document.getElementById('ctxmenu');
function hideMenu() { menuEl.style.display = 'none'; }
function showMenu(ev, items) {
  ev.preventDefault(); ev.stopPropagation();
  menuEl.textContent = '';
  for (const it of items) {
    const d = document.createElement('div');
    d.textContent = it.label;
    if (it.disabled) d.className = 'dis';
    else d.onclick = () => { hideMenu(); it.run(); };
    menuEl.appendChild(d);
  }
  menuEl.style.left = ev.clientX + 'px';
  menuEl.style.top = ev.clientY + 'px';
  menuEl.style.display = 'block';
}
function nodeMenu(ev, n) {
  if (!selected.has(n.id)) selectNode(n, null);
  showMenu(ev, [
    {label: 'duplicate', run: async () => {
      // Dedicated endpoint: duplicating must not clobber the clipboard.
      await api('/api/duplicate',
                {node_ids: [...selected], x: n.x + 40, y: n.y + 40});
      refresh(); }},
    {label: 'copy', run: () => api('/api/copy', {node_ids: [...selected]})},
    {label: 'remove', run: removeSelected},
  ]);
}
svg.addEventListener('contextmenu', async (ev) => {
  if (ev.target !== svg) return;
  ev.preventDefault();  // before the await, or the native menu wins
  const x = ev.offsetX, y = ev.offsetY;
  const reg = await api('/api/registry');
  showMenu(ev, reg.map(r => ({
    label: '+ ' + r.display_name, disabled: r.disabled,
    run: async () => {
      await api('/api/edit/add-node', {identifier: r.identifier, x, y});
      refresh(); }})));
});
window.addEventListener('click', hideMenu);
// Settings dialog with staged apply (reference: settings.cpp:118-206).
document.getElementById('settings').onclick = async () => {
  const s = await api('/api/settings');
  document.getElementById('settext').value = JSON.stringify(s, null, 1);
  document.getElementById('setwin').style.display = 'block';
};
document.getElementById('setclose').onclick = () =>
  document.getElementById('setwin').style.display = 'none';
document.getElementById('setapply').onclick = async () => {
  let body;
  try { body = JSON.parse(document.getElementById('settext').value); }
  catch (e) { err('bad JSON: ' + e.message); return; }
  await api('/api/settings', body);
  document.getElementById('setwin').style.display = 'none';
  await loadSettings();  // staged apply takes effect immediately
  loadGraph();
};
loadSettings().then(loadGraph); loadRegistry(); poll();
</script></body></html>
"""


class _AudioListener:
    """Bounded PCM buffer for one live-audio HTTP client.

    Live-stream semantics: a stalled client drops the OLDEST blocks rather
    than back-pressuring the preview (the reference instead paces preview to
    1.0x against the SDL queue, audio-io.cpp:620-624 — here the realtime
    pacer lives in the preview loop, so a healthy client never overruns)."""

    def __init__(self, max_blocks: int = 256):
        self.q: "_queue.Queue[Optional[bytes]]" = _queue.Queue(max_blocks)
        self.dropped = 0

    def push(self, item: Optional[bytes]) -> None:
        while True:
            try:
                self.q.put_nowait(item)
                return
            except _queue.Full:
                try:
                    self.q.get_nowait()
                    self.dropped += 1
                except _queue.Empty:
                    pass


# Liveness bounds for /api/preview.wav: a not-yet-started stream stays
# attached for the grace period (the UI races the media fetch against the
# preview POST); a stream that never receives audio (e.g. opened while an
# export runs) closes at the hard cap. Module-level so tests can shrink
# them.
AUDIO_STREAM_IDLE_GRACE_S = 10.0
AUDIO_STREAM_MAX_IDLE_S = 600.0


def _wav_stream_header(rate: int = 48_000, channels: int = 2) -> bytes:
    """RIFF/WAVE header for an unbounded live stream (sizes pinned at
    0xFFFFFFFF, the conventional marker players accept for live WAV)."""
    byte_rate = rate * channels * 2
    return (
        b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
        + b"fmt " + struct.pack(
            "<IHHIIHH", 16, 1, channels, rate, byte_rate, channels * 2, 16
        )
        + b"data" + struct.pack("<I", 0xFFFFFFFF)
    )


@contextlib.contextmanager
def _job_stream(device: torch.device):
    """Bind a job thread to the viewer's CUDA device and a stream of its
    own, as the streaming producers bind theirs (nothing on the CPU)."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device):
        with torch.cuda.stream(torch.cuda.Stream(device)):
            yield


class ViewerState:
    """Holds the editing session + live preview + derived overlay data.

    ``device`` is where previews and exports render (``cuda`` by default);
    a CUDA device without a card raises here, before anything is served."""

    def __init__(self, graph: Graph, title: str,
                 project_path: Optional[str] = None,
                 auth_token: Optional[str] = None,
                 fs_root: Optional[str] = None,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        # Per-session auth (Jupyter-style): the token gates EVERY endpoint
        # including the page itself, so a DNS-rebound origin can neither
        # read state nor scrape the token out of the served page. The CLI
        # prints the tokenized URL at startup.
        self.auth_token = auth_token or secrets.token_urlsafe(16)
        # Optional confinement root for the /api/fs browser; None lists
        # any user-readable directory (loopback-trusted default).
        self.fs_root = os.path.abspath(fs_root) if fs_root else None
        self.session = SessionService()
        self.session.graph = graph
        self.session.project_path = project_path
        self.title = title
        self.lock = threading.Lock()
        # Serializes all graph/session access across HTTP handler threads
        # (ThreadingHTTPServer runs each request on its own thread; the
        # reference is single-threaded UI + an engine thread).
        self.edit_lock = threading.RLock()
        self.preview_session = None
        self._job_thread: Optional[threading.Thread] = None
        self._export_runner: Optional[Runner] = None
        # "preview" | "export" | None — state == "running" alone cannot
        # distinguish the two, and both the stage gauges and the audio
        # stream's liveness checks must not conflate them.
        self._job_kind: Optional[str] = None
        self.state = "idle"
        self.blocks = 0
        self.seconds = 0.0
        self.fill_ratio = 0.0
        self.rtf_compute = 0.0
        self.spectrum: Optional[list] = None
        self.error: Optional[str] = None
        # Structured event queue (the popup-manager analog) — exposed at
        # /api/notifications for editor clients.
        self.notifications = NotificationCenter()
        # Live audio fan-out: each /api/preview.wav connection registers a
        # bounded listener the preview loop publishes s16 PCM into — the
        # browser-audible counterpart of the reference's SDL playback queue
        # (sdl-context.cpp:40-59, audio-io.cpp:620-636), with the same
        # bounded-buffer drop-on-overrun live semantics.
        self._audio_lock = threading.Lock()
        self._audio_listeners: List[_AudioListener] = []

    # -- live audio fan-out ---------------------------------------------------

    def add_audio_listener(self) -> "_AudioListener":
        listener = _AudioListener()
        with self._audio_lock:
            self._audio_listeners.append(listener)
        return listener

    def remove_audio_listener(self, listener: "_AudioListener") -> None:
        with self._audio_lock:
            if listener in self._audio_listeners:
                self._audio_listeners.remove(listener)

    def _publish_audio(self, block: np.ndarray) -> None:
        """Push one preview master block (float32 [2, n] @48 kHz) to every
        attached /api/preview.wav stream as interleaved s16 bytes."""
        with self._audio_lock:
            listeners = list(self._audio_listeners)
        if not listeners:
            return
        pcm = np.clip(
            block.T * np.float32(32767.0), -32768, 32767
        ).astype(np.int16).tobytes()
        for listener in listeners:
            listener.push(pcm)

    def _publish_audio_eof(self) -> None:
        with self._audio_lock:
            listeners = list(self._audio_listeners)
        for listener in listeners:
            listener.push(None)

    @property
    def graph(self) -> Graph:
        return self.session.graph

    def graph_json(self) -> Dict[str, Any]:
        nodes = []
        for nid, node in self.graph.nodes.items():
            info = node.processor.info()
            pins = [
                {
                    "id": pid,
                    "identifier": self.graph.pins[pid].attribute.identifier,
                    "display_name": self.graph.pins[pid].attribute.display_name,
                    "is_input": self.graph.pins[pid].attribute.is_input,
                }
                for pid in node.pins
            ]
            nodes.append(
                {
                    "id": nid,
                    "identifier": info.identifier,
                    "display_name": info.display_name,
                    "description": info.description,
                    "params": node.processor.serialize(),
                    "spec": node.processor.param_spec(),
                    "x": node.position[0],
                    "y": node.position[1],
                    "pins": pins,
                }
            )
        links = [
            {"from": link.from_pin, "to": link.to_pin}
            for link in self.graph.links.values()
        ]
        return {
            "title": self.title,
            "nodes": nodes,
            "links": links,
            "modified": self.graph.modified,
        }

    def fs_list(self, path: str) -> Dict[str, Any]:
        """Directory listing for the in-editor file browser — the web
        redesign of the reference's native open/save/folder pickers
        (dialog-utility.cpp:15-92; pfd replaced by a server-backed
        dialog, like imgui -> browser for the rest of the frontend).
        Serves the loopback-bound editor only; responses are unreadable
        cross-origin (no CORS headers)."""
        if not path:
            if self.fs_root:
                path = self.fs_root
            elif self.session.project_path:
                path = os.path.dirname(
                    os.path.abspath(self.session.project_path)
                )
            else:
                path = os.path.expanduser("~")
        base = os.path.abspath(path)
        if self.fs_root is not None:
            # Root-dir confinement: refuse to list outside the configured
            # root (symlink-resolved so a link inside cannot escape).
            real = os.path.realpath(base)
            root = os.path.realpath(self.fs_root)
            if os.path.commonpath([real, root]) != root:
                raise InvalidFileError(
                    f"outside the served root: {base}"
                )
        if not os.path.isdir(base):
            raise InvalidFileError(f"not a directory: {base}")
        entries = []
        with os.scandir(base) as it:
            for e in it:
                if e.name.startswith("."):
                    continue
                try:
                    is_dir = e.is_dir()
                    size = 0 if is_dir else e.stat().st_size
                except OSError:
                    continue
                entries.append({"name": e.name, "dir": is_dir, "size": size})
        entries.sort(key=lambda x: (not x["dir"], x["name"].lower()))
        parent = os.path.dirname(base)
        if self.fs_root is not None and os.path.realpath(base) == \
                os.path.realpath(self.fs_root):
            parent = base  # confined: no "up" past the served root
        return {
            "path": base,
            "parent": parent if parent != base else None,
            "sep": os.sep,
            "entries": entries[:1000],
        }

    def registry_json(self) -> list:
        return [
            {
                "identifier": ident,
                "display_name": info.display_name,
                "singleton": info.singleton,
                # Singleton types already instantiated are disabled in the
                # add menu, like the reference (app.cpp:1700-1717).
                "disabled": bool(
                    info.singleton
                    and ident in self.graph.singleton_node_map
                ),
            }
            for ident, info in sorted(registry.processor_map.items())
        ]

    # -- edits (each mirrors a reference app mutation) -----------------------

    def _guard_editable(self) -> None:
        # Guard on the WORKER THREAD being alive, not the state string: a
        # stop request flips the state immediately, but the preview/export
        # thread may still be reading the graph while it winds down.
        if self._job_thread is not None and self._job_thread.is_alive():
            raise NodeyError(
                "Stop the running preview/export (and let it finish "
                "winding down) before editing the graph"
            )

    def edit(self, op: str, body: Dict[str, Any]) -> Dict[str, Any]:
        self._guard_editable()
        g = self.graph
        if op == "add-node":
            info = registry.processor_map.get(body.get("identifier"))
            if info is None:
                raise NodeyError(
                    f"Unknown node type '{body.get('identifier')}'"
                )
            self.session.save_undo_state()
            proc = info.generate()
            if body.get("params"):
                apply_params(proc, body["params"])
            nid = g.add_node(proc)
            g.nodes[nid].position = (
                float(body.get("x", 80.0)), float(body.get("y", 80.0))
            )
            g.modified = True
            return {"ok": True, "node_id": nid}
        if op == "remove-node":
            nid = int(body["node_id"])
            if nid not in g.nodes:
                raise NodeyError(f"No node {nid}")
            self.session.save_undo_state()
            g.remove_node(nid)
            g.modified = True
            return {"ok": True}
        if op == "remove-nodes":
            # Batch delete = ONE undo snapshot (one user gesture, one
            # Ctrl+Z — the reference's delete-selected semantics); validate
            # every id up front so the mutation is all-or-nothing.
            # Dedupe (order-preserving): duplicate ids would pass the
            # existence check, then fail mid-loop after mutating.
            nids = list(dict.fromkeys(int(n) for n in body.get("node_ids", [])))
            missing = [n for n in nids if n not in g.nodes]
            if missing:
                raise NodeyError(f"No node {missing[0]}")
            if not nids:
                return {"ok": True, "removed": 0}
            self.session.save_undo_state()
            for nid in nids:
                g.remove_node(nid)
            g.modified = True
            return {"ok": True, "removed": len(nids)}
        if op == "link":
            self.session.save_undo_state()
            link_id = g.add_link(int(body["from_pin"]), int(body["to_pin"]))
            try:
                # Validate-and-rollback, exactly the app's link flow
                # (app.cpp:1826-1839).
                g.check_graph()
            except NodeyError:
                g.remove_link(link_id)
                self.session.undo_stack.pop()
                raise
            g.modified = True
            return {"ok": True, "link_id": link_id}
        if op == "unlink":
            self.session.save_undo_state()
            g.remove_link_between(
                int(body["from_pin"]), int(body["to_pin"])
            )
            g.modified = True
            return {"ok": True}
        if op == "set":
            nid = int(body["node_id"])
            node = g.nodes.get(nid)
            if node is None:
                raise NodeyError(f"No node {nid}")
            # Snapshot BEFORE applying: parameter edits are undoable
            # (Processor.snapshot_params rides every undo state).
            self.session.save_undo_state()
            applied = apply_params(node.processor, body.get("params") or {})
            g.update_node_pin(nid)  # arity may have changed
            g.modified = True
            return {"ok": True, "applied": applied}
        if op == "move":
            nid = int(body["node_id"])
            node = g.nodes.get(nid)
            if node is None:
                raise NodeyError(f"No node {nid}")
            node.position = (float(body["x"]), float(body["y"]))
            g.modified = True
            return {"ok": True}
        raise NodeyError(f"Unknown edit op '{op}'")

    def copy(self, body: Dict[str, Any]) -> Dict[str, Any]:
        count = self.session.copy_nodes(
            [int(n) for n in body.get("node_ids", [])]
        )
        return {"ok": True, "count": count}

    def paste(self, body: Dict[str, Any]) -> Dict[str, Any]:
        self._guard_editable()
        at = None
        if "x" in body and "y" in body:
            at = (float(body["x"]), float(body["y"]))
        new_ids = self.session.paste_nodes(at=at)
        return {"ok": True, "node_ids": new_ids}

    def duplicate(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Duplicate nodes WITHOUT touching the user's clipboard (the
        context-menu action must not have copy's side effect)."""
        self._guard_editable()
        ids = [int(n) for n in body.get("node_ids", [])]
        at = None
        if "x" in body and "y" in body:
            at = (float(body["x"]), float(body["y"]))
        saved_clipboard = self.session.clipboard_json
        try:
            if not self.session.copy_nodes(ids):
                return {"ok": True, "node_ids": []}
            new_ids = self.session.paste_nodes(at=at)
        finally:
            self.session.clipboard_json = saved_clipboard
        return {"ok": True, "node_ids": new_ids}

    def undo(self) -> Dict[str, Any]:
        self._guard_editable()
        return {"ok": self.session.undo()}

    def redo(self) -> Dict[str, Any]:
        self._guard_editable()
        return {"ok": self.session.redo()}

    def save(self, body: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Save the project; an explicit ``path`` in the body becomes the
        project path (save-as — required the first time when the server
        was started on an empty canvas)."""
        path = (body or {}).get("path") or None
        if not path and not self.session.project_path:
            raise NodeyError(
                "No project path yet — save with {\"path\": \"...\"} first"
            )
        path = self.session.save_project(path)
        self.title = path
        return {"ok": True, "path": path}

    def new_project(self) -> Dict[str, Any]:
        """Clear to an empty graph (reference: new_project_async,
        app.cpp:775-831; the modified-flag confirmation lives client-side)."""
        self._guard_editable()
        keep_path = self.session.project_path
        self.session.new_project()  # clears undo/redo: fresh project
        self.session.project_path = keep_path
        return {"ok": True}

    def open_project(self, body: Dict[str, Any]) -> Dict[str, Any]:
        self._guard_editable()
        path = body.get("path")
        if not path:
            raise NodeyError("open requires a 'path'")
        self.session.open_project(path)
        self.title = path
        return {"ok": True, "nodes": len(self.graph.nodes)}

    def settings_json(self) -> Dict[str, Any]:
        return self.session.settings.serialize()

    def apply_settings(self, body: Dict[str, Any]) -> Dict[str, Any]:
        # Staged apply like the reference settings dialog
        # (settings.cpp:118-206): merge the posted blob, report back the
        # effective values.
        self.session.settings.deserialize(body)
        return {"ok": True, "settings": self.session.settings.serialize()}

    # -- export ---------------------------------------------------------------

    def start_export(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Streamed export with live progress (the reference's export
        window flow: path + kbps + progress atomic, app.cpp:590-682,
        2042-2094), through ``Runner.export_streamed`` on the viewer's
        device. A stop (``stop_preview``) cancels it, also one that lands
        before the runner has started: the partial file is removed and the
        state reads "stopped"."""
        path = body.get("path") or "export.mp3"
        kbps = int(body.get("kbps", 320))
        if kbps not in (64, 96, 128, 160, 192, 256, 320):
            raise NodeyError(f"Unsupported bitrate {kbps} kbps")
        runner = Runner(self.graph, device=self.device)
        with self.lock:
            if self.state == "running" or (
                self._job_thread is not None
                and self._job_thread.is_alive()
            ):
                raise NodeyError("A preview or export is already running")
            self.state = "running"
            self._job_kind = "export"
            self.blocks = 0
            self.seconds = 0.0
            self.error = None
            self._export_runner = runner

        def progress(seconds: float) -> None:
            with self.lock:
                self.seconds = seconds

        def consume() -> None:
            try:
                with _job_stream(self.device):
                    metrics = runner.export_streamed(
                        path, kbps=kbps, progress=progress
                    )
                self.notifications.push(
                    "info", f"Exported {path}",
                    f"{metrics.audio_seconds:.1f} audio-s at {kbps} kbps "
                    f"in {metrics.wall_seconds:.1f} s (RTF "
                    f"{metrics.rtf:.1f}x)",
                )
                with self.lock:
                    self.rtf_compute = metrics.rtf
                    # The file is whole even where a stop came after its
                    # last block.
                    self.state = "finished"
            except RunCancelled:
                # A user stop is not an error (reference: teardown back to
                # Editing, app.cpp:1949-1957); the partial file was removed.
                self.notifications.push(
                    "info", "Export cancelled", f"Stopped writing {path}."
                )
                with self.lock:
                    self.state = "stopped"
            except BaseException as exc:
                self.notifications.push_error(exc)
                with self.lock:
                    self.state = "error"
                    self.error = str(exc)
            finally:
                # Drop the runner handle so a later preview's state poll
                # cannot read this (finished) export's stage gauges.
                self._export_runner = None

        self._job_thread = threading.Thread(target=consume, daemon=True)
        self._job_thread.start()
        return {"ok": True, "path": path, "kbps": kbps}

    # -- preview --------------------------------------------------------------

    def start_preview(self) -> bool:
        """Start a preview; returns False (without error) if a job is
        already running — the UI's play button and the audio stream's
        ?start=1 both call this, so it must be idempotent. The session
        streams on the viewer's device, paced at 1.0x; every block goes to
        the attached /api/preview.wav streams as s16."""
        session = StreamingSession(self.graph, device=self.device)
        with self.lock:
            if self.state == "running" or (
                self._job_thread is not None
                and self._job_thread.is_alive()
            ):
                return False
            self.state = "running"
            self._job_kind = "preview"
            self.blocks = 0
            self.seconds = 0.0
            self.error = None
            self.preview_session = session

        def consume() -> None:
            try:
                with _job_stream(self.device):
                    session.start(streamed=True)
                for block in session.blocks(realtime=True):
                    with self.lock:
                        self.blocks += 1
                        self.seconds += block.shape[1] / cfg.SAMPLE_RATE
                        self.fill_ratio = session.queue.stats.fill_ratio
                    self._publish_audio(block)
                    self._update_spectrum(block)
                with self.lock:
                    self.rtf_compute = session.stats.rtf_compute
                    if self.state == "running":
                        # A user stop drains the block iterator too; keep
                        # the 'stopped' status instead of reporting a
                        # cancelled preview as finished.
                        self.state = "finished"
            except BaseException as exc:  # surfaced in the overlay
                self.notifications.push_error(exc)
                with self.lock:
                    self.state = "error"
                    self.error = str(exc)
            finally:
                self._publish_audio_eof()

        self._job_thread = threading.Thread(target=consume, daemon=True)
        self._job_thread.start()
        return True

    def _update_spectrum(self, block: np.ndarray) -> None:
        """Rolling STFT of the preview output for the spectrum panel."""
        n_fft = 512
        if block.shape[1] < n_fft:
            return
        mono = block.mean(axis=0)
        frames = min(8, block.shape[1] // n_fft)
        cols = []
        for f in range(frames):
            seg = mono[f * n_fft : (f + 1) * n_fft] * np.hanning(n_fft)
            mag = np.abs(np.fft.rfft(seg))[:128]
            cols.append(
                np.clip(np.log10(mag + 1e-4) / 3.0 + 1.0, 0, 1).tolist()
            )
        with self.lock:
            spec = (self.spectrum or []) + cols
            self.spectrum = spec[-256:]

    def stop_preview(self) -> None:
        """Cooperative stop for whichever job is running (preview OR
        export); edits stay blocked until the worker thread exits
        (_guard_editable checks thread liveness, not the state string)."""
        if self.preview_session is not None:
            self.preview_session.stop()
        runner = self._export_runner
        if runner is not None:
            runner.stop()
        with self.lock:
            if self.state == "running":
                self.state = "stopped"

    def state_json(self) -> Dict[str, Any]:
        # Mid-run stage-queue occupancy (the reference's per-link fill
        # gauges, app.cpp:1574-1595): during a streamed export the executor
        # publishes decode-ahead / egress / host-queue fills.
        stages = None
        with self.lock:
            # Pair the runner with its job kind atomically — the export
            # thread clears _export_runner in its finally block, and a poll
            # racing that clear must not attach a stale stages snapshot to
            # the new state. live_stats() itself runs outside the lock.
            runner = (
                self._export_runner if self._job_kind == "export" else None
            )
        if runner is not None:
            executor = getattr(runner, "_active_executor", None)
            if executor is not None:
                try:
                    stages = executor.live_stats()
                except Exception:
                    stages = None
        with self.lock:
            if self.state != "running":
                stages = None
            return {
                "state": self.state,
                "blocks": self.blocks,
                "seconds": self.seconds,
                "fill_ratio": self.fill_ratio,
                "rtf_compute": self.rtf_compute,
                "spectrum": self.spectrum,
                "stages": stages,
                "error": self.error,
            }

    def help_json(self) -> Dict[str, Any]:
        """The help/about surface (reference: src/frontend/help.cpp:5-132 —
        node manual from each processor's markdown description plus an
        about box)."""
        return {
            "about": {
                "name": "nodey_tpu_torch",
                "description": (
                    "Node-graph audio engine on PyTorch: the DAG runs "
                    "eagerly on one device, with hand-written CUDA kernels "
                    "for the resampler, the WSOLA chain and the phase "
                    "vocoder on an NVIDIA H100; decode/encode run in a "
                    "native host runtime. A port of nodey_tpu, the "
                    "TPU re-design of Stehsaer/nodey-audio-editor."
                ),
                "project_format": (
                    "Project files are JSON, schema-compatible with the "
                    "reference editor (nodes/links/positions)."
                ),
            },
            "nodes": [
                {
                    "identifier": ident,
                    "display_name": info.display_name,
                    "singleton": info.singleton,
                    "description": info.description,
                }
                for ident, info in sorted(registry.processor_map.items())
            ],
        }


def make_handler(viewer: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet server
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj: Any, code: int = 200) -> None:
            self._send(
                code, json.dumps(obj).encode(), "application/json"
            )

        def _body(self) -> Dict[str, Any]:
            length = int(self.headers.get("Content-Length") or 0)
            if not length:
                return {}
            try:
                return json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                return {}

        def _token_ok(self) -> bool:
            """Per-session auth: the token travels as the
            X-Nodey-Token header (the page's fetches) or a ?token= query
            param (the initial navigation + the <audio> stream). Constant-
            time compare; a rebound origin can neither guess it nor read
            it out of any response it is allowed to fetch."""
            supplied = self.headers.get("X-Nodey-Token", "")
            if not supplied:
                q = parse_qs(urlparse(self.path).query)
                supplied = (q.get("token") or [""])[0]
            return hmac.compare_digest(supplied, viewer.auth_token)

        def do_GET(self) -> None:
            if not self._host_ok():
                self._json(
                    {"ok": False, "error": "host header rejected"}, 403
                )
                return
            if not self._token_ok():
                if self.path == "/" or not self.path.startswith("/api/"):
                    self._send(
                        403,
                        b"<html><body><h3>Authentication required</h3>"
                        b"<p>Open the editor with the tokenized URL "
                        b"printed by <code>python -m nodey_tpu_torch "
                        b"serve</code> "
                        b"(http://&lt;host&gt;:&lt;port&gt;/?token=...)."
                        b"</p></body></html>",
                        "text/html; charset=utf-8",
                    )
                else:
                    self._json(
                        {"ok": False, "error": "missing or bad token"}, 403
                    )
                return
            try:
                self._do_get()
            except NodeyError as exc:
                self._json({"ok": False, "error": str(exc)}, 400)
            except Exception as exc:  # keep the poll endpoints alive
                self._json({"ok": False, "error": f"internal: {exc}"}, 500)

        def _do_get(self) -> None:
            # Route on the path alone: every endpoint may carry a ?token=
            # (and its own query params, parsed from self.path as before).
            route = self.path.split("?", 1)[0]
            if route == "/":
                page = _PAGE.replace("%TITLE%", viewer.title).replace(
                    "%TOKEN%", json.dumps(viewer.auth_token)
                )
                self._send(200, page.encode(), "text/html; charset=utf-8")
            elif route == "/api/graph":
                with viewer.edit_lock:
                    self._json(viewer.graph_json())
            elif route == "/api/registry":
                with viewer.edit_lock:
                    self._json(viewer.registry_json())
            elif route == "/api/state":
                # The poll tick doubles as the autosave heartbeat (the
                # reference declares auto_save but never wires it;
                # SessionService implements it). Serialized with edits and
                # best-effort: an autosave failure must not kill the poll.
                try:
                    with viewer.edit_lock:
                        viewer.session.maybe_autosave()
                except Exception:
                    pass
                self._json(viewer.state_json())
            elif route == "/api/settings":
                self._json(viewer.settings_json())
            elif route == "/api/help":
                self._json(viewer.help_json())
            elif route == "/api/fs":
                q = parse_qs(urlparse(self.path).query)
                self._json(viewer.fs_list(q.get("path", [""])[0]))
            elif route == "/api/preview.wav":
                self._stream_preview_wav()
            elif route == "/api/notifications":
                # Drain-style consumption: ?since=<seq> peeks newer items.
                q = parse_qs(urlparse(self.path).query)
                try:
                    since = int((q.get("since") or ["0"])[0])
                except ValueError:
                    since = 0
                self._json(
                    [n.as_dict() for n in viewer.notifications.peek(since)]
                )
            else:
                self._json({"error": "not found"}, 404)

        def _stream_preview_wav(self) -> None:
            """Chunked live-WAV response: the audible preview sink.

            Attaches to the running preview (or starts one with ?start=1)
            and streams its 48 kHz stereo master as s16 WAV until the
            preview ends or the client disconnects — the browser-played
            counterpart of the reference's SDL audio queue
            (audio-io.cpp:620-636). Realtime pacing comes from the preview
            loop itself; this response just relays its blocks."""
            listener = viewer.add_audio_listener()
            if "start=1" in self.path:
                viewer.start_preview()
            # A stalled-but-open client (paused audio element) must not
            # park this thread in wfile.write forever — a send that makes
            # no progress for 15 s raises socket.timeout (an OSError) and
            # closes the stream; drop-oldest continues in the listener.
            self.connection.settimeout(15.0)
            try:
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(_wav_stream_header())
                idle, streamed = 0.0, False
                while True:
                    try:
                        item = listener.q.get(timeout=0.5)
                    except _queue.Empty:
                        idle += 0.5
                        with viewer.lock:
                            # Only a running PREVIEW will ever feed this
                            # stream; a running export must not keep it
                            # alive (it never publishes audio).
                            running = (
                                viewer.state == "running"
                                and viewer._job_kind == "preview"
                            )
                        # Keep a not-yet-started stream alive briefly (the
                        # UI attaches the <audio> element before POSTing
                        # /api/preview), but never hang a dead one.
                        if not running and (
                            streamed or idle > AUDIO_STREAM_IDLE_GRACE_S
                        ):
                            break
                        if idle > AUDIO_STREAM_MAX_IDLE_S:
                            break
                        continue
                    if item is None:
                        break
                    idle, streamed = 0.0, True
                    self.wfile.write(item)
                    self.wfile.flush()
            except OSError:
                pass  # client hung up / stalled (pause, navigation, abort)
            finally:
                viewer.remove_audio_listener(listener)

        def _allowed_hosts(self):
            bind_host, bind_port = self.server.server_address[:2]
            if bind_host in ("0.0.0.0", "::", ""):
                # Explicit wide bind: the user chose LAN exposure; accept
                # any Host naming this port (rebinding protection then
                # rests on the Origin check for mutations).
                return None, bind_port
            allowed = {f"{bind_host}:{bind_port}"}
            if bind_host in ("127.0.0.1", "localhost", "::1"):
                allowed |= {
                    f"127.0.0.1:{bind_port}",
                    f"localhost:{bind_port}",
                    f"[::1]:{bind_port}",
                }
            return allowed, bind_port

        def _host_ok(self) -> bool:
            """DNS-rebinding guard, applied to EVERY request (GETs leak
            directory listings, graph state, audio): a rebound hostname
            resolves here but carries the attacker's Host header, which
            cannot name the bound address."""
            allowed, bind_port = self._allowed_hosts()
            host = self.headers.get("Host", "")
            if allowed is None:
                return host.endswith(f":{bind_port}") or ":" not in host
            return host in allowed

        def _same_origin(self) -> bool:
            """Reject cross-site POSTs (CSRF): every mutating endpoint —
            /api/open and /api/save most critically, which accept
            filesystem paths — must come from the served page itself. A
            malicious web page can fire simple POSTs at 127.0.0.1, but
            the browser stamps them with its Origin — including the
            literal "null" from sandboxed iframes / data: URLs, which is
            therefore REJECTED, not exempted — and cannot forge Host.
            Header-less clients (curl, tests, non-browser tools) carry no
            Origin and pass; every browser sends Origin on cross-site
            POSTs."""
            if not self._host_ok():
                return False
            origin = self.headers.get("Origin")
            if origin:
                scheme, _, rest = origin.partition("://")
                host = self.headers.get("Host", "")
                allowed, _port = self._allowed_hosts()
                ok_hosts = allowed if allowed is not None else {host}
                if scheme != "http" or rest not in ok_hosts:
                    return False
            return True

        def do_POST(self) -> None:
            if not self._same_origin():
                self._json(
                    {"ok": False, "error": "cross-origin request rejected"},
                    403,
                )
                return
            if not self._token_ok():
                self._json(
                    {"ok": False, "error": "missing or bad token"}, 403
                )
                return
            try:
                if self.path == "/api/preview":
                    started = viewer.start_preview()
                    self._json({"ok": True, "started": started})
                elif self.path == "/api/export":
                    self._json(viewer.start_export(self._body()))
                elif self.path == "/api/stop":
                    viewer.stop_preview()
                    self._json({"ok": True})
                elif self.path.startswith("/api/edit/"):
                    op = self.path[len("/api/edit/"):]
                    with viewer.edit_lock:
                        self._json(viewer.edit(op, self._body()))
                elif self.path == "/api/copy":
                    with viewer.edit_lock:
                        self._json(viewer.copy(self._body()))
                elif self.path == "/api/paste":
                    with viewer.edit_lock:
                        self._json(viewer.paste(self._body()))
                elif self.path == "/api/duplicate":
                    with viewer.edit_lock:
                        self._json(viewer.duplicate(self._body()))
                elif self.path == "/api/undo":
                    with viewer.edit_lock:
                        self._json(viewer.undo())
                elif self.path == "/api/redo":
                    with viewer.edit_lock:
                        self._json(viewer.redo())
                elif self.path == "/api/save":
                    with viewer.edit_lock:
                        self._json(viewer.save(self._body()))
                elif self.path == "/api/new":
                    with viewer.edit_lock:
                        self._json(viewer.new_project())
                elif self.path == "/api/open":
                    with viewer.edit_lock:
                        self._json(viewer.open_project(self._body()))
                elif self.path == "/api/settings":
                    with viewer.edit_lock:
                        self._json(viewer.apply_settings(self._body()))
                else:
                    self._json({"error": "not found"}, 404)
            except NodeyError as exc:
                self._json({"ok": False, "error": str(exc)}, 400)
            except (KeyError, TypeError, ValueError, OSError) as exc:
                self._json(
                    {"ok": False, "error": f"bad request: {exc}"}, 400
                )

    return Handler


def serve(graph: Graph, title: str, host: str = "127.0.0.1",
          port: int = 8787,
          project_path: Optional[str] = None,
          auth_token: Optional[str] = None,
          fs_root: Optional[str] = None,
          device: torch.device | str = "cuda") -> ThreadingHTTPServer:
    """Start the editor server (returns it; call serve_forever/shutdown).

    ``auth_token`` None generates a fresh per-session token (read it back
    from ``server.viewer.auth_token``; the CLI prints the tokenized URL).
    ``fs_root`` confines the /api/fs browser to a directory subtree.
    ``device``: where previews and exports render; a CUDA device without a
    card raises before the socket is bound. ``port`` 0 binds a free port
    (``server.server_address``)."""
    viewer = ViewerState(graph, title, project_path=project_path,
                         auth_token=auth_token, fs_root=fs_root,
                         device=device)
    server = ThreadingHTTPServer((host, port), make_handler(viewer))
    server.viewer = viewer
    return server
