"""The embedded single-page UI (no external assets, ImGui-flavored dark
theme). Layout mirrors the reference's editor dock (GuiPass.cpp:343-589):
param tree left, viewport center, stats + per-pass timings + graph right.
"""

PAGE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>zetaray_tpu_torch viewer</title>
<style>
  :root { --bg:#15171c; --panel:#1e2128; --edge:#2c313c; --fg:#c9cdd6;
          --dim:#8a90a0; --acc:#4c8dff; --acc2:#e8a33d; }
  * { box-sizing: border-box; }
  body { margin:0; background:var(--bg); color:var(--fg);
         font:13px/1.45 "Segoe UI", system-ui, sans-serif; display:flex;
         height:100vh; overflow:hidden; }
  .panel { background:var(--panel); border-right:1px solid var(--edge);
           overflow-y:auto; }
  #left { width:300px; padding:10px; }
  #mid { flex:1; display:flex; flex-direction:column; align-items:center;
         justify-content:center; position:relative; }
  #right { width:320px; border-left:1px solid var(--edge);
           border-right:none; padding:10px; }
  h1 { font-size:14px; margin:2px 0 10px; color:var(--acc); }
  h2 { font-size:12px; text-transform:uppercase; letter-spacing:.08em;
       color:var(--dim); margin:14px 0 6px; cursor:pointer; }
  h2::before { content:"▾ "; color:var(--acc); }
  h2.closed::before { content:"▸ "; }
  .sub { margin-left:6px; border-left:1px solid var(--edge); padding-left:8px; }
  .row { display:flex; align-items:center; gap:6px; margin:3px 0; }
  .row label { flex:1; color:var(--fg); white-space:nowrap; overflow:hidden; }
  input[type=range] { flex:1.2; accent-color:var(--acc); }
  input[type=number] { width:64px; background:var(--bg); color:var(--fg);
       border:1px solid var(--edge); border-radius:3px; padding:2px 4px; }
  select { background:var(--bg); color:var(--fg); border:1px solid var(--edge);
           border-radius:3px; padding:2px; }
  input[type=checkbox] { accent-color:var(--acc); }
  #viewport { image-rendering:auto; border:1px solid var(--edge);
              max-width:96%; max-height:86vh; cursor:crosshair; }
  #hud { position:absolute; top:8px; left:12px; background:#000a;
         padding:4px 10px; border-radius:4px; font-size:12px; }
  #pickinfo { position:absolute; bottom:8px; left:12px; background:#000a;
              padding:4px 10px; border-radius:4px; font-size:12px;
              color:var(--acc2); }
  button { background:var(--bg); color:var(--fg); border:1px solid var(--edge);
           border-radius:3px; padding:3px 10px; cursor:pointer; margin:2px; }
  button:hover { border-color:var(--acc); color:var(--acc); }
  canvas { background:var(--bg); border:1px solid var(--edge); width:100%; }
  table { width:100%; border-collapse:collapse; font-size:12px; }
  td { padding:1px 4px; border-bottom:1px solid var(--edge); }
  td:last-child { text-align:right; color:var(--acc2); }
  pre { background:var(--bg); border:1px solid var(--edge); padding:6px;
        font-size:10px; overflow:auto; max-height:300px; }
  .dim { color:var(--dim); }
</style></head>
<body>
<div id="left" class="panel"><h1>zetaray_tpu_torch</h1><div id="params"></div></div>
<div id="mid">
  <div id="hud">…</div>
  <img id="viewport" alt="viewport">
  <div id="pickinfo" style="display:none"></div>
</div>
<div id="right" class="panel">
  <h2>Frame time (ms)</h2><canvas id="spark" height="60"></canvas>
  <div id="statline" class="dim"></div>
  <h2>Per-pass timings</h2>
  <button onclick="reqProfile()">Profile passes</button>
  <div id="passes"></div>
  <h2>Render graph</h2>
  <button onclick="toggleGraph()">Show DOT</button>
  <pre id="graph" style="display:none"></pre>
  <h2>Gizmo</h2>
  <div id="gizmo" class="dim">pick an instance to manipulate</div>
  <h2>Materials</h2>
  <div id="materials"></div>
  <h2>Log</h2>
  <pre id="log" style="max-height:140px"></pre>
  <h2>Session</h2>
  <button onclick="hotReload()">Hot reload ops</button>
  <button onclick="fetch('/api/quit',{method:'POST',body:'{}'})">Quit</button>
  <div id="reloadinfo" class="dim"></div>
</div>
<script>
const $ = s => document.querySelector(s);
let W = 512, H = 512;

function setParam(path, value) {
  fetch('/api/set', {method:'POST', body: JSON.stringify({path, value})});
}

function control(p) {
  const row = document.createElement('div'); row.className = 'row';
  const lab = document.createElement('label');
  lab.textContent = p.name; lab.title = p.path; row.appendChild(lab);
  if (p.kind === 'bool') {
    const c = document.createElement('input'); c.type = 'checkbox';
    c.checked = p.value; c.onchange = () => setParam(p.path, c.checked);
    row.appendChild(c);
  } else if (p.kind === 'enum') {
    const s = document.createElement('select');
    for (const ch of p.choices) {
      const o = document.createElement('option');
      o.value = ch; o.textContent = ch; o.selected = ch === p.value;
      s.appendChild(o);
    }
    s.onchange = () => setParam(p.path, s.value);
    row.appendChild(s);
  } else if (p.kind === 'float' || p.kind === 'int') {
    const n = document.createElement('input'); n.type = 'number';
    n.value = p.value;
    if (p.step != null) n.step = p.step;
    else n.step = p.kind === 'int' ? 1 : 0.05;
    if (p.min != null && p.max != null) {
      const r = document.createElement('input'); r.type = 'range';
      r.min = p.min; r.max = p.max; r.step = n.step; r.value = p.value;
      r.oninput = () => { n.value = r.value; };
      r.onchange = () => setParam(p.path, parseFloat(r.value));
      row.appendChild(r);
    }
    n.onchange = () => setParam(p.path, parseFloat(n.value));
    row.appendChild(n);
  } else { // float3 / color3 / unitdir
    for (let i = 0; i < 3; i++) {
      const n = document.createElement('input'); n.type = 'number';
      n.step = 0.05; n.value = p.value[i];
      n.onchange = () => {
        const v = [...row.querySelectorAll('input')].map(x => parseFloat(x.value));
        setParam(p.path, v);
      };
      row.appendChild(n);
    }
  }
  return row;
}

async function loadParams() {
  const ps = await (await fetch('/api/params')).json();
  const root = $('#params'); root.innerHTML = '';
  const groups = {};
  for (const p of ps) {
    (groups[p.group] ??= {})[p.subgroup] ??= [];
    groups[p.group][p.subgroup].push(p);
  }
  for (const g of Object.keys(groups).sort()) {
    const h = document.createElement('h2'); h.textContent = g;
    const body = document.createElement('div'); body.className = 'sub';
    h.onclick = () => { h.classList.toggle('closed');
                        body.style.display = body.style.display === 'none' ? '' : 'none'; };
    root.appendChild(h); root.appendChild(body);
    for (const sg of Object.keys(groups[g]).sort()) {
      if (sg) { const s = document.createElement('div');
                s.className = 'dim'; s.textContent = sg; body.appendChild(s); }
      for (const p of groups[g][sg]) body.appendChild(control(p));
    }
  }
}

let lastIdx = -1;
async function pollFrame() {
  try {
    const r = await fetch('/frame.png?' + Date.now());
    if (r.ok) {
      const idx = r.headers.get('X-Frame-Index');
      if (idx !== lastIdx) {
        lastIdx = idx;
        const b = await r.blob();
        const url = URL.createObjectURL(b);
        const v = $('#viewport');
        const old = v.src; v.src = url;
        if (old) URL.revokeObjectURL(old);
      }
    }
  } catch (e) {}
  setTimeout(pollFrame, 250);
}

async function pollStats() {
  try {
    const s = await (await fetch('/api/stats')).json();
    W = s.width || W; H = s.height || H;
    $('#hud').textContent =
      `${s.mode}  ${s.width}x${s.height}  ${(s.frame_ms||0).toFixed(1)} ms  ` +
      `${(s.fps||0).toFixed(1)} fps  frame ${s.frame_index}`;
    $('#statline').textContent =
      `${s.tris} tris, ${s.emissives} emissive  eye [${(s.eye||[]).join(', ')}]`;
    spark(s.history_ms || []);
  } catch (e) {}
  setTimeout(pollStats, 1000);
}

function spark(hist) {
  const c = $('#spark'), ctx = c.getContext('2d');
  c.width = c.clientWidth;
  ctx.clearRect(0, 0, c.width, c.height);
  if (!hist.length) return;
  const max = Math.max(...hist) * 1.15 || 1;
  ctx.strokeStyle = '#4c8dff'; ctx.beginPath();
  hist.forEach((v, i) => {
    const x = i / Math.max(hist.length - 1, 1) * (c.width - 2) + 1;
    const y = c.height - 2 - v / max * (c.height - 6);
    i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
  });
  ctx.stroke();
  ctx.fillStyle = '#8a90a0'; ctx.font = '10px sans-serif';
  ctx.fillText(max.toFixed(0) + ' ms', 4, 10);
}

async function reqProfile() {
  $('#passes').innerHTML = '<span class="dim">profiling…</span>';
  await fetch('/api/profile', {method:'POST', body:'{}'});
  const poll = async () => {
    const t = await (await fetch('/api/pass_times')).json();
    if (!Object.keys(t).length) return setTimeout(poll, 1500);
    const tab = document.createElement('table');
    for (const [k, v] of Object.entries(t)) {
      const tr = tab.insertRow();
      tr.insertCell().textContent = k;
      tr.insertCell().textContent = (+v).toFixed(2);
    }
    $('#passes').innerHTML = ''; $('#passes').appendChild(tab);
  };
  setTimeout(poll, 1500);
}

async function hotReload() {
  $('#reloadinfo').textContent = 'reloading + re-jitting…';
  await fetch('/api/reload', {method:'POST', body:'{}'});
  setTimeout(async () => {
    const r = await (await fetch('/api/reload_result')).json();
    $('#reloadinfo').textContent = `reloaded ${r.reloaded.length} modules`;
  }, 2500);
}

async function toggleGraph() {
  const g = $('#graph');
  if (g.style.display === 'none') {
    g.textContent = (await (await fetch('/api/graph')).json()).dot;
    g.style.display = '';
  } else g.style.display = 'none';
}

// viewport input: click = pick, drag = orbit, wheel = dolly
const vp = $('#viewport');
let drag = null, moved = false;
vp.onmousedown = e => { drag = [e.clientX, e.clientY]; moved = false; };
window.onmouseup = async e => {
  if (!drag) return;
  if (!moved) {
    const r = vp.getBoundingClientRect();
    const x = Math.round((e.clientX - r.left) / r.width * W);
    const y = Math.round((e.clientY - r.top) / r.height * H);
    await fetch('/api/pick', {method:'POST', body: JSON.stringify({x, y})});
    setTimeout(async () => {
      const p = await (await fetch('/api/pick')).json();
      const el = $('#pickinfo');
      el.style.display = '';
      el.textContent = p.hit
        ? `picked ${p.instance_name || '#' + p.instance} (mat ${p.material}, t=${(+p.t).toFixed(3)})`
        : 'picked: miss';
      pickedInst = p.hit ? p.instance : -1;
      gizmoUI();
    }, 600);
  }
  drag = null;
};
window.onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (Math.abs(dx) + Math.abs(dy) > 2) moved = true; else return;
  drag = [e.clientX, e.clientY];
  fetch('/api/camera', {method:'POST',
    body: JSON.stringify({dyaw: -dx * 0.008, dpitch: dy * 0.008})});
};
vp.onwheel = e => {
  e.preventDefault();
  fetch('/api/camera', {method:'POST',
    body: JSON.stringify({ddolly: e.deltaY > 0 ? 0.12 : -0.12})});
};

// -- gizmo (ImGuizmo-analog: axis nudges + rotate + scale on the picked
// instance; POST /api/transform -> scene refit)
let pickedInst = -1;
function xform(body) {
  body.instance = pickedInst;
  fetch('/api/transform', {method:'POST', body: JSON.stringify(body)});
}
function gizmoUI() {
  const g = $('#gizmo');
  if (pickedInst < 0) { g.className = 'dim';
    g.textContent = 'pick an instance to manipulate'; return; }
  g.className = ''; g.innerHTML = '';
  const step = 0.1;
  const rows = [
    ['move X', () => xform({translate:[step,0,0]}), () => xform({translate:[-step,0,0]})],
    ['move Y', () => xform({translate:[0,step,0]}), () => xform({translate:[0,-step,0]})],
    ['move Z', () => xform({translate:[0,0,step]}), () => xform({translate:[0,0,-step]})],
    ['rot Y', () => xform({rotate_y:0.26}), () => xform({rotate_y:-0.26})],
    ['scale', () => xform({scale:1.1}), () => xform({scale:1/1.1})],
  ];
  const hdr = document.createElement('div');
  hdr.textContent = `instance #${pickedInst}`; g.appendChild(hdr);
  for (const [name, plus, minus] of rows) {
    const row = document.createElement('div'); row.className = 'row';
    const lab = document.createElement('label'); lab.textContent = name;
    const bm = document.createElement('button'); bm.textContent = '−'; bm.onclick = minus;
    const bp = document.createElement('button'); bp.textContent = '+'; bp.onclick = plus;
    row.append(lab, bm, bp); g.appendChild(row);
  }
}

// -- material editor (reference: GuiPass material panel)
async function loadMaterials() {
  const ms = await (await fetch('/api/materials')).json();
  const root = $('#materials'); root.innerHTML = '';
  const setMat = (index, field, value) =>
    fetch('/api/material', {method:'POST',
      body: JSON.stringify({index, field, value})});
  for (const m of ms) {
    const h = document.createElement('div'); h.className = 'dim';
    h.textContent = `material ${m.index}`; root.appendChild(h);
    for (const f of ['metallic', 'roughness', 'transmission', 'coat_weight']) {
      const row = document.createElement('div'); row.className = 'row';
      const lab = document.createElement('label'); lab.textContent = f;
      const r = document.createElement('input'); r.type = 'range';
      r.min = 0; r.max = 1; r.step = 0.02; r.value = m[f];
      r.onchange = () => setMat(m.index, f, parseFloat(r.value));
      row.append(lab, r); root.appendChild(row);
    }
    const row = document.createElement('div'); row.className = 'row';
    const lab = document.createElement('label'); lab.textContent = 'base color';
    row.appendChild(lab);
    const col = document.createElement('input'); col.type = 'color';
    const hex = v => Math.round(Math.pow(Math.min(Math.max(v,0),1), 1/2.2) * 255)
      .toString(16).padStart(2, '0');
    col.value = '#' + m.base_color.map(hex).join('');
    col.onchange = () => {
      const c = col.value;
      const lin = s => Math.pow(parseInt(s, 16) / 255, 2.2);
      setMat(m.index, 'base_color',
             [lin(c.slice(1,3)), lin(c.slice(3,5)), lin(c.slice(5,7))]);
    };
    row.appendChild(col); root.appendChild(row);
  }
}

// -- log window (reference: GuiPass log dock)
async function pollLog() {
  try {
    const l = await (await fetch('/api/log')).json();
    const el = $('#log');
    el.textContent = (l.log || []).slice(-40)
      .map(e => `[${e[1]}] ${e[2]}`).join('\n');
    el.scrollTop = el.scrollHeight;
  } catch (e) {}
  setTimeout(pollLog, 2000);
}

loadParams(); pollFrame(); pollStats(); loadMaterials(); pollLog(); gizmoUI();
</script>
</body></html>
"""
