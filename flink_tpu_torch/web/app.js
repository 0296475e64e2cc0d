/* flink_tpu dashboard SPA (reference: flink-runtime-web/web-dashboard).
   Hash-routed views over the REST surface; no dependencies. */
"use strict";

const $view = document.getElementById("view");
let timer = null;          // per-view auto-refresh
let navSeq = 0;            // navigation token: stale renders must not land
const sparkHistory = {};   // metric -> ring of recent values (client-side)

function renderGate() {
  // capture at render start; check before writing $view — an await that
  // resolves after the user navigated away must not clobber the new view
  const seq = navSeq;
  return () => seq === navSeq;
}
function editingInView() {
  const el = document.activeElement;
  return el && $view.contains(el) &&
    /INPUT|TEXTAREA|SELECT/.test(el.tagName);
}

function esc(x) {
  return String(x).replace(/[&<>"']/g, c => ({
    "&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;",
  }[c]));
}
async function getJSON(path) {
  const r = await fetch(path);
  if (!r.ok) throw new Error(`${path}: HTTP ${r.status}`);
  return r.json();
}
async function postJSON(path, body) {
  const r = await fetch(path, { method: "POST", body: JSON.stringify(body || {}) });
  return r.json().catch(() => ({}));
}
function fmt(n) {
  if (typeof n !== "number" || !isFinite(n)) return esc(n);
  if (Number.isInteger(n)) return n.toLocaleString("en-US");
  return n.toLocaleString("en-US", { maximumFractionDigits: 3 });
}
function pill(status) {
  return `<span class="pill ${esc(status)}">${esc(status)}</span>`;
}
function setNav(name) {
  document.querySelectorAll("[data-nav]").forEach(a =>
    a.classList.toggle("active", a.dataset.nav === name));
}
function refreshEvery(ms, fn) {
  clearInterval(timer);
  timer = setInterval(fn, ms);
}

/* ---------------------------------------------------------- overview */

async function viewOverview() {
  setNav("overview");
  const render = async () => {
    const live = renderGate();
    const [ov, jobs] = await Promise.all([
      getJSON("/overview"), getJSON("/jobs")]);
    if (!live()) return;
    document.getElementById("version").textContent =
      "v" + (ov.flink_tpu_version || "?");
    const counts = ov.jobs || {};
    $view.innerHTML = `
      <h1>Cluster overview</h1>
      <div class="tiles">
        <div class="tile"><div class="label">Task executors</div>
          <div class="value">${fmt(ov.taskexecutors)}</div></div>
        <div class="tile"><div class="label">Slots</div>
          <div class="value">${fmt(ov.slots_total)}</div></div>
        <div class="tile"><div class="label">Running jobs</div>
          <div class="value">${fmt(counts.RUNNING || 0)}</div>
          <div class="sub">${fmt(counts.FINISHED || 0)} finished ·
            ${fmt(counts.FAILED || 0)} failed</div></div>
      </div>
      <h2>Jobs</h2>
      ${jobsTable(jobs.jobs || [])}`;
    bindJobRows();
  };
  await render();
  refreshEvery(2000, render);
}

function jobsTable(jobs) {
  if (!jobs.length) return `<p class="hint">No jobs submitted yet.</p>`;
  const rows = jobs.map(j => `
    <tr class="click" data-job="${esc(j.job_id)}">
      <td><code>${esc(j.job_id)}</code></td>
      <td>${esc(j.name || "")}</td>
      <td>${pill(j.status)}</td>
      <td class="num">${fmt(j.attempt ?? 0)}</td>
      <td>${esc(j.error || "")}</td>
    </tr>`).join("");
  return `<table><thead><tr><th>ID</th><th>Name</th><th>Status</th>
    <th class="num">Attempt</th><th>Error</th></tr></thead>
    <tbody>${rows}</tbody></table>`;
}
function bindJobRows() {
  document.querySelectorAll("tr[data-job]").forEach(tr =>
    tr.addEventListener("click",
      () => { location.hash = `#/jobs/${tr.dataset.job}`; }));
}

/* --------------------------------------------------------- executors */

async function viewExecutors() {
  setNav("executors");
  const render = async () => {
    const live = renderGate();
    const data = await getJSON("/taskexecutors");
    if (!live()) return;
    // in-process executors seed from heartbeat() ({id, slots_total,
    // slots_free}); remote ones from the RM registry ({executor_id,
    // slots, allocated, address}) — accept both shapes
    const rows = (data.executors || []).map(e => `
      <tr><td><code>${esc(e.executor_id || e.id || "")}</code></td>
        <td>${esc(e.address || "in-process")}</td>
        <td class="num">${fmt(e.slots ?? e.slots_total ?? "")}</td>
        <td class="num">${fmt(e.allocated ??
          (e.slots_total !== undefined
            ? e.slots_total - e.slots_free : ""))}</td>
        <td class="num">${fmt(e.heartbeat_age_s ?? "")}</td></tr>`).join("");
    $view.innerHTML = `
      <h1>Task executors</h1>
      <table><thead><tr><th>ID</th><th>Address</th><th class="num">Slots</th>
        <th class="num">Allocated</th><th class="num">Heartbeat age (s)</th>
        </tr></thead><tbody>${rows}</tbody></table>`;
  };
  await render();
  refreshEvery(3000, render);
}

/* --------------------------------------------------------- job detail */

async function viewJob(jobId) {
  setNav("");
  const render = async () => {
    const live = renderGate();
    if (editingInView()) return;  // don't destroy a focused form
    let job, plan, metrics;
    try {
      [job, plan, metrics] = await Promise.all([
        getJSON(`/jobs/${jobId}`),
        getJSON(`/jobs/${jobId}/plan`).catch(() => null),
        getJSON(`/jobs/${jobId}/metrics`).catch(() => null)]);
    } catch (e) {
      if (live()) $view.innerHTML =
        `<p class="error">${esc(e.message)}</p>`;
      return;
    }
    if (!live() || editingInView()) return;
    // flatten the metrics payload ONCE; both panels read the same map
    const flatMetrics = flattenMetrics(metrics);
    const hist = job.state_history || [];
    const started = hist.length ? hist[0].ts : null;
    const uptime = started ? ((Date.now() / 1000) - started) : null;
    $view.innerHTML = `
      <h1><code>${esc(jobId)}</code> ${esc(job.name || "")}
          ${pill(job.status)}</h1>
      <div class="tiles">
        <div class="tile"><div class="label">Attempt</div>
          <div class="value">${fmt(job.attempt ?? 0)}</div></div>
        ${uptime !== null && job.status === "RUNNING" ? `
        <div class="tile"><div class="label">Uptime</div>
          <div class="value">${fmt(Math.round(uptime))}s</div></div>` : ""}
      </div>
      <div class="formrow">
        <a href="#/jobs/${esc(jobId)}/flamegraph"><button>Flame graph</button></a>
        <a href="#/jobs/${esc(jobId)}/state"><button>Queryable state</button></a>
        <button id="do-savepoint">Trigger savepoint</button>
        <input id="savepoint-path" placeholder="savepoint path"
               value="/tmp/flink-tpu-savepoints/${esc(jobId)}">
        <button class="danger" id="do-cancel">Cancel job</button>
        <span id="action-out" class="hint"></span>
      </div>
      <h2>Job plan</h2>
      ${plan && plan.plan ? renderDag(plan.plan) :
        `<p class="hint">plan unavailable</p>`}
      ${renderLatencyPanel(flatMetrics)}
      <h2>Metrics</h2>
      ${renderMetrics(jobId, metrics, flatMetrics)}
      ${job.error ? `<h2>Error</h2>
        <pre class="block error">${esc(job.error)}</pre>` : ""}
      <h2>State history</h2>
      <table><thead><tr><th>State</th><th>At</th></tr></thead><tbody>
      ${hist.map(h => `<tr><td>${pill(h.state)}</td>
        <td>${new Date(h.ts * 1000).toISOString()}</td></tr>`).join("")}
      </tbody></table>`;
    document.getElementById("do-cancel").onclick = async () => {
      const out = await postJSON(`/jobs/${jobId}/cancel`);
      document.getElementById("action-out").textContent =
        JSON.stringify(out);
    };
    document.getElementById("do-savepoint").onclick = async () => {
      const target = document.getElementById("savepoint-path").value;
      const out = await postJSON(`/jobs/${jobId}/savepoints`, { target });
      document.getElementById("action-out").textContent =
        JSON.stringify(out);
    };
  };
  await render();
  refreshEvery(3000, render);
}

/* job plan: layered DAG in SVG (longest-path layering, per-layer rows) */
function renderDag(plan) {
  const nodes = plan.nodes || [], edges = plan.edges || [];
  if (!nodes.length) return `<p class="hint">empty plan</p>`;
  const layer = {};
  const incoming = {};
  edges.forEach(e => { (incoming[e.target] ||= []).push(e.source); });
  const depth = id => {
    if (layer[id] !== undefined) return layer[id];
    layer[id] = 0; // cycle guard
    const ins = incoming[id] || [];
    layer[id] = ins.length ? 1 + Math.max(...ins.map(depth)) : 0;
    return layer[id];
  };
  nodes.forEach(n => depth(n.id));
  const cols = {};
  nodes.forEach(n => { (cols[layer[n.id]] ||= []).push(n); });
  const W = 190, H = 64, GX = 80, GY = 22;
  const pos = {};
  Object.entries(cols).forEach(([l, ns]) => ns.forEach((n, i) => {
    pos[n.id] = { x: l * (W + GX) + 10, y: i * (H + GY) + 28 };
  }));
  const width = (Math.max(...nodes.map(n => layer[n.id])) + 1) * (W + GX);
  const height = Math.max(...Object.values(pos).map(p => p.y)) + H + 20;
  const boxes = nodes.map(n => {
    const p = pos[n.id];
    const ops = (n.operators || []).join(" → ");
    return `<g>
      <rect class="vertex" x="${p.x}" y="${p.y}" width="${W}" height="${H}"/>
      <text x="${p.x + 9}" y="${p.y + 20}">${esc(trunc(n.description, 24))}</text>
      <text class="sub" x="${p.x + 9}" y="${p.y + 37}">${esc(trunc(ops, 30))}</text>
      <text class="sub" x="${p.x + 9}" y="${p.y + 53}">parallelism ${fmt(n.parallelism)}</text>
    </g>`;
  }).join("");
  const lines = edges.map(e => {
    const a = pos[e.source], b = pos[e.target];
    if (!a || !b) return "";
    const x1 = a.x + W, y1 = a.y + H / 2, x2 = b.x, y2 = b.y + H / 2;
    const mx = (x1 + x2) / 2;
    const label = e.ship_strategy +
      (e.key_field ? `(${e.key_field})` : "");
    return `<path class="edge" marker-end="url(#arrow)"
        d="M${x1},${y1} C${mx},${y1} ${mx},${y2} ${x2},${y2}"/>
      <text class="ship" x="${mx}" y="${Math.min(y1, y2) - 5}"
        text-anchor="middle">${esc(label)}</text>`;
  }).join("");
  return `<div class="dag"><svg width="${width}" height="${height}">
    <defs><marker id="arrow" viewBox="0 0 8 8" refX="7" refY="4"
      markerWidth="7" markerHeight="7" orient="auto">
      <path d="M0,0 L8,4 L0,8 z" fill="currentColor" opacity=".55"/>
    </marker></defs>${lines}${boxes}</svg></div>`;
}
function trunc(s, n) { s = String(s || ""); return s.length > n ? s.slice(0, n - 1) + "…" : s; }

function flattenMetrics(payload) {
  const flat = {};
  if (!payload || !payload.metrics) return flat;
  (function walk(obj, prefix) {
    Object.entries(obj).forEach(([k, v]) => {
      const name = prefix ? `${prefix}.${k}` : k;
      if (v && typeof v === "object" && !Array.isArray(v)) walk(v, name);
      else flat[name] = v;
    });
  })(payload.metrics, "");
  return flat;
}

/* latency panel: per-operator fire p50/p99 (the latency-tier signal),
   watermark lag vs the sources' frontier and LatencyMarker p99 —
   pulled from the .window / .latency metric groups the executor
   registers, same reservoirs the tier-1 fire-p99 gate reads */
function renderLatencyPanel(flat) {
  const ops = {};
  Object.entries(flat).forEach(([k, v]) => {
    let m = k.match(/^(.*)\.window\.(fireLatencyP50Ms|fireLatencyP99Ms|fireCount)$/);
    if (m) { (ops[m[1]] ||= {})[m[2]] = v; return; }
    m = k.match(/^(.*)\.latency\.(watermarkLagMs)$/);
    if (m) { (ops[m[1]] ||= {})[m[2]] = v; return; }
    m = k.match(/^(.*)\.latency\.markerLatencyMs\.(p99)$/);
    if (m) (ops[m[1]] ||= {})["markerP99"] = v;
  });
  const names = Object.keys(ops).filter(op =>
    Object.keys(ops[op]).length);
  if (!names.length) return "";
  const rows = names.sort().map(op => {
    const d = ops[op];
    const short = op.split(".").pop();
    return `<tr><td title="${esc(op)}">${esc(short)}</td>
      <td class="num">${fmt(d.fireLatencyP50Ms ?? "")}</td>
      <td class="num">${fmt(d.fireLatencyP99Ms ?? "")}</td>
      <td class="num">${fmt(d.fireCount ?? "")}</td>
      <td class="num">${fmt(d.watermarkLagMs ?? "")}</td>
      <td class="num">${fmt(d.markerP99 ?? "")}</td></tr>`;
  }).join("");
  return `<h2>Latency</h2>
    <table><thead><tr><th>Operator</th>
      <th class="num">Fire p50 (ms)</th><th class="num">Fire p99 (ms)</th>
      <th class="num">Fires</th><th class="num">Watermark lag (ms)</th>
      <th class="num">Marker p99 (ms)</th></tr></thead>
    <tbody>${rows}</tbody></table>`;
}

/* metrics: numeric leaves as sparkline cards (history accumulates while
   the view is open), non-numeric in a table */
function renderMetrics(jobId, payload, flat) {
  if (!payload || !payload.metrics ||
      !Object.keys(payload.metrics).length) {
    return `<p class="hint">${esc(payload && payload.note ||
      "no metrics yet")}</p>`;
  }
  flat = flat || flattenMetrics(payload);
  const numeric = [], other = [];
  Object.entries(flat).forEach(([k, v]) =>
    (typeof v === "number" ? numeric : other).push([k, v]));
  numeric.forEach(([k, v]) => {
    const key = `${jobId}:${k}`;
    const ring = sparkHistory[key] ||= [];
    if (!ring.length || ring[ring.length - 1] !== v) ring.push(v);
    if (ring.length > 60) ring.shift();
  });
  const cards = numeric.slice(0, 24).map(([k, v]) => {
    const ring = sparkHistory[`${jobId}:${k}`] || [v];
    return `<div class="spark"><div class="label"
      title="${esc(k)}">${esc(k)}</div>
      <div class="value">${fmt(v)}</div>${sparkline(ring)}</div>`;
  }).join("");
  const rows = other.map(([k, v]) => `<tr><td>${esc(k)}</td>
    <td>${esc(JSON.stringify(v))}</td></tr>`).join("");
  return `<div class="sparkgrid">${cards}</div>
    ${rows ? `<h2>Other metrics</h2><table><tbody>${rows}</tbody></table>` : ""}`;
}
function sparkline(values) {
  if (values.length < 2) return `<svg viewBox="0 0 100 34"></svg>`;
  const lo = Math.min(...values), hi = Math.max(...values);
  const span = hi - lo || 1;
  const pts = values.map((v, i) =>
    `${(i / (values.length - 1)) * 98 + 1},${31 - ((v - lo) / span) * 28}`);
  return `<svg viewBox="0 0 100 34" preserveAspectRatio="none">
    <polyline points="${pts.join(" ")}"/></svg>`;
}

/* --------------------------------------------------------- flamegraph */

async function viewFlame(jobId) {
  setNav(jobId ? "" : "flamegraph");
  const path = jobId ? `/jobs/${jobId}/flamegraph?duration_ms=400`
                     : `/flamegraph?duration_ms=400&all=1`;
  $view.innerHTML = `<h1>Flame graph${jobId ?
    ` — <code>${esc(jobId)}</code>` : " — cluster"}</h1>
    <p class="hint">sampling 400 ms…</p>`;
  const live = renderGate();
  let data;
  try { data = await getJSON(path); }
  catch (e) {
    if (live()) $view.innerHTML += `<p class="error">${esc(e.message)}</p>`;
    return;
  }
  if (!live()) return;
  const total = data.samples || (data.root && data.root.value) || 1;
  const root = data.root || data;
  $view.innerHTML = `
    <h1>Flame graph${jobId ? ` — <code>${esc(jobId)}</code>` : " — cluster"}</h1>
    <p class="hint">${fmt(data.samples || 0)} samples ·
      widths are sample share · hover for counts</p>
    <div class="flame">${flameRow(root, total, 0)}</div>`;
}
function flameRow(node, total, depth) {
  const kids = node.children || [];
  const width = Math.max((node.value / total) * 100, 0.4);
  const ramp = ["--seq-1", "--seq-2", "--seq-3", "--seq-4", "--seq-5"];
  const color = `var(${ramp[Math.min(depth, ramp.length - 1)]})`;
  const ink = depth >= 3 ? "color: var(--surface-1);" : "";
  const self = depth === 0 ? "" :
    `<div class="frame" style="width:${width}%;background:${color};${ink}"
      title="${esc(node.name)} — ${fmt(node.value)} samples">
      ${esc(node.name)}</div>`;
  const childBlobs = kids
    .slice().sort((a, b) => b.value - a.value)
    .map(c => `<div style="display:inline-block;vertical-align:top;
       width:${(c.value / Math.max(node.value, 1)) * 100}%">
       ${flameRow(c, total, depth + 1)}</div>`).join("");
  return `${self}<div class="row">${childBlobs}</div>`;
}

/* ------------------------------------------------------ queryable state */

async function viewState(jobId) {
  setNav("");
  $view.innerHTML = `
    <h1>Queryable state — <code>${esc(jobId)}</code></h1>
    <div class="formrow">
      <input id="qs-op" placeholder="operator name">
      <input id="qs-key" placeholder="key">
      <input id="qs-ns" placeholder="namespace (optional)">
      <button id="qs-go">Look up</button>
    </div>
    <pre class="block" id="qs-out">results appear here</pre>`;
  document.getElementById("qs-go").onclick = async () => {
    const op = document.getElementById("qs-op").value;
    const key = encodeURIComponent(document.getElementById("qs-key").value);
    const ns = document.getElementById("qs-ns").value;
    const url = `/jobs/${jobId}/state/${encodeURIComponent(op)}?key=${key}` +
      (ns ? `&namespace=${encodeURIComponent(ns)}` : "");
    try {
      const out = await getJSON(url);
      document.getElementById("qs-out").textContent =
        JSON.stringify(out, null, 2);
    } catch (e) {
      document.getElementById("qs-out").textContent = e.message;
    }
  };
}

/* ------------------------------------------------------------- router */

function route() {
  navSeq += 1;
  clearInterval(timer);
  const h = location.hash.replace(/^#\/?/, "");
  const parts = h.split("/").filter(Boolean);
  if (!parts.length || parts[0] === "overview") return viewOverview();
  if (parts[0] === "executors") return viewExecutors();
  if (parts[0] === "flamegraph") return viewFlame(null);
  if (parts[0] === "jobs" && parts.length >= 2) {
    const jobId = parts[1];
    if (parts[2] === "flamegraph") return viewFlame(jobId);
    if (parts[2] === "state") return viewState(jobId);
    return viewJob(jobId);
  }
  $view.innerHTML = `<p class="error">unknown route: ${esc(h)}</p>`;
}
window.addEventListener("hashchange", route);
route();
