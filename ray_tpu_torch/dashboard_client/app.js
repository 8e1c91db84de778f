/* ray_tpu_torch dashboard SPA (ref role: python/ray/dashboard/client/src — the
 * React app's views, re-done as a dependency-free hash router + render
 * functions over the JSON state API). */
"use strict";

const $ = (sel) => document.querySelector(sel);
const main = $("#main");

function esc(v) {
  return String(v ?? "").replace(/[&<>"']/g,
    (c) => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[c]));
}
function short(id, n = 12) { return String(id || "").slice(0, n); }
function fmtBytes(n) {
  if (n == null) return "";
  const u = ["B", "KB", "MB", "GB", "TB"];
  let i = 0; n = Number(n);
  while (n >= 1024 && i < u.length - 1) { n /= 1024; i++; }
  return n.toFixed(n >= 100 || i === 0 ? 0 : 1) + " " + u[i];
}
function fmtDur(s) {
  if (s == null) return "";
  if (s < 1) return (s * 1000).toFixed(1) + "ms";
  if (s < 120) return s.toFixed(2) + "s";
  return (s / 60).toFixed(1) + "m";
}
function fmtTs(t) { return t ? new Date(t * 1000).toLocaleTimeString() : ""; }

async function fetchJSON(url, opts) {
  const r = await fetch(url, opts);
  if (!r.ok) throw new Error(url + " -> " + r.status);
  return r.json();
}

/* ---- sortable tables ------------------------------------------------- */
const sortState = {};  // view:col -> dir
function table(viewKey, cols, rows, onRow) {
  // cols: [{k, label, fmt?, cls?, raw?}]
  const key = sortState[viewKey];
  if (key) {
    const [col, dir] = key;
    const c = cols.find((c) => c.k === col);
    if (c) rows = [...rows].sort((a, b) => {
      const x = a[col], y = b[col];
      const r = x == null ? -1 : y == null ? 1 : x < y ? -1 : x > y ? 1 : 0;
      return dir === "asc" ? r : -r;
    });
  }
  let h = `<table data-view="${viewKey}"><tr>`;
  for (const c of cols) {
    const cls = key && key[0] === c.k ? `sorted-${key[1]}` : "";
    h += `<th data-col="${c.k}" class="${cls}">${esc(c.label)}</th>`;
  }
  h += "</tr>";
  rows.forEach((row, i) => {
    h += `<tr class="${onRow ? "clickable" : ""}" data-i="${i}">`;
    for (const c of cols) {
      const v = c.fmt ? c.fmt(row[c.k], row) : esc(row[c.k]);
      const cls = c.cls ? c.cls(row[c.k], row) : "";
      h += `<td class="${cls}">${v}</td>`;
    }
    h += "</tr>";
  });
  h += "</table>";
  return { html: h, rows, onRow };
}
function wireTable(container, t) {
  container.querySelectorAll("th[data-col]").forEach((th) => {
    th.onclick = () => {
      const view = th.closest("table").dataset.view;
      const col = th.dataset.col;
      const cur = sortState[view];
      sortState[view] = [col, cur && cur[0] === col && cur[1] === "desc" ? "asc" : "desc"];
      render();
    };
  });
  if (t && t.onRow) {
    container.querySelectorAll("tr.clickable").forEach((tr) => {
      tr.onclick = () => t.onRow(t.rows[Number(tr.dataset.i)]);
    });
  }
}

/* ---- metric history for sparklines ----------------------------------- */
const history = {};  // name|tag -> [values]
let latestMetrics = {};  // last /api/metrics payload (fetched once per render)
// structured samples ({tags:{...}, value|counts/sum}) -> [label, sample]
function metricSamples(m) {
  return (m.samples || []).map((s) => [
    Object.entries(s.tags || {}).map(([k, v]) => `${k}=${v}`).join(","), s]);
}
function pushHistory(name, tag, v) {
  const k = name + "|" + tag;
  (history[k] = history[k] || []).push(Number(v) || 0);
  if (history[k].length > 60) history[k].shift();
}
function spark(values, w = 120, h = 22) {
  if (!values || values.length < 2) return "";
  const min = Math.min(...values), max = Math.max(...values);
  const span = max - min || 1;
  const pts = values.map((v, i) =>
    `${(i / (values.length - 1) * w).toFixed(1)},${(h - 2 - (v - min) / span * (h - 4)).toFixed(1)}`);
  return `<svg class="spark" width="${w}" height="${h}">` +
    `<polyline fill="none" stroke="#6fd3c7" stroke-width="1.5" points="${pts.join(" ")}"/></svg>`;
}

/* ---- views ----------------------------------------------------------- */
// /api/summary/tasks returns {task_name: {state: count}}; flatten to
// {state: count} for the cards and the state filter.
function byState(summary) {
  const out = {};
  for (const states of Object.values(summary || {}))
    for (const [st, n] of Object.entries(states)) out[st] = (out[st] || 0) + n;
  return out;
}

const views = {};
let detail = null;  // {view, render: async () => html} overlay state

views.overview = async () => {
  const [nodes, summary, actors, objects] = await Promise.all([
    fetchJSON("/api/cluster"), fetchJSON("/api/summary/tasks"),
    fetchJSON("/api/actors"), fetchJSON("/api/objects"),
  ]);
  const metrics = latestMetrics;  // render() preamble already fetched it
  const alive = nodes.filter((n) => n.alive).length;
  const actorsAlive = actors.filter((a) => a.state === "ALIVE").length;
  const st = byState(summary);
  let h = `<h1>Cluster overview</h1><div class="cards">`;
  h += `<div class="card"><div class="v">${alive}/${nodes.length}</div><div class="k">nodes alive</div></div>`;
  h += `<div class="card"><div class="v">${actorsAlive}/${actors.length}</div><div class="k">actors alive</div></div>`;
  for (const k of ["RUNNING", "FINISHED", "FAILED", "PENDING"]) {
    if (st[k] != null)
      h += `<div class="card"><div class="v ${k === "FAILED" && st[k] ? "bad" : ""}">${st[k]}</div><div class="k">tasks ${k.toLowerCase()}</div></div>`;
  }
  h += `<div class="card"><div class="v">${objects.length}</div><div class="k">shm objects</div></div>`;
  h += `</div><h2>Resources</h2>`;
  for (const n of nodes) {
    for (const [k, total] of Object.entries(n.resources_total || {})) {
      const avail = (n.resources_available || {})[k] ?? 0;
      const used = total - avail, pct = total ? used / total * 100 : 0;
      h += `<div style="display:flex;gap:10px;align-items:center;margin:3px 0">
        <span style="width:230px" class="dim">${short(n.node_id, 8)} ${esc(k)}</span>
        <span class="bar ${pct > 85 ? "hot" : ""}" style="width:200px"><i style="width:${pct}%"></i></span>
        <span>${used}/${total}</span></div>`;
    }
  }
  const failed = (await fetchJSON("/api/tasks")).filter((t) => t.state === "FAILED").slice(0, 10);
  if (failed.length) {
    h += `<h2>Recent failures</h2>`;
    h += table("ovfail", [
      {k: "name", label: "task"}, {k: "state", label: "state", cls: () => "bad"},
      {k: "error", label: "error", fmt: (v) => `<span class="wrap">${esc(short(v, 120))}</span>`},
    ], failed).html;
  }
  // a couple of headline metrics if exported
  const rates = Object.entries(metrics).filter(([k, m]) => m.type !== "histogram").slice(0, 6);
  if (rates.length) {
    h += `<h2>Metrics</h2>`;
    for (const [k, m] of rates)
      for (const [tag, s] of metricSamples(m))
        h += `<div><span class="dim" style="display:inline-block;width:340px">${esc(k)}${tag ? " " + esc(tag) : ""}</span> ${esc(s.value)} ${spark(history[k + "|" + tag])}</div>`;
  }
  return h;
};

views.nodes = async () => {
  const nodes = await fetchJSON("/api/cluster");
  let h = `<h1>Nodes</h1>`;
  const t = table("nodes", [
    {k: "node_id", label: "node", fmt: (v) => short(v)},
    {k: "alive", label: "alive", cls: (v) => v ? "ok" : "bad"},
    {k: "address", label: "address", fmt: (v) => esc(Array.isArray(v) ? v.join(":") : v)},
    {k: "resources_total", label: "resources", fmt: (v, r) =>
      esc(Object.entries(v || {}).map(([k, t]) =>
        `${k}:${(r.resources_available || {})[k] ?? 0}/${t}`).join(" "))},
    {k: "queued_leases", label: "queued"},
  ], nodes, (row) => showDetail("nodes", `Node ${short(row.node_id)}`, row));
  return { html: h + t.html, after: (el) => wireTable(el, t) };
};

views.actors = async () => {
  const actors = await fetchJSON("/api/actors");
  let h = `<h1>Actors</h1>`;
  const t = table("actors", [
    {k: "actor_id", label: "actor", fmt: (v) => short(v)},
    {k: "name", label: "name"},
    {k: "state", label: "state", cls: (v) => v === "ALIVE" ? "ok" : v === "DEAD" ? "bad" : "warn"},
    {k: "node_id", label: "node", fmt: (v) => short(v, 8)},
    {k: "address", label: "address", fmt: (v) => esc(Array.isArray(v) ? v.join(":") : v || "")},
    {k: "num_restarts", label: "restarts"},
    {k: "death_cause", label: "death cause", fmt: (v) => `<span class="bad">${esc(short(v, 60))}</span>`},
  ], actors, (row) => showDetail("actors", `Actor ${short(row.actor_id)}`, row));
  return { html: h + t.html, after: (el) => wireTable(el, t) };
};

let taskFilter = {state: "", q: ""};
views.tasks = async () => {
  const [tasks, summary] = await Promise.all([
    fetchJSON("/api/tasks"), fetchJSON("/api/summary/tasks")]);
  const st = byState(summary);
  let rows = tasks;
  if (taskFilter.state) rows = rows.filter((t) => t.state === taskFilter.state);
  if (taskFilter.q) rows = rows.filter((t) => (t.name || "").includes(taskFilter.q));
  let h = `<h1>Tasks</h1><div class="controls">
    <select id="tf-state"><option value="">all states</option>
      ${Object.keys(st).map((s) => `<option ${taskFilter.state === s ? "selected" : ""}>${esc(s)}</option>`).join("")}
    </select>
    <input type="text" id="tf-q" placeholder="filter by name" value="${esc(taskFilter.q)}">
    <span class="dim">${rows.length}/${tasks.length} · ${Object.entries(st).map(([k, v]) => k + ":" + v).join("  ")}</span>
  </div>`;
  const t = table("tasks", [
    {k: "task_id", label: "id", fmt: (v) => short(v)},
    {k: "name", label: "name"},
    {k: "state", label: "state", cls: (v) => v === "FAILED" ? "bad" : v === "RUNNING" ? "warn" : "ok"},
    {k: "node_id", label: "node", fmt: (v) => short(v, 8)},
    {k: "duration_s", label: "duration", fmt: fmtDur},
    {k: "start_time", label: "started", fmt: fmtTs},
  ], rows.slice(0, 500), (row) => showDetail("tasks", `Task ${short(row.task_id)}`, row));
  return { html: h + t.html, after: (el) => {
    wireTable(el, t);
    el.querySelector("#tf-state").onchange = (e) => { taskFilter.state = e.target.value; render(); };
    el.querySelector("#tf-q").onchange = (e) => { taskFilter.q = e.target.value; render(); };
  }};
};

views.objects = async () => {
  const objects = await fetchJSON("/api/objects");
  let h = `<h1>Objects</h1><div class="muted-note">${objects.length} objects in the shm object directory (owner-inlined values are not listed)</div>`;
  return h + table("objects", [
    {k: "object_id", label: "object", fmt: (v) => short(v, 20)},
    {k: "locations", label: "holders", fmt: (v) =>
      esc((v || []).map((x) => short(x, 10)).join(", "))},
  ], objects.slice(0, 500)).html;
};

views.pgs = async () => {
  const pgs = await fetchJSON("/api/placement_groups");
  return `<h1>Placement groups</h1>` + table("pgs", [
    {k: "pg_id", label: "pg", fmt: (v) => short(v)},
    {k: "strategy", label: "strategy"},
    {k: "state", label: "state", cls: (v) => v === "CREATED" ? "ok" : "warn"},
    {k: "bundles", label: "bundles", fmt: (v) => esc(JSON.stringify(v))},
    {k: "bundle_nodes", label: "nodes", fmt: (v) =>
      esc((v || []).map((x) => short(x, 8)).join(", "))},
  ], pgs).html;
};

let jobLogId = null;
views.jobs = async () => {
  const jobs = await fetchJSON("/api/jobs");
  let h = `<h1>Jobs</h1>`;
  const t = table("jobs", [
    {k: "job_id", label: "job"},
    {k: "entrypoint", label: "entrypoint", fmt: (v) => `<span class="wrap">${esc(short(v, 80))}</span>`},
    {k: "status", label: "status", cls: (v) => v === "SUCCEEDED" ? "ok" : v === "FAILED" ? "bad" : "warn"},
    {k: "start_time", label: "started", fmt: fmtTs},
    {k: "job_id2", label: "", fmt: (_, r) =>
      `<button data-logs="${esc(r.job_id)}">logs</button> ` +
      (r.status === "RUNNING" ? `<button data-stop="${esc(r.job_id)}">stop</button>` : "")},
  ], jobs);
  h += t.html;
  if (jobLogId) {
    h += `<h2>Logs — ${esc(jobLogId)}</h2><pre class="log" id="job-log">loading…</pre>`;
  }
  return { html: h, after: async (el) => {
    wireTable(el, t);
    el.querySelectorAll("button[data-logs]").forEach((b) => {
      b.onclick = () => { jobLogId = b.dataset.logs; render(); };
    });
    el.querySelectorAll("button[data-stop]").forEach((b) => {
      b.onclick = async () => { await fetch("/api/jobs/" + b.dataset.stop + "/stop", {method: "POST"}); render(); };
    });
    if (jobLogId) {
      try {
        const res = await fetchJSON("/api/jobs/" + jobLogId + "/logs");
        const pre = el.querySelector("#job-log");
        if (pre) pre.textContent = res.logs || "(empty)";
      } catch (e) { /* job gone */ }
    }
  }};
};

views.serve = async () => {
  let status;
  try { status = await fetchJSON("/api/serve"); }
  catch (e) { return `<h1>Serve</h1><div class="muted-note">serve is not running</div>`; }
  let h = `<h1>Serve</h1>`;
  // serve.status() -> {app: {deployment: {target_replicas, replicas:
  // [{replica_id, healthy}], ongoing, deleting}}}
  if (status.error) return h + `<div class="muted-note">serve is not running</div>`;
  if (!Object.keys(status).length) h += `<div class="muted-note">no applications deployed</div>`;
  for (const [name, deps] of Object.entries(status)) {
    h += `<h2>${esc(name)}</h2>`;
    h += table("serve-" + name, [
      {k: "name", label: "deployment"},
      {k: "healthy", label: "healthy", fmt: (v, r) =>
        `<span class="${v >= r.target ? "ok" : "warn"}">${v}/${r.target}</span>`},
      {k: "ongoing", label: "in-flight"},
      {k: "deleting", label: "", fmt: (v) => v ? `<span class="warn">deleting</span>` : ""},
      {k: "replicas", label: "replicas", fmt: (v) =>
        esc((v || []).map((r) => short(r.replica_id, 10) + (r.healthy ? "" : "!")).join(", "))},
    ], Object.entries(deps).map(([dn, d]) => ({
      name: dn, target: d.target_replicas,
      healthy: (d.replicas || []).filter((r) => r.healthy).length,
      ongoing: d.ongoing, deleting: d.deleting, replicas: d.replicas,
    }))).html;
  }
  return h;
};

// server-side rollup history (GCS RollupStore): name -> [values].
// Counters plot their per-second rate, histograms their p99, gauges and
// derived ratios the value — 120s of real history, survives page loads.
async function rollupSeries() {
  let names;
  try { names = await fetchJSON("/api/metric_names"); } catch (e) { return {}; }
  const out = {};
  await Promise.all((names || []).map(async (name) => {
    try {
      const win = await fetchJSON(
        "/api/metric_window?name=" + encodeURIComponent(name) + "&secs=120");
      const pts = win.points || [];
      if (!pts.length) return;
      out[name] = pts.map((p) =>
        win.type === "counter" ? p.rate :
        win.type === "histogram" ? (p.p99 ?? p.rate) : p.value);
    } catch (e) { /* name raced retention */ }
  }));
  return out;
}

views.metrics = async () => {
  const metrics = latestMetrics;  // render() preamble already fetched it
  const series = await rollupSeries();
  let h = `<h1>Metrics</h1>
    <div class="muted-note">sparklines are server history from the GCS rollup store
    (counters as rate/s, histograms as p99) ·
    <a class="inline" href="/metrics" target="_blank">prometheus endpoint</a></div>`;
  // derived ratio series (accept rate, SLO breach fraction) have no
  // registry sample — surface them first, straight from the rollups
  const sampled = new Set(Object.keys(metrics));
  for (const [name, vals] of Object.entries(series)) {
    if (sampled.has(name)) continue;
    const last = vals[vals.length - 1];
    h += `<div><span class="dim" style="display:inline-block;width:360px">${esc(name)} <span class="dim">(derived)</span></span>
      <span style="display:inline-block;width:120px">${esc(typeof last === "number" ? +last.toFixed(3) : last)}</span>
      ${spark(vals)}</div>`;
  }
  for (const [name, m] of Object.entries(metrics)) {
    if (m.type === "histogram") {
      h += `<h2>${esc(name)} <span class="dim">(histogram)</span></h2>`;
      for (const [tag, hist] of metricSamples(m)) {
        const count = (hist.counts || []).reduce((a, b) => a + b, 0);
        h += `<div class="dim">${tag ? esc(tag) + " " : ""}count=${count} sum=${hist.sum ?? ""} ${spark(series[name])}</div>`;
      }
      continue;
    }
    for (const [tag, s] of metricSamples(m)) {
      const v = s.value;
      // rollup series are summed across tags; show it on the first
      // (untagged or sole) sample row, client history otherwise
      const sv = tag ? history[name + "|" + tag] : series[name] || history[name + "|" + tag];
      h += `<div><span class="dim" style="display:inline-block;width:360px">${esc(name)}${tag ? " " + esc(tag) : ""}</span>
        <span style="display:inline-block;width:120px">${esc(typeof v === "number" ? +v.toFixed(3) : v)}</span>
        ${spark(sv)}</div>`;
    }
  }
  return h;
};

views.timeline = async () => {
  const events = await fetchJSON("/api/timeline");
  let h = `<h1>Timeline</h1>
    <div class="muted-note">${events.length} events ·
    <a class="inline" href="/api/timeline" target="_blank" download="timeline.json">download chrome-trace JSON</a>
    (load into perfetto.dev / chrome://tracing for the full viewer)</div>`;
  const spans = events.filter((e) => e.ph === "X" && e.dur > 0);
  if (!spans.length) return h + `<div class="muted-note">no complete spans yet</div>`;
  const t0 = Math.min(...spans.map((s) => s.ts));
  const t1 = Math.max(...spans.map((s) => s.ts + s.dur));
  const span = t1 - t0 || 1;
  const lanes = {};
  for (const s of spans.slice(-800)) {
    const key = (s.pid || "?") + "/" + (s.tid || "?");
    (lanes[key] = lanes[key] || []).push(s);
  }
  const colors = ["#6fd3c7", "#9db8ff", "#e8c468", "#ef7b7b", "#b58aef", "#7fdc8a"];
  let ci = 0, colorOf = {};
  h += `<div class="tl-wrap">`;
  for (const [lane, ss] of Object.entries(lanes)) {
    h += `<div class="tl-row"><div class="tl-label">${esc(lane)}</div><div class="tl-track">`;
    for (const s of ss) {
      const left = (s.ts - t0) / span * 100, width = Math.max(s.dur / span * 100, 0.15);
      if (!(s.name in colorOf)) colorOf[s.name] = colors[ci++ % colors.length];
      h += `<span class="tl-span" style="left:${left.toFixed(3)}%;width:${width.toFixed(3)}%;background:${colorOf[s.name]}"
        title="${esc(s.name)} ${(s.dur / 1000).toFixed(2)}ms"></span>`;
    }
    h += `</div></div>`;
  }
  h += `</div><h2>Legend</h2>` + Object.entries(colorOf).map(([n, c]) =>
    `<span style="margin-right:14px"><span style="color:${c}">■</span> ${esc(n)}</span>`).join("");
  return h;
};

/* ---- detail overlay --------------------------------------------------- */
function showDetail(view, title, obj, extraHtml) {
  detail = { view, title, obj, extraHtml };
  render();
}
function detailHtml() {
  if (!detail) return "";
  let h = `<div class="detail"><div style="display:flex;justify-content:space-between">
    <h2 style="margin:0 0 8px">${esc(detail.title)}</h2>
    <button id="detail-close">close</button></div>`;
  if (detail.obj) {
    h += `<div class="kv">`;
    for (const [k, v] of Object.entries(detail.obj)) {
      h += `<span class="k">${esc(k)}</span><span class="wrap">${esc(
        typeof v === "object" ? JSON.stringify(v) : v)}</span>`;
    }
    h += `</div>`;
  }
  h += detail.extraHtml || "";
  return h + `</div>`;
}

/* ---- router / refresh loop ------------------------------------------- */
function currentView() {
  const m = location.hash.match(/^#\/(\w+)/);
  return m && views[m[1]] ? m[1] : "overview";
}

let rendering = false;
async function render() {
  if (rendering) return;
  rendering = true;
  const name = currentView();
  document.querySelectorAll("#nav a").forEach((a) =>
    a.classList.toggle("active", a.dataset.view === name));
  try {
    // ONE metrics fetch per cycle: feeds the sparkline history AND the
    // overview/metrics views (they read latestMetrics instead of
    // re-fetching)
    try {
      latestMetrics = await fetchJSON("/api/metrics");
      for (const [k, m] of Object.entries(latestMetrics))
        if (m.type !== "histogram")
          for (const [tag, s] of metricSamples(m)) pushHistory(k, tag, s.value);
    } catch (e) { /* metrics optional */ }
    const out = await views[name]();
    const html = typeof out === "string" ? out : out.html;
    main.innerHTML = (detail && detail.view === name ? detailHtml() : "") + html;
    const closeBtn = $("#detail-close");
    if (closeBtn) closeBtn.onclick = () => { detail = null; render(); };
    if (typeof out === "string") {
      wireTable(main, null);
      // re-wire plain tables' sort handlers + row clicks need table objects;
      // string views only get sort headers
      main.querySelectorAll("table").forEach(() => {});
    } else if (out.after) {
      await out.after(main);
    }
    $("#last-refresh").textContent = "updated " + new Date().toLocaleTimeString();
  } catch (e) {
    main.innerHTML = `<div class="err">dashboard error: ${esc(e.message || e)}</div>`;
  }
  rendering = false;
}

window.addEventListener("hashchange", () => { detail = null; jobLogId = null; render(); });
render();
setInterval(() => { if ($("#autorefresh").checked) render(); }, 2500);
