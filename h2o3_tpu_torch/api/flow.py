"""Flow — the built-in notebook web console served from the node; the
port's own copy of ``h2o3_tpu/api/flow.py`` (the page imports nothing).

Reference: ``h2o-web/`` packages the Flow notebook (CoffeeScript app served
by the node at ``/``; ``h2o-web/README.md:1-8``): an assist-driven CELL
notebook — each cell holds a command (importFiles/getFrames/buildModel/
predict/plot/…), runs against the V3 REST surface, and renders its output
inline; notebooks save/load; help is a first-class pane.

This build ships the same product shape dependency-free: a single-page
cell notebook over ``/3/*``/``/99/*`` JSON with

- **assist**: one click inserts a template cell per workflow verb
  (reference ``assist`` cells);
- **commands**: ``importFiles``, ``getFrames``, ``getFrameSummary``
  (head + per-column stats + histogram sparklines from the server's ColV3
  rollup histograms), ``buildModel``, ``buildGrid``/``getGrid``,
  ``runAutoML``/``getLeaderboard``, ``getModels``, ``getModel``,
  ``predict``, ``getJobs``, ``rapids``, ``plot varimp|scoring|roc``,
  ``md`` (markdown-lite notes);
- **inline graphs**: dependency-free SVG — variable-importance bars,
  scoring-history lines, ROC curve from the thresholds table (reference
  Flow's vega plots);
- **help pane**: per-command usage + the live route list from the server;
- **notebooks**: cells persist via NodePersistentStorage (reference Flow
  save/load), with v1 console documents still loadable;
- **.flow import**: reference Flow notebooks (``{"cells": [{"type":
  "cs"|"md", "input": ...}]}`` JSON) load via the Import .flow button —
  known CoffeeScript commands (importFiles/buildModel/predict/getFrames/
  getModels) convert to native cells, the rest become annotated notes.
"""

FLOW_HTML = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>h2o3-tpu Flow</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#f4f6f8;color:#1c2733}
 header{background:#1c2733;color:#fff;padding:10px 20px;display:flex;gap:16px;align-items:baseline}
 header h1{font-size:16px;margin:0}
 header span{color:#9db2c4;font-size:12px}
 #wrap{display:grid;grid-template-columns:minmax(0,1fr) 300px;gap:16px;padding:16px 20px}
 #nb{min-width:0}
 .cell{background:#fff;border:1px solid #dde4ea;border-left:4px solid #2f6fed;border-radius:6px;margin:0 0 10px;padding:8px}
 .cell.md{border-left-color:#8a63c9}
 .cell textarea{width:100%;border:0;resize:vertical;font:12px/1.5 ui-monospace,monospace;outline:none;background:#fbfcfd;min-height:2.2em;box-sizing:border-box}
 .cellbar{display:flex;gap:6px;align-items:center;margin-bottom:4px}
 .out{margin-top:6px;font-size:12px;overflow:auto}
 aside{font-size:12px}
 aside section{background:#fff;border:1px solid #dde4ea;border-radius:6px;padding:10px;margin-bottom:12px}
 h2{font-size:12px;text-transform:uppercase;letter-spacing:.06em;color:#5a6b7b;margin:0 0 8px}
 table{width:100%;border-collapse:collapse;font-size:12px}
 td,th{text-align:left;padding:3px 6px;border-bottom:1px solid #eef2f5}
 th{color:#5a6b7b;font-weight:600}
 button{padding:4px 10px;border:0;border-radius:4px;background:#2f6fed;color:#fff;cursor:pointer;font-size:12px}
 button.small{padding:2px 8px;font-size:11px;background:#5a6b7b}
 button.ghost{background:#e8eef7;color:#2f6fed}
 pre{background:#f4f6f8;padding:8px;border-radius:4px;overflow:auto;max-height:260px;font-size:11px;margin:4px 0}
 .pill{display:inline-block;padding:1px 8px;border-radius:10px;font-size:11px;background:#e7f0e7;color:#2b6a2b}
 .err{color:#b32020}
 .assist button{margin:2px}
 svg text{font:10px system-ui}
 .help dt{font-weight:600;margin-top:6px}.help dd{margin:0 0 2px 8px;color:#3f4f5e}
 a{color:#2f6fed;cursor:pointer}
</style></head><body>
<header><h1>h2o3-tpu Flow</h1><span id="cloud">connecting…</span>
 <span style="margin-left:auto">
  <input type="text" id="nbname" placeholder="notebook name" style="width:12em">
  <button class="small" onclick="saveFlow()">Save</button>
  <label class="small" style="cursor:pointer;background:#5a6b7b;color:#fff;padding:3px 8px;border-radius:4px;font-size:11px">Import .flow
   <input type="file" id="flowfile" accept=".flow,.json" style="display:none" onchange="importFlowFile(this.files[0])"></label>
  <select id="nblist" onchange="loadFlow(this.value)"><option value="">Load…</option></select>
 </span>
</header>
<div id="wrap">
 <div id="nb">
  <div class="assist" id="assist"></div>
  <div id="cells"></div>
  <button class="ghost" onclick="addCell('')">+ cell</button>
 </div>
 <aside>
  <section><h2>Frames</h2><div id="frames"></div></section>
  <section><h2>Models</h2><div id="models"></div></section>
  <section><h2>Help</h2><div class="help" id="help"></div></section>
 </aside>
</div>
<script>
const J = (m, p, body) => fetch(p, body ? {method: m,
  headers: {"Content-Type": "application/json"}, body: JSON.stringify(body)}
  : {method: m}).then(r => r.json());
function esc(s){return String(s).replace(/&/g,'&amp;').replace(/</g,'&lt;')
  .replace(/>/g,'&gt;').replace(/"/g,'&quot;').replace(/'/g,'&#39;')}
function qk(k){return /[\s"']/.test(k) ? '"' + String(k).replace(/"/g, '') + '"' : k}
function cellLink(cmdline, label){
  return `<a data-cmd="${esc(cmdline)}" onclick="addCell(this.dataset.cmd,1)">${esc(label)}</a>`;
}

// ---------------------------------------------------------------- notebook
let CELLS = [];   // {id, input, output(html)}
let NEXT_CELL_ID = 1;
function renderCells(){
  const host = document.getElementById("cells");
  host.innerHTML = "";
  CELLS.forEach((c, i) => {
    const d = document.createElement("div");
    d.className = "cell" + (c.input.trim().startsWith("md ") ? " md" : "");
    d.innerHTML = `<div class="cellbar">
      <button onclick="runCell(${i})">Run</button>
      <button class="small" onclick="moveCell(${i},-1)">↑</button>
      <button class="small" onclick="moveCell(${i},1)">↓</button>
      <button class="small" onclick="delCell(${i})">✕</button>
      <span style="color:#8aa">cell ${i + 1} — shift+enter runs</span></div>`;
    const ta = document.createElement("textarea");
    ta.value = c.input;
    ta.rows = Math.max(1, c.input.split("\n").length);
    ta.oninput = () => { c.input = ta.value; };
    ta.onkeydown = e => { if (e.key === "Enter" && e.shiftKey){
      e.preventDefault(); c.input = ta.value; runCell(i); } };
    d.appendChild(ta);
    const out = document.createElement("div");
    out.className = "out";
    out.id = "cellout-" + c.id;
    out.innerHTML = c.output || "";
    d.appendChild(out);
    host.appendChild(d);
  });
}
function addCell(input, run){
  CELLS.push({id: NEXT_CELL_ID++, input: input || "", output: ""});
  renderCells();
  if (run) runCell(CELLS.length - 1);
}
function delCell(i){ CELLS.splice(i, 1); renderCells(); }
function moveCell(i, d){
  const j = i + d;
  if (j < 0 || j >= CELLS.length) return;
  [CELLS[i], CELLS[j]] = [CELLS[j], CELLS[i]];
  renderCells();
}

// ------------------------------------------------------------ assist + help
const ASSIST = [
  ["importFiles", "importFiles /path/to/data.csv"],
  ["getFrames", "getFrames"],
  ["frame summary", "getFrameSummary FRAME_KEY"],
  ["buildModel", "buildModel gbm {\"training_frame\": \"FRAME\", \"response_column\": \"Y\", \"ntrees\": 20}"],
  ["getModels", "getModels"],
  ["getModel", "getModel MODEL_KEY"],
  ["predict", "predict MODEL_KEY FRAME_KEY"],
  ["buildGrid", "buildGrid gbm {\"training_frame\": \"FRAME\", \"response_column\": \"Y\", \"hyper_parameters\": {\"max_depth\": [3, 5], \"ntrees\": [10, 20]}}"],
  ["getGrid", "getGrid GRID_KEY"],
  ["runAutoML", "runAutoML {\"training_frame\": \"FRAME\", \"response_column\": \"Y\", \"max_models\": 5, \"nfolds\": 0}"],
  ["leaderboard", "getLeaderboard PROJECT_KEY"],
  ["plot varimp", "plot varimp MODEL_KEY"],
  ["plot scoring", "plot scoring MODEL_KEY"],
  ["plot roc", "plot roc MODEL_KEY"],
  ["remove", "remove KEY"],
  ["getJobs", "getJobs"],
  ["rapids", "rapids (mean (cols FRAME 'col'))"],
  ["note", "md ## notes\nanything after 'md ' renders as a note"],
];
const HELP = {
  importFiles: "importFiles &lt;path&gt; [dest_key] — parse csv/parquet/orc/arff/svmlight/avro/xlsx into a frame",
  getFrames: "getFrames — list frames in the DKV",
  getFrameSummary: "getFrameSummary &lt;key&gt; — head rows + per-column mean/sigma/NAs/domain",
  buildModel: "buildModel &lt;algo&gt; &lt;json params&gt; — algos: gbm drf glm xgboost deeplearning kmeans naivebayes isolationforest …; polls the job to completion",
  buildGrid: "buildGrid &lt;algo&gt; &lt;json&gt; — cartesian/random grid over hyper_parameters; polls the job then lists the grid",
  getGrid: "getGrid &lt;key&gt; — models of a finished grid",
  runAutoML: "runAutoML &lt;json&gt; — leaderboard run (max_models/max_runtime_secs budgets)",
  getLeaderboard: "getLeaderboard &lt;project&gt; — ranked AutoML leaderboard",
  getModels: "getModels — list models",
  getModel: "getModel &lt;key&gt; — metrics + params",
  predict: "predict &lt;model&gt; &lt;frame&gt; — score a frame; result key in DKV",
  plot: "plot varimp|scoring|roc &lt;model&gt; — inline SVG charts from the model payload",
  remove: "remove &lt;key&gt; — delete a frame/model from the DKV",
  getJobs: "getJobs — job list with status/progress",
  rapids: "rapids &lt;ast&gt; — evaluate a Rapids s-expression server-side",
  md: "md &lt;text&gt; — a note cell (lines starting ## render as headings)",
};
function renderAssist(){
  document.getElementById("assist").innerHTML = "assist: " + ASSIST.map(
    ([label, tpl]) =>
      `<button class="ghost" data-cmd="${esc(tpl)}" onclick="addCell(this.dataset.cmd)">${esc(label)}</button>`
  ).join("");
  document.getElementById("help").innerHTML =
    "<dl>" + Object.entries(HELP).map(([k, v]) =>
      `<dt>${esc(k)}</dt><dd>${v}</dd>`).join("") + "</dl>" +
    `<a onclick="routeHelp()">server routes…</a><div id="routes"></div>`;
}
async function routeHelp(){
  try{
    const r = await fetch("/3/Metadata/endpoints").then(x => x.json());
    const list = (r.routes || []).map(x =>
      `<tr><td>${esc(x.http_method)}</td><td>${esc(x.url_pattern)}</td></tr>`).join("");
    document.getElementById("routes").innerHTML =
      `<pre style="max-height:200px"><table>${list}</table></pre>`;
  }catch(e){ document.getElementById("routes").textContent = "unavailable"; }
}

// -------------------------------------------------------------- SVG charts
function svgBar(pairs, title){
  const W = 560, H = 20 * pairs.length + 30, max = Math.max(...pairs.map(p => p[1]), 1e-12);
  let s = `<svg width="${W}" height="${H}"><text x="4" y="12" font-weight="600">${esc(title)}</text>`;
  pairs.forEach(([k, v], i) => {
    const y = 22 + i * 20, w = 360 * v / max;
    s += `<rect x="130" y="${y}" width="${w}" height="14" fill="#2f6fed" opacity="0.85"/>
          <text x="126" y="${y + 11}" text-anchor="end">${esc(String(k).slice(0, 18))}</text>
          <text x="${134 + w}" y="${y + 11}">${(+v).toPrecision(4)}</text>`;
  });
  return s + "</svg>";
}
function svgLine(series, title, xlab){
  // series: [{name, xs, ys, color}]
  const W = 560, H = 220, L = 46, B = 26;
  let xs = series.flatMap(s => s.xs), ys = series.flatMap(s => s.ys);
  ys = ys.filter(v => isFinite(v)); xs = xs.filter(v => isFinite(v));
  if (!xs.length || !ys.length) return "<i>no data</i>";
  const x0 = Math.min(...xs), x1 = Math.max(...xs), y0 = Math.min(...ys), y1 = Math.max(...ys);
  const px = x => L + (W - L - 10) * (x1 > x0 ? (x - x0) / (x1 - x0) : 0.5);
  const py = y => (H - B) - (H - B - 22) * (y1 > y0 ? (y - y0) / (y1 - y0) : 0.5);
  let s = `<svg width="${W}" height="${H}"><text x="4" y="12" font-weight="600">${esc(title)}</text>
    <line x1="${L}" y1="${H - B}" x2="${W - 8}" y2="${H - B}" stroke="#9db2c4"/>
    <line x1="${L}" y1="${H - B}" x2="${L}" y2="18" stroke="#9db2c4"/>
    <text x="${L}" y="${H - 8}">${(+x0).toPrecision(3)}</text>
    <text x="${W - 60}" y="${H - 8}">${(+x1).toPrecision(3)} ${esc(xlab || "")}</text>
    <text x="2" y="${py(y0) + 3}">${(+y0).toPrecision(3)}</text>
    <text x="2" y="${py(y1) + 3}">${(+y1).toPrecision(3)}</text>`;
  series.forEach((sr, k) => {
    const pts = sr.xs.map((x, i) => `${px(x)},${py(sr.ys[i])}`).join(" ");
    s += `<polyline fill="none" stroke="${sr.color}" stroke-width="1.6" points="${pts}"/>
          <text x="${L + 6 + 120 * k}" y="24" fill="${sr.color}">${esc(sr.name)}</text>`;
  });
  return s + "</svg>";
}
function sparkline(bins, w, h){
  if (!bins || !bins.length) return "·";
  const max = Math.max(...bins, 1);
  const bw = (w - 2) / bins.length;
  return `<svg width="${w}" height="${h}">` + bins.map((b, i) =>
    `<rect x="${1 + i * bw}" y="${h - 1 - (h - 3) * b / max}" width="${Math.max(bw - 0.6, 0.6)}" height="${(h - 3) * b / max + 1}" fill="#2f6fed" opacity="0.8"/>`
  ).join("") + "</svg>";
}
function tableCols(t){  // TwoDimTableV3 (column-major data) -> {name: values}
  const out = {};
  (t.columns || []).forEach((c, i) => { out[c.name] = t.data[i]; });
  return out;
}

// ---------------------------------------------------------------- commands
async function pollJob(jobKey, onTick, ms){
  for(;;){
    const jr = await J("GET", `/3/Jobs/${jobKey}`);
    const j = jr.jobs[0];
    onTick(j);
    if (["DONE", "FAILED", "CANCELLED"].includes(j.status)){
      if (j.exception) throw new Error(j.exception);
      return j;
    }
    await new Promise(r => setTimeout(r, ms || 500));
  }
}
async function runCell(i){
  const c = CELLS[i];
  const set = html => {
    c.output = html;
    const node = document.getElementById("cellout-" + c.id);
    if (node) node.innerHTML = html; else renderCells();
  };
  const line = c.input.trim();
  if (!line) return;
  // tokens honor double quotes so keys with spaces stay addressable:
  //   getFrameSummary "my frame"
  const toks = (line.match(/"([^"]*)"|\S+/g) || [])
    .map(t => t.startsWith('"') ? t.slice(1, -1) : t);
  const [cmd, ...rest] = toks;
  try{
    if (cmd === "md"){
      const txt = c.input.replace(/^md\s*/, "");
      set(txt.split("\n").map(l => l.startsWith("##")
        ? `<h3>${esc(l.replace(/^#+\s*/, ""))}</h3>` : `<p>${esc(l)}</p>`).join(""));
    } else if (cmd === "importFiles"){
      set("importing…");
      const body = {path: rest[0]};
      if (rest[1]) body.destination_frame = rest[1];
      const out = await J("POST", "/3/ImportFiles", body);
      if (out.msg) throw new Error(out.msg);
      set(`<span class="pill">${esc(out.destination_frames[0])}</span>`);
      refreshSide();
    } else if (cmd === "getFrames"){
      const out = await J("GET", "/3/Frames");
      set("<table><tr><th>key</th><th>rows</th><th>cols</th></tr>" +
        out.frames.map(f => `<tr><td>${cellLink("getFrameSummary " + qk(f.frame_id.name), f.frame_id.name)}</td><td>${f.rows}</td><td>${f.column_count}</td><td>${cellLink("remove " + qk(f.frame_id.name), "rm")}</td></tr>`).join("") + "</table>");
    } else if (cmd === "getFrameSummary"){
      const out = await J("GET", `/3/Frames/${encodeURIComponent(rest[0])}`);
      const f = out.frames[0];
      const head = f.columns.map(cc => `<th>${esc(cc.label)}<br><span style="font-weight:400">${esc(cc.type)}</span></th>`).join("");
      const n = Math.min(8, Math.max(...f.columns.map(cc => (cc.data || cc.string_data || []).length)));
      let body = "";
      for (let r = 0; r < n; r++)
        body += "<tr>" + f.columns.map(cc => {
          let v = (cc.string_data || cc.data || [])[r];
          if (v !== null && cc.domain && cc.data) v = cc.domain[cc.data[r]] ?? v;
          return `<td>${v == null ? "·" : esc(typeof v === "number" ? +v.toFixed(4) : v)}</td>`;
        }).join("") + "</tr>";
      const stats = f.columns.map(cc =>
        `<tr><td>${esc(cc.label)}</td><td>${cc.mean == null ? "·" : (+cc.mean).toFixed(4)}</td>
         <td>${cc.sigma == null ? "·" : (+cc.sigma).toFixed(4)}</td><td>${cc.missing_count}</td>
         <td>${cc.domain ? cc.domain.length + " levels" : "·"}</td>
         <td>${sparkline(cc.histogram_bins, 120, 22)}</td></tr>`).join("");
      set(`<b>${esc(rest[0])}</b> — ${f.rows} rows<table><tr>${head}</tr>${body}</table>
           <table><tr><th>col</th><th>mean</th><th>sigma</th><th>NAs</th><th>domain</th><th>distribution</th></tr>${stats}</table>`);
    } else if (cmd === "buildModel"){
      const algo = rest[0];
      const body = JSON.parse(line.slice(line.indexOf("{")));
      set("submitting…");
      const out = await J("POST", `/3/ModelBuilders/${algo}`, body);
      if (out.msg) throw new Error(out.msg);
      const j = await pollJob(out.job.key.name, j =>
        set(`${esc(j.status)} ${(100 * j.progress).toFixed(0)}% — ${esc(j.progress_msg || "")}`));
      set(`<span class="pill">${esc(j.dest.name)}</span> ` +
          cellLink("getModel " + qk(j.dest.name), "inspect") + " " +
          cellLink("plot varimp " + qk(j.dest.name), "varimp"));
      refreshSide();
    } else if (cmd === "getModels"){
      const out = await J("GET", "/3/Models");
      set("<table><tr><th>key</th><th>algo</th></tr>" + out.models.map(m =>
        `<tr><td>${cellLink("getModel " + qk(m.model_id.name), m.model_id.name)}</td><td>${esc(m.algo)}</td><td>${cellLink("remove " + qk(m.model_id.name), "rm")}</td></tr>`).join("") + "</table>");
    } else if (cmd === "getModel"){
      const out = await J("GET", `/3/Models/${encodeURIComponent(rest[0])}`);
      const m = out.models[0];
      const mm = m.output.training_metrics || {};
      const metrics = Object.entries(mm).filter(([k, v]) => typeof v === "number")
        .map(([k, v]) => `<tr><td>${esc(k)}</td><td>${(+v).toFixed(5)}</td></tr>`).join("");
      set(`<b>${esc(rest[0])}</b> (${esc(m.algo)}, ${esc(m.output.model_category || "")}) ` +
          cellLink("plot varimp " + qk(rest[0]), "varimp") + " " +
          cellLink("plot scoring " + qk(rest[0]), "scoring") + " " +
          cellLink("plot roc " + qk(rest[0]), "roc") +
          `<table><tr><th>training metric</th><th>value</th></tr>${metrics}</table>`);
    } else if (cmd === "predict"){
      set("scoring…");
      const out = await J("POST", `/3/Predictions/models/${encodeURIComponent(rest[0])}/frames/${encodeURIComponent(rest[1])}`);
      if (out.msg) throw new Error(out.msg);
      set(`<span class="pill">${esc(out.predictions_frame.name)}</span> ` +
          cellLink("getFrameSummary " + qk(out.predictions_frame.name), "inspect"));
      refreshSide();
    } else if (cmd === "buildGrid"){
      const algo = rest[0];
      const body = JSON.parse(line.slice(line.indexOf("{")));
      set("submitting grid…");
      const out = await J("POST", `/99/Grid/${algo}`, body);
      if (out.msg) throw new Error(out.msg);
      const j = await pollJob(out.job.key.name, j =>
        set(`${esc(j.status)} ${(100 * j.progress).toFixed(0)}%`));
      set(`<span class="pill">${esc(j.dest.name)}</span> ` +
          cellLink("getGrid " + qk(j.dest.name), "inspect grid"));
      refreshSide();
    } else if (cmd === "getGrid"){
      const out = await J("GET", `/99/Grids/${encodeURIComponent(rest[0])}`);
      if (out.msg) throw new Error(out.msg);
      set(`<b>${esc(rest[0])}</b><table><tr><th>model</th></tr>` +
        (out.model_ids || []).map(m =>
          `<tr><td>${cellLink("getModel " + qk(m.name), m.name)}</td></tr>`).join("") +
        "</table>" + ((out.failure_details || []).length
          ? `<pre class="err">${esc(out.failure_details.join("\n"))}</pre>` : ""));
    } else if (cmd === "runAutoML"){
      const body = JSON.parse(line.slice(line.indexOf("{")));
      set("starting AutoML…");
      const out = await J("POST", "/99/AutoMLBuilder", body);
      if (out.msg) throw new Error(out.msg);
      const j = await pollJob(out.job.key.name, j =>
        set(`${esc(j.status)} ${(100 * j.progress).toFixed(0)}% — ${esc(j.progress_msg || "training models")}`), 800);
      set(`<span class="pill">${esc(j.dest.name)}</span> ` +
          cellLink("getLeaderboard " + qk(j.dest.name), "leaderboard"));
      refreshSide();
    } else if (cmd === "getLeaderboard"){
      const out = await J("GET", `/99/Leaderboards/${encodeURIComponent(rest[0])}`);
      if (out.msg) throw new Error(out.msg);
      const t = out.table;
      const heads = t.columns.map(cc => `<th>${esc(cc.name)}</th>`).join("");
      const nrow = (t.data[0] || []).length;
      let rows = "";
      for (let r = 0; r < nrow; r++){
        rows += "<tr>" + t.columns.map((cc, ci) => {
          const v = t.data[ci][r];
          if (cc.name === "model_id")
            return `<td>${cellLink("getModel " + qk(v), v)}</td>`;
          return `<td>${typeof v === "number" ? (+v).toFixed(5) : esc(v == null ? "·" : v)}</td>`;
        }).join("") + "</tr>";
      }
      set(`<b>${esc(out.project_name)}</b> — sorted by ${esc(out.sort_metric)}
           <table><tr>${heads}</tr>${rows}</table>`);
    } else if (cmd === "plot"){
      const kind = rest[0], key = rest[1];
      const out = await J("GET", `/3/Models/${encodeURIComponent(key)}`);
      const mo = out.models[0].output;
      if (kind === "varimp"){
        const t = mo.variable_importances;
        if (!t) throw new Error("model has no variable importances");
        const cols = tableCols(t);
        const pairs = cols.variable.map((v, i) => [v, +cols.scaled_importance[i]]);
        pairs.sort((a, b) => b[1] - a[1]);
        set(svgBar(pairs.slice(0, 20), `variable importance — ${key}`));
      } else if (kind === "scoring"){
        const t = mo.scoring_history;
        if (!t) throw new Error("model has no scoring history");
        const cols = tableCols(t);
        const xkey = Object.keys(cols).find(k => /tree|iter|epoch/i.test(k)) || Object.keys(cols)[0];
        const palette = ["#2f6fed", "#d1342f", "#2b8a5c", "#8a63c9"];
        const series = Object.keys(cols)
          .filter(k => k !== xkey && cols[k].every(v => typeof v === "number"))
          .slice(0, 4).map((k, i) => ({name: k, xs: cols[xkey], ys: cols[k], color: palette[i]}));
        set(svgLine(series, `scoring history — ${key}`, xkey));
      } else if (kind === "roc"){
        const mm = mo.training_metrics || {};
        const t = mm.thresholds_and_metric_scores;
        if (!t) throw new Error("no thresholds table (binomial models only)");
        const cols = tableCols(t);
        set(svgLine([{name: `ROC (AUC ${(+mm.AUC).toFixed(4)})`, xs: cols.fpr, ys: cols.tpr, color: "#2f6fed"},
                     {name: "chance", xs: [0, 1], ys: [0, 1], color: "#9db2c4"}],
                    `ROC — ${key}`, "fpr"));
      } else throw new Error(`unknown plot kind ${kind}`);
    } else if (cmd === "remove"){
      await fetch(`/3/DKV/${encodeURIComponent(rest[0])}`, {method: "DELETE"});
      set(`<span class="pill">removed ${esc(rest[0])}</span>`);
      refreshSide();
    } else if (cmd === "getJobs"){
      const out = await J("GET", "/3/Jobs");
      set("<table><tr><th>job</th><th>status</th><th>progress</th></tr>" +
        out.jobs.map(j => `<tr><td>${esc(j.description || j.key.name)}</td><td>${esc(j.status)}</td><td>${(100 * j.progress).toFixed(0)}%</td></tr>`).join("") + "</table>");
    } else if (cmd === "rapids"){
      const r = await J("POST", "/99/Rapids", {ast: line.slice(7)});
      set(`<pre>${esc(JSON.stringify(r, null, 1))}</pre>`);
      refreshSide();
    } else {
      throw new Error(`unknown command ${cmd}; see help`);
    }
  }catch(e){ set(`<span class="err">${esc(e.message)}</span>`); }
}

// -------------------------------------------------------------- side panes
async function refreshCloud(){
  try{
    const c = await J("GET", "/3/Cloud");
    document.getElementById("cloud").innerHTML =
      `cloud <b>${esc(c.cloud_name)}</b> · ${c.cloud_size} device(s) · v${esc(c.version)} <span class="pill">healthy</span>`;
  }catch(e){ document.getElementById("cloud").textContent = "unreachable"; }
}
async function refreshSide(){
  try{
    const fo = await J("GET", "/3/Frames");
    document.getElementById("frames").innerHTML = "<table>" + fo.frames.map(f =>
      `<tr><td>${cellLink("getFrameSummary " + qk(f.frame_id.name), f.frame_id.name)}</td><td>${f.rows}×${f.column_count}</td><td>${cellLink("remove " + qk(f.frame_id.name), "rm")}</td></tr>`).join("") + "</table>";
    const mo = await J("GET", "/3/Models");
    document.getElementById("models").innerHTML = "<table>" + mo.models.map(m =>
      `<tr><td>${cellLink("getModel " + qk(m.model_id.name), m.model_id.name)}</td><td>${esc(m.algo)}</td><td>${cellLink("remove " + qk(m.model_id.name), "rm")}</td></tr>`).join("") + "</table>";
  }catch(e){}
}

// ---------------------------------------------------------------- persist
async function saveFlow(){
  const name = document.getElementById("nbname").value || "flow";
  const doc = {version: 2, cells: CELLS.map(c => ({input: c.input}))};
  await fetch(`/3/NodePersistentStorage/notebook/${encodeURIComponent(name)}`,
              {method: "POST", body: JSON.stringify(doc)});
  refreshNotebooks();
}
async function loadFlow(name){
  if (!name) return;
  const r = await fetch(`/3/NodePersistentStorage/notebook/${encodeURIComponent(name)}`);
  const doc = JSON.parse(await r.text());
  if (doc.version === 2 && doc.cells){
    CELLS = doc.cells.map(c => ({id: NEXT_CELL_ID++, input: c.input, output: ""}));
  } else if (doc.fields){      // v1 console documents: convert to cells
    CELLS = [];
    const push = input => CELLS.push({id: NEXT_CELL_ID++, input, output: ""});
    const f = doc.fields;
    if (f.path) push(`importFiles ${f.path}` + (f.dest ? ` ${qk(f.dest)}` : ""));
    if (f.algo){
      // v1 docs never persisted the response column (it lived in a
      // <select>): emit an md note + a template the user completes
      const body = {training_frame: f.dest || "EDIT_FRAME_KEY",
                    response_column: "EDIT_RESPONSE_COLUMN"};
      for (const kv of (f.params || "").split(",")){
        const [k, v] = kv.split("=").map(x => x && x.trim());
        if (k && v !== undefined) body[k] = v;
      }
      push("md converted from a v1 console document — fill in the " +
           "EDIT_* placeholders below before running");
      push(`buildModel ${f.algo} ${JSON.stringify(body)}`);
    }
    if (f.ast) push(`rapids ${f.ast}`);
  }
  document.getElementById("nbname").value = name;
  renderCells();
}
function convertRefFlowCell(cell){
  // reference Flow .flow cells: {type: "cs"|"md"|"raw", input: "..."}
  // (h2o-web Flow's CoffeeScript command language). Convert the common
  // verbs; anything else becomes an annotated note so nothing is lost.
  const inp = (cell.input || "").trim();
  if (cell.type === "md") return "md " + inp;
  let m;
  if ((m = inp.match(/^importFiles\s*\[\s*"([^"]+)"/)))
    return "importFiles " + m[1];
  if ((m = inp.match(/^buildModel\s+['"](\w+)['"]\s*,\s*(\{[\s\S]*\})/))){
    try{
      const params = JSON.parse(m[2].replace(/'/g, '"'));
      delete params.model_id;
      return `buildModel ${m[1]} ${JSON.stringify(params)}`;
    }catch(e){ /* fall through to note */ }
  }
  if ((m = inp.match(/^predict\s+model:\s*['"]([^'"]+)['"],?\s*frame:\s*['"]([^'"]+)['"]/)))
    return `predict ${qk(m[1])} ${qk(m[2])}`;
  if (/^getFrames/.test(inp)) return "getFrames";
  if (/^getModels/.test(inp)) return "getModels";
  if ((m = inp.match(/^getFrameSummary\s+['"]([^'"]+)['"]/)))
    return "getFrameSummary " + qk(m[1]);
  return "md [unconverted .flow cell] " + inp;
}
function importFlowFile(file){
  if (!file) return;
  const rd = new FileReader();
  rd.onload = () => {
    try{
      const doc = JSON.parse(rd.result);
      if (!doc.cells) throw new Error("not a .flow document");
      CELLS = doc.cells.map(c =>
        ({id: NEXT_CELL_ID++, input: convertRefFlowCell(c), output: ""}));
      document.getElementById("nbname").value =
        (file.name || "imported").replace(/\.flow$/, "");
      renderCells();
    }catch(e){ alert("import failed: " + e.message); }
  };
  rd.readAsText(file);
}
async function refreshNotebooks(){
  const r = await J("GET", "/3/NodePersistentStorage/notebook");
  const sel = document.getElementById("nblist");
  sel.innerHTML = '<option value="">Load…</option>' +
    r.entries.map(e => `<option value="${esc(e.name)}">${esc(e.name)}</option>`).join("");
}

renderAssist();
addCell("md ## welcome to Flow\nuse the assist buttons above to insert workflow cells; shift+enter runs a cell");
runCell(0);
refreshCloud(); refreshSide(); refreshNotebooks();
setInterval(refreshCloud, 10000);
</script></body></html>
"""
