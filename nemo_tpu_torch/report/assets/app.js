/* Nemo debugging report viewer.
 *
 * Reads ./debugging.json (the array of run objects the pipeline marshals,
 * same schema as the reference, faultinjectors/data-types.go:81-98) and
 * renders: the runs table, top-level recommendations (from run 0), and one
 * expandable section per run with hazard, provenance, differential
 * provenance, prototype, and correction views.
 */
"use strict";

function el(tag, attrs, ...children) {
  const node = document.createElement(tag);
  for (const [k, v] of Object.entries(attrs || {})) {
    if (k === "html") node.innerHTML = v;
    else node.setAttribute(k, v);
  }
  for (const c of children) {
    node.append(c);
  }
  return node;
}

function figure(path, title) {
  const wrap = el("div");
  if (title) wrap.append(el("h4", {}, title));
  const scroll = el("div", { class: "figure-scroll" });
  const img = el("img", { src: path, alt: title || path });
  // Under a restrictive figure policy (--figures=failed/sample:N/none) not
  // every run has rendered figures; show a note instead of a broken image.
  img.onerror = () => {
    scroll.replaceChildren(
      el("p", { class: "empty-note" }, "figure not rendered (figure policy)")
    );
  };
  scroll.append(img);
  wrap.append(scroll);
  return wrap;
}

function layerStack(iter, goodIter) {
  // Differential provenance as stacked layers over the good run's graph:
  // good (the baseline run's post prov) at the bottom, failed overlay, diff
  // overlay — mirroring the reference's checkbox-controlled z-ordered layers.
  const wrap = el("div");
  wrap.append(el("h4", {}, "Differential provenance (good − bad)"));
  const controls = el("div", { class: "layer-controls" });
  const stack = el("div", { class: "layer-stack" });
  const layers = [
    ["good", `figures/run_${goodIter}_post_prov.svg`, true],
    ["failed", `figures/run_${iter}_diff_post_prov-failed.svg`, true],
    ["diff", `figures/run_${iter}_diff_post_prov-diff.svg`, true],
  ];
  layers.forEach(([name, src, on], i) => {
    const img = el("img", { src, alt: name });
    if (i > 0) img.classList.add("overlay");
    if (!on) img.style.display = "none";
    img.onerror = () => {
      img.remove();
    };
    stack.append(img);
    const box = el("input", { type: "checkbox" });
    box.checked = on;
    box.addEventListener("change", () => {
      img.style.display = box.checked ? "" : "none";
    });
    const label = el("label", {});
    label.append(box, ` ${name}`);
    controls.append(label);
  });
  wrap.append(controls, stack);
  return wrap;
}

function protoList(title, items) {
  const wrap = el("div");
  wrap.append(el("h4", {}, title));
  if (!items || !items.length) {
    wrap.append(el("p", { class: "empty-note" }, "none"));
    return wrap;
  }
  const ul = el("ul", { class: "proto-list" });
  for (const it of items) ul.append(el("li", { html: it }));
  wrap.append(ul);
  return wrap;
}

function missingEvents(events) {
  const wrap = el("div");
  wrap.append(el("h4", {}, "Missing events (differential frontier)"));
  if (!events || !events.length) {
    wrap.append(el("p", { class: "empty-note" }, "none"));
    return wrap;
  }
  const ul = el("ul", { class: "proto-list" });
  for (const m of events) {
    const goals = (m.Goals || []).map((g) => g.label).join(", ");
    ul.append(
      el(
        "li",
        {},
        el("span", { class: "missing-rule" }, m.Rule ? m.Rule.label : "?"),
        goals ? ` ← ${goals}` : ""
      )
    );
  }
  wrap.append(ul);
  return wrap;
}

function goodRunIter(runs) {
  // The backend emits its chosen baseline run in debugging.json
  // (pipeline.py: goodRunIteration), so the diff layer stack always points
  // at the run the diff figures were actually built against.  The local
  // mirror of the policy (base.py good_run_iter) remains only as a
  // fallback for reports written before the field existed.
  const emitted = runs.find((r) => r.goodRunIteration !== undefined && r.goodRunIteration !== null);
  if (emitted) return emitted.goodRunIteration;
  const succ = runs.filter((r) => r.status === "success");
  const achieving = succ.find((r) => r.timePostHolds && Object.keys(r.timePostHolds).length);
  if (achieving) return achieving.iteration;
  if (succ.length) return succ[0].iteration;
  return 0;
}

function runSection(run, goodIter) {
  const failed = run.status !== "success";
  const details = el("details", { class: "run", id: `run-${run.iteration}` });
  details.append(
    el(
      "summary",
      {},
      `Run ${run.iteration} — `,
      el("span", { class: failed ? "status-fail" : "status-success" }, run.status)
    )
  );

  if (failed && run.corrections && run.corrections.length) {
    details.append(protoList("Correction suggestions", run.corrections));
  }
  if (failed) {
    details.append(layerStack(run.iteration, goodIter));
    details.append(missingEvents(run.missingEvents));
    details.append(
      protoList("Missing from intersection prototype", run.interProtoMissing),
      protoList("Missing from union prototype", run.unionProtoMissing)
    );
  }
  details.append(figure(`figures/run_${run.iteration}_spacetime.svg`, "Hazard window (space-time)"));
  details.append(
    figure(`figures/run_${run.iteration}_pre_prov.svg`, "Antecedent provenance (raw)"),
    figure(`figures/run_${run.iteration}_pre_prov_clean.svg`, "Antecedent provenance (simplified)"),
    figure(`figures/run_${run.iteration}_post_prov.svg`, "Consequent provenance (raw)"),
    figure(`figures/run_${run.iteration}_post_prov_clean.svg`, "Consequent provenance (simplified)")
  );
  details.append(
    protoList("Intersection prototype", run.interProto),
    protoList("Union prototype", run.unionProto)
  );
  return details;
}

function telemetryTable(title, rows) {
  // rows: [label, value] pairs; value pre-formatted.
  const wrap = el("div", { class: "telemetry-block" });
  wrap.append(el("h4", {}, title));
  const table = el("table", { class: "telemetry-table" });
  const tbody = el("tbody", {});
  for (const [k, v] of rows) {
    tbody.append(el("tr", {}, el("td", {}, k), el("td", { class: "num" }, String(v))));
  }
  table.append(tbody);
  wrap.append(table);
  return wrap;
}

async function telemetry() {
  // Run telemetry (analysis/pipeline.py: telemetry.json — phase walls,
  // figure-pipeline stats, obs metrics snapshot).  Reports written before
  // the obs subsystem have no such file: keep the section hidden.
  let data;
  try {
    const resp = await fetch("telemetry.json");
    if (!resp.ok) return;
    data = await resp.json();
  } catch (e) {
    return;
  }
  const body = document.getElementById("telemetry-body");

  const phases = Object.entries(data.timings || {});
  if (phases.length) {
    body.append(
      telemetryTable(
        "Pipeline phases",
        phases.map(([k, s]) => [k, `${(s * 1e3).toFixed(1)} ms`])
      )
    );
  }

  const fs = data.figure_stats;
  if (fs && fs.figures) {
    body.append(
      telemetryTable("Figure pipeline", [
        ["figures", fs.figures],
        ["unique figures", fs.unique_figures],
        ["dedup ratio", `${fs.dedup_ratio}×`],
        ["SVG cache hits", fs.figure_cache_hits],
        ["rendered", fs.rendered],
        ["render workers", fs.render_workers],
        ["render time", `${(fs.render_s * 1e3).toFixed(1)} ms`],
      ])
    );
  }

  // Corpus store traffic (nemo_tpu/store): how this run's ingest was served
  // — warm mmap hits vs parse-path misses/stale falls, appended segments,
  // and the bytes mapped from .npack shards.
  const allCounters = (data.metrics || {}).counters || {};
  const storeRows = [];
  for (const [key, label] of [
    ["store.hit", "warm loads (hit)"],
    ["store.miss", "parse-path misses"],
    ["store.stale", "stale/corrupt falls"],
    ["store.append", "segments appended"],
    ["store.populate", "stores populated"],
  ]) {
    if (allCounters[key]) storeRows.push([label, allCounters[key]]);
  }
  if (allCounters["store.bytes_mapped"]) {
    storeRows.push([
      "bytes mapped",
      `${(allCounters["store.bytes_mapped"] / 1e6).toFixed(1)} MB`,
    ]);
  }
  if (storeRows.length) {
    body.append(telemetryTable("Corpus store", storeRows));
  }

  // Result cache + delta analysis (nemo_tpu/store/rcache.py,
  // analysis/delta.py): whether this report was served whole from cache,
  // how many per-segment partials merged from cache vs mapped fresh, and
  // the per-run split a grown corpus achieved.
  const rcacheRows = [];
  for (const [key, label] of [
    ["rcache.report_hit", "full-report hits"],
    ["rcache.report_miss", "full-report misses"],
    ["rcache.report_stale", "report entries stale/corrupt"],
    ["rcache.partial_hit", "segment partials from cache"],
    ["rcache.partial_miss", "segment partials mapped fresh"],
    ["rcache.partial_stale", "partials stale/corrupt"],
    ["rcache.figures_restored", "figures restored from cache"],
    ["delta.runs_mapped", "runs mapped (fresh)"],
    ["delta.runs_cached", "runs served from cached partials"],
    ["rcache.evicted", "entries LRU-evicted"],
  ]) {
    if (allCounters[key]) rcacheRows.push([label, allCounters[key]]);
  }
  if (rcacheRows.length) {
    body.append(telemetryTable("Result cache / delta analysis", rcacheRows));
  }

  // Live watch loop (nemo_tpu/watch, ISSUE 15): when this report was
  // (re)published by a --watch session, how many updates the loop has
  // pushed, how many new runs it absorbed, and which injector front end
  // fed the ingest seam (ingest/adapters.py).
  const allGauges = (data.metrics || {}).gauges || {};
  const watchRows = [];
  if (allCounters["watch.updates"]) {
    watchRows.push(["report updates published", allCounters["watch.updates"]]);
    watchRows.push(["new runs absorbed", allCounters["watch.new_runs"] || 0]);
    if (allGauges["watch.runs_total"] != null) {
      watchRows.push(["runs in sweep", allGauges["watch.runs_total"]]);
    }
    if (allCounters["watch.cycle_failed"]) {
      watchRows.push(["failed cycles (retried)", allCounters["watch.cycle_failed"]]);
    }
  }
  for (const [k, v] of Object.entries(allCounters).sort()) {
    if (k.startsWith("ingest.injector.")) {
      watchRows.push([`ingest via ${k.slice("ingest.injector.".length)}`, v]);
    }
  }
  if (watchRows.length) {
    body.append(telemetryTable("Live watch / ingest adapters", watchRows));
  }

  // Streamed analysis (analysis/stream.py, ISSUE 12): whether this run
  // streamed its segments through the double-buffered prefetch pipeline,
  // how often the accelerators stalled on ingest, and the bounded
  // working-set watermark the stream maintained.
  const streamRows = [];
  if (allCounters["stream.segments_staged"]) {
    streamRows.push(["segments streamed", allCounters["stream.segments_staged"]]);
    if (allCounters["stream.prefetch_stall_s"] != null) {
      streamRows.push([
        "prefetch stall",
        `${(allCounters["stream.prefetch_stall_s"] * 1e3).toFixed(1)} ms`,
      ]);
    }
    if (allCounters["stream.staged_bytes"]) {
      streamRows.push([
        "device-staged",
        `${(allCounters["stream.staged_bytes"] / 1e6).toFixed(1)} MB`,
      ]);
    }
    if (allGauges["mem.stream_peak_rss"]) {
      streamRows.push([
        "stream peak RSS",
        `${(allGauges["mem.stream_peak_rss"] / 1e6).toFixed(1)} MB`,
      ]);
    }
  }
  if (streamRows.length) {
    body.append(telemetryTable("Streamed analysis", streamRows));
  }

  // Kernel cost accounting (backend/jax_backend.py:kernel_cost_snapshot):
  // one row per dispatch signature — FLOPs / bytes-accessed estimates,
  // the first-dispatch (compile) wall, and how often it dispatched.
  const mega = (v) => (v == null ? "—" : `${(v / 1e6).toFixed(1)} M`);
  const costs = data.kernel_cost || [];
  if (costs.length) {
    body.append(
      telemetryTable(
        "Kernel cost (per signature)",
        costs.map((c) => [
          `${c.verb} ×${c.dispatches}${c.compiled ? "" : " (cache)"}`,
          `${mega(c.flops)}FLOP, ${mega(c.bytes_accessed)}B, ` +
            `first ${(c.first_dispatch_s * 1e3).toFixed(0)} ms`,
        ])
      )
    );
  }

  // Analysis routes (backend/jax_backend.py:_analysis_route): dispatches
  // per (verb, route) — dense, sparse (host CSR), sparse_device (device
  // CSR, ISSUE 10) — plus the scheduler's per-lane dispatch counts, so a
  // report states which engine analyzed it.
  const routeRows = Object.entries(allCounters)
    .filter(
      ([k]) =>
        k.startsWith("analysis.route.") || k.startsWith("analysis.sched.dispatch.")
    )
    .sort()
    .map(([k, v]) => [
      k
        .replace("analysis.route.", "route ")
        .replace("analysis.sched.dispatch.", "sched lane "),
      v,
    ]);
  if (routeRows.length) {
    body.append(telemetryTable("Analysis routes", routeRows));
  }

  // Ad-hoc queries (nemo_tpu/query, ISSUE 20): how many queries this
  // process compiled/executed, the two cache tiers' hit split, and the
  // scheduler-lane routing of query kernel dispatches.
  const queryRows = [];
  for (const [key, label] of [
    ["query.compiles", "queries compiled"],
    ["query.executes", "queries executed"],
    ["query.cache.hit", "full-result cache hits"],
    ["query.cache.miss", "full-result cache misses"],
    ["query.partial.hit", "segment partials from cache"],
    ["query.partial.miss", "segment partials mapped fresh"],
    ["query.rows_scanned", "rows scanned"],
    ["kernel.dispatches.query", "kernel dispatches"],
  ]) {
    if (allCounters[key]) queryRows.push([label, allCounters[key]]);
  }
  for (const [k, v] of Object.entries(allCounters).sort()) {
    if (k.startsWith("query.route.")) {
      queryRows.push([`lane ${k.slice("query.route.".length)}`, v]);
    }
  }
  if (queryRows.length) {
    body.append(telemetryTable("Queries", queryRows));
  }

  // Platform profile (nemo_tpu/platform, ISSUE 19): the routing constants
  // live for this run and where each came from — env override, measured
  // calibration, or the hand-tuned seed — plus the calibration
  // fingerprint, wall, and age.
  const prof = data.platform_profile;
  if (prof && (prof.constants || []).length) {
    const fmt = (v) =>
      typeof v === "number" && !Number.isInteger(v) ? v.toPrecision(4) : v;
    const profRows = prof.constants.map((c) => [
      `${c.name} (${c.source})`,
      c.source === "env" && c.measured != null
        ? `${fmt(c.value)} (measured ${fmt(c.measured)})`
        : fmt(c.value),
    ]);
    profRows.push(["profile mode", prof.mode]);
    if (prof.fingerprint) {
      const fp = prof.fingerprint;
      profRows.push([
        "fingerprint",
        `${fp.platform}/${fp.device_kind} ×${fp.device_count}, jax ${fp.jax_version}, abi ${fp.analysis_abi}`,
      ]);
      profRows.push(["calibration wall", `${(prof.calibration_wall_s * 1e3).toFixed(0)} ms`]);
      profRows.push(["profile age", `${prof.age_s} s`]);
    }
    body.append(telemetryTable("Platform profile", profRows));
  }

  // Memory watermarks (device peaks where the backend exposes them, host
  // peak RSS always).
  const mem = data.memory || {};
  const memRows = Object.entries(mem).map(([k, v]) => [
    k.replace(/_/g, " "),
    `${(v / 1e6).toFixed(1)} MB`,
  ]);
  if (memRows.length) {
    body.append(telemetryTable("Memory watermarks", memRows));
  }

  const counters = (data.metrics || {}).counters || {};
  const rows = Object.entries(counters)
    .sort()
    .map(([k, v]) => [k, Number.isInteger(v) ? v : v.toFixed(3)]);
  if (rows.length) {
    body.append(telemetryTable("Counters", rows));
  }
  if (data.trace_id) {
    body.append(el("p", { class: "empty-note" }, `trace id ${data.trace_id}`));
  }
  document.getElementById("telemetry").hidden = false;
}

function queryBox() {
  // Ad-hoc query box (ISSUE 20, nemo_tpu/query): the serving handler
  // (cli.py:_query_http_handler) adds POST /query next to the static
  // report, compiling the text onto the batched kernels server-side.  The
  // box only appears under an HTTP origin — on file:// there is no
  // endpoint to post to.
  if (!location.protocol.startsWith("http")) return;
  const section = document.getElementById("query");
  const form = document.getElementById("query-form");
  const input = document.getElementById("query-input");
  const status = document.getElementById("query-status");
  const result = document.getElementById("query-result");
  form.addEventListener("submit", async (ev) => {
    ev.preventDefault();
    const text = input.value.trim();
    if (!text) return;
    status.textContent = "running…";
    result.hidden = true;
    // Multi-corpus serving roots the server at the results directory; the
    // first path segment names this report's corpus for the resolver.
    const report = location.pathname.split("/").filter(Boolean)[0] || "";
    const t0 = performance.now();
    try {
      const resp = await fetch("/query", {
        method: "POST",
        headers: { "Content-Type": "application/json" },
        body: JSON.stringify({ query: text, report }),
      });
      const doc = await resp.json();
      if (!resp.ok || doc.error) {
        status.textContent = doc.error || `query failed (HTTP ${resp.status})`;
        status.classList.add("status-fail");
        return;
      }
      status.classList.remove("status-fail");
      const stats = doc.stats || {};
      status.textContent =
        `${doc.n_runs} runs, agg ${doc.agg} over ${doc.graph} — ` +
        `${(performance.now() - t0).toFixed(0)} ms ` +
        `(cache ${stats.cache || "?"}, ${stats.segments_mapped ?? "?"} segments mapped)`;
      result.textContent = JSON.stringify(doc, null, 2);
      result.hidden = false;
    } catch (e) {
      status.textContent = `query failed: ${e}`;
      status.classList.add("status-fail");
    }
  });
  section.hidden = false;
}

function runLink(iter) {
  // Example-run link: jumps to (and opens) the run's detail section.
  const a = el("a", { href: `#run-${iter}` }, String(iter));
  a.addEventListener("click", (ev) => {
    const d = document.getElementById(`run-${iter}`);
    if (d) {
      ev.preventDefault();
      d.open = true;
      d.scrollIntoView({ behavior: "smooth" });
    }
  });
  return a;
}

function repairsTable(title, entries, supportLabel) {
  const wrap = el("div", { class: "telemetry-block" });
  wrap.append(el("h3", {}, title));
  const table = el("table", { class: "telemetry-table" });
  table.append(
    el(
      "tr",
      {},
      el("th", {}, "#"),
      el("th", {}, "Suggested repair"),
      el("th", {}, supportLabel),
      el("th", {}, "Example runs")
    )
  );
  entries.forEach((c, i) => {
    const examples = el("td", {});
    (c.example_runs || []).forEach((r, j) => {
      if (j) examples.append(", ");
      examples.append(runLink(r));
    });
    table.append(
      el(
        "tr",
        {},
        el("td", {}, String(i + 1)),
        el("td", { html: c.suggestion || c.table }),
        el("td", {}, `${c.support} / ${c.total}`),
        examples
      )
    );
  });
  wrap.append(table);
  return wrap;
}

async function repairs() {
  // Suggested repairs (ISSUE 13): repairs.json carries the corpus-ranked
  // correction/extension synthesis — per-candidate supporting-run counts
  // over the WHOLE corpus, most-supported first.  Reports from backends
  // without synthesis hooks have no such file: keep the section hidden.
  let doc;
  try {
    const resp = await fetch("repairs.json");
    if (!resp.ok) return;
    doc = await resp.json();
  } catch (e) {
    return;
  }
  const corr = doc.corrections || [];
  const ext = doc.extensions || [];
  if (!corr.length && !ext.length) return;
  const note = document.getElementById("repairs-note");
  note.textContent =
    `Candidates ranked by how many of the corpus's runs they explain ` +
    `(${doc.failed_total} failed of ${doc.runs_total} runs` +
    (doc.good_run == null ? "" : `; good run ${doc.good_run}`) +
    `). Fix the most-supported first.`;
  const body = document.getElementById("repairs-body");
  if (corr.length) {
    body.append(
      repairsTable(
        "Corrections — rule tables the good run's causal chain has but failed runs never produced",
        corr,
        "Failed runs explained"
      )
    );
  }
  if (ext.length) {
    body.append(
      repairsTable(
        "Extensions — async rules at the antecedent boundary worth hardening",
        ext,
        "Supporting runs"
      )
    );
  }
  document.getElementById("repairs").hidden = false;
}

async function quarantine() {
  // Degraded runs (ISSUE 9): quarantine.json lists ingest-quarantined runs
  // (position, iteration when known, failing file, parse error).  Healthy
  // corpora have no such file: keep the section hidden.
  let entries;
  try {
    const resp = await fetch("quarantine.json");
    if (!resp.ok) return;
    entries = await resp.json();
  } catch (e) {
    return;
  }
  if (!Array.isArray(entries) || !entries.length) return;
  const tbody = document.querySelector("#quarantine-table tbody");
  for (const q of entries) {
    tbody.append(
      el(
        "tr",
        {},
        el("td", {}, String(q.position)),
        el("td", {}, q.iteration == null ? "—" : String(q.iteration)),
        el("td", {}, q.file || "—"),
        el("td", { class: "status-fail" }, q.error || "")
      )
    );
  }
  document.getElementById("quarantine").hidden = false;
}

async function main() {
  telemetry(); // independent of the run data; never blocks the report
  quarantine(); // likewise — a healthy corpus has no quarantine.json
  repairs(); // likewise — ranked repair synthesis when repairs.json exists
  queryBox(); // likewise — live only under the serving handler's /query
  const resp = await fetch("debugging.json");
  const runs = await resp.json();

  const tbody = document.querySelector("#runs-table tbody");
  for (const run of runs) {
    const spec = run.failureSpec || {};
    const crashes = (spec.crashes || []).map((c) => `${c.node}@${c.time}`).join(", ") || "—";
    const losses =
      (spec.omissions || []).map((o) => `${o.from}→${o.to}@${o.time}`).join(", ") || "—";
    const row = el(
      "tr",
      { class: "run-row" },
      el("td", {}, String(run.iteration)),
      el(
        "td",
        { class: run.status === "success" ? "status-success" : "status-fail" },
        run.status
      ),
      el("td", {}, crashes),
      el("td", {}, losses)
    );
    row.addEventListener("click", () => {
      const d = document.getElementById(`run-${run.iteration}`);
      d.open = true;
      d.scrollIntoView({ behavior: "smooth" });
    });
    tbody.append(row);
  }

  const recList = document.getElementById("rec-list");
  const recs = (runs[0] && runs[0].recommendation) || [];
  for (const r of recs) recList.append(el("li", { html: r }));

  const goodIter = goodRunIter(runs);
  const runsRoot = document.getElementById("runs");
  for (const run of runs) runsRoot.append(runSection(run, goodIter));
}

main();
