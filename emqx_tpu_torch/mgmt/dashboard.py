"""Dashboard (the port's own copy of emqx_tpu/mgmt/dashboard.py) — the
emqx_dashboard web-console analog as ONE
self-contained page (no SPA build step): login against /api/v5/login,
then a tabbed console polling the JSON API.

Tabs mirror the reference console's left nav
(apps/emqx_dashboard/src/emqx_dashboard.erl + emqx_dashboard_monitor):
Overview (stat tiles + sampled rate charts from /monitor), Clients
(with kick), Subscriptions, Topics (routes), Rules (status + enable
toggle), Bridges (status + delivery metrics), Listeners, Alarms.
Every interpolated value is HTML-escaped; actions ride the same
Bearer token the login issued.
"""

from __future__ import annotations

PAGE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>emqx-tpu dashboard</title>
<style>
  :root { color-scheme: light dark; }
  body { font-family: ui-sans-serif, system-ui, sans-serif; margin: 0;
         display: flex; min-height: 100vh; }
  nav { width: 11rem; border-right: 1px solid #8883; padding: 1rem 0; }
  nav h1 { font-size: 1rem; padding: 0 1rem; }
  nav a { display: block; padding: .45rem 1rem; color: inherit;
          text-decoration: none; cursor: pointer; }
  nav a.on { background: #8882; font-weight: 600; }
  main { flex: 1; padding: 1.2rem 1.6rem; max-width: 72rem; }
  h2 { font-size: 1.05rem; }
  .grid { display: grid; grid-template-columns: repeat(auto-fill,
          minmax(13rem, 1fr)); gap: .8rem; margin: 1rem 0; }
  .card { border: 1px solid #8884; border-radius: .5rem; padding: .8rem; }
  .card b { font-size: 1.4rem; display: block; }
  table { border-collapse: collapse; width: 100%; margin-top: .6rem; }
  th, td { text-align: left; padding: .3rem .6rem; border-bottom:
           1px solid #8883; font-size: .9rem; }
  #login { max-width: 20rem; margin: 4rem auto; }
  input { display: block; margin: .4rem 0; padding: .4rem; width: 100%; }
  button { padding: .3rem .8rem; cursor: pointer; }
  .err { color: #c33; }
  .ok { color: #2a2; } .bad { color: #c33; }
  .pane { display: none; } .pane.on { display: block; }
</style>
</head>
<body>
<div id="login">
  <h1>emqx-tpu &mdash; sign in</h1>
  <input id="u" placeholder="username" value="admin">
  <input id="p" placeholder="password" type="password">
  <button onclick="login()">Sign in</button>
  <div id="lerr" class="err"></div>
</div>
<nav id="nav" style="display:none">
  <h1>emqx-tpu</h1>
  <a data-tab="overview" class="on">Overview</a>
  <a data-tab="clients">Clients</a>
  <a data-tab="subs">Subscriptions</a>
  <a data-tab="topics">Topics</a>
  <a data-tab="rules">Rules</a>
  <a data-tab="bridges">Bridges</a>
  <a data-tab="listeners">Listeners</a>
  <a data-tab="alarms">Alarms</a>
  <a href="/api/v5/swagger.json">OpenAPI &#8599;</a>
</nav>
<main id="main" style="display:none">
  <section class="pane on" id="pane-overview">
    <div class="grid" id="tiles"></div>
    <h2>Message rates (msg/s, sampled)</h2>
    <div class="grid">
      <div class="card">received<svg id="c_recv" viewBox="0 0 240 48"
        width="100%" height="48" preserveAspectRatio="none"></svg></div>
      <div class="card">sent<svg id="c_sent" viewBox="0 0 240 48"
        width="100%" height="48" preserveAspectRatio="none"></svg></div>
      <div class="card">dropped<svg id="c_drop" viewBox="0 0 240 48"
        width="100%" height="48" preserveAspectRatio="none"></svg></div>
    </div>
  </section>
  <section class="pane" id="pane-clients">
    <h2>Clients</h2>
    <table id="clients"><thead><tr><th>client id</th><th>connected</th>
    <th>subscriptions</th><th></th></tr></thead><tbody></tbody></table>
  </section>
  <section class="pane" id="pane-subs">
    <h2>Subscriptions</h2>
    <table id="subs"><thead><tr><th>client id</th><th>topic</th>
    <th>qos</th></tr></thead><tbody></tbody></table>
  </section>
  <section class="pane" id="pane-topics">
    <h2>Topics (routes)</h2>
    <table id="topics"><thead><tr><th>topic</th><th>node</th>
    </tr></thead><tbody></tbody></table>
  </section>
  <section class="pane" id="pane-rules">
    <h2>Rules</h2>
    <table id="rules"><thead><tr><th>id</th><th>enabled</th>
    <th>matched</th><th>passed</th><th>failed</th><th></th>
    </tr></thead><tbody></tbody></table>
  </section>
  <section class="pane" id="pane-bridges">
    <h2>Bridges</h2>
    <table id="bridges"><thead><tr><th>name</th><th>status</th>
    <th>success</th><th>failed</th><th>queuing</th><th>inflight</th>
    </tr></thead><tbody></tbody></table>
  </section>
  <section class="pane" id="pane-listeners">
    <h2>Listeners</h2>
    <table id="listeners"><thead><tr><th>id</th><th>type</th>
    <th>bind</th><th>running</th></tr></thead><tbody></tbody></table>
  </section>
  <section class="pane" id="pane-alarms">
    <h2>Alarms</h2>
    <table id="alarms"><thead><tr><th>name</th><th>severity</th>
    <th>message</th><th>activated</th></tr></thead><tbody></tbody></table>
  </section>
</main>
<script>
let tok = null;
let tab = 'overview';
function esc(v) {  // every interpolated value is attacker-influenced
  return String(v).replace(/[&<>"']/g, c => ({'&':'&amp;','<':'&lt;',
    '>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
}
async function login() {
  const r = await fetch('/api/v5/login', {method: 'POST',
    headers: {'content-type': 'application/json'},
    body: JSON.stringify({username: u.value, password: p.value})});
  if (!r.ok) { lerr.textContent = 'login failed'; return; }
  tok = (await r.json()).token;
  document.getElementById('login').style.display = 'none';
  document.getElementById('nav').style.display = '';
  document.getElementById('main').style.display = '';
  tick(); setInterval(tick, 5000);
}
document.getElementById('nav').addEventListener('click', e => {
  const t = e.target.dataset && e.target.dataset.tab;
  if (!t) return;
  tab = t;
  document.querySelectorAll('nav a').forEach(a =>
    a.classList.toggle('on', a.dataset.tab === t));
  document.querySelectorAll('.pane').forEach(p =>
    p.classList.toggle('on', p.id === 'pane-' + t));
  tick();
});
async function get(path) {
  const r = await fetch(path, {headers: {authorization: 'Bearer ' + tok}});
  return r.ok ? r.json() : null;
}
async function act(method, path, body) {
  const r = await fetch(path, {method,
    headers: {authorization: 'Bearer ' + tok,
              'content-type': 'application/json'},
    body: body === undefined ? undefined : JSON.stringify(body)});
  if (!r.ok) { alert(method + ' ' + path + ' failed: ' + r.status); }
  tick();
}
function tile(name, value) {
  return `<div class="card">${esc(name)}<b>${esc(value)}</b></div>`;
}
function spark(svg, values) {
  // inline SVG polyline, no deps (emqx_dashboard_monitor chart analog)
  const w = 240, h = 48, pad = 2;
  const max = Math.max(1, ...values);
  const step = values.length > 1 ? (w - 2 * pad) / (values.length - 1) : 0;
  const pts = values.map((v, i) =>
    `${(pad + i * step).toFixed(1)},` +
    `${(h - pad - (v / max) * (h - 2 * pad)).toFixed(1)}`).join(' ');
  svg.innerHTML = `<polyline fill="none" stroke="currentColor"` +
    ` stroke-width="1.5" points="${pts}"/>` +
    `<text x="${w - 4}" y="10" text-anchor="end" font-size="9"` +
    ` fill="currentColor">${esc(max.toFixed(1))}</text>`;
}
function rows(sel, html) {
  document.querySelector(sel + ' tbody').innerHTML = html;
}
async function tick() {
  if (tab === 'overview') {
    const [stats, metrics, mon, lic] = await Promise.all([
      get('/api/v5/stats'), get('/api/v5/metrics'),
      get('/api/v5/monitor?latest=48'), get('/api/v5/license')]);
    if (!stats || !metrics) return;
    if (mon && mon.length) {
      spark(document.getElementById('c_recv'),
            mon.map(s => s.received_msg_rate ?? 0));
      spark(document.getElementById('c_sent'),
            mon.map(s => s.sent_msg_rate ?? 0));
      spark(document.getElementById('c_drop'),
            mon.map(s => s.dropped_msg_rate ?? 0));
    }
    tiles.innerHTML =
      tile('sessions', stats['sessions.count'] ?? 0) +
      tile('subscriptions', stats['subscriptions.count'] ?? 0) +
      tile('topics', stats['topics.count'] ?? 0) +
      tile('messages received', metrics['messages.received'] ?? 0) +
      tile('messages delivered', metrics['messages.delivered'] ?? 0) +
      tile('dropped', metrics['messages.dropped'] ?? 0) +
      (lic ? tile('license (' + esc(lic.type) + ')',
        esc(lic.live_connections) + ' / ' +
        esc(lic.effective_max_connections)) : '');
  } else if (tab === 'clients') {
    const clients = await get('/api/v5/clients?limit=200');
    if (!clients) return;
    rows('#clients', (clients.data || []).map(c =>
      `<tr><td>${esc(c.clientid)}</td><td>${esc(c.connected)}</td>` +
      `<td>${esc(c.subscriptions_cnt ?? '')}</td>` +
      `<td><button data-kick="${esc(c.clientid)}">kick</button>` +
      `</td></tr>`).join(''));
  } else if (tab === 'subs') {
    const subs = await get('/api/v5/subscriptions?limit=500');
    if (!subs) return;
    rows('#subs', (subs.data || []).map(s =>
      `<tr><td>${esc(s.clientid)}</td><td>${esc(s.topic)}</td>` +
      `<td>${esc(s.qos)}</td></tr>`).join(''));
  } else if (tab === 'topics') {
    const topics = await get('/api/v5/topics?limit=500');
    if (!topics) return;
    rows('#topics', (topics.data || []).map(t =>
      `<tr><td>${esc(t.topic)}</td><td>${esc(t.node)}</td></tr>`
      ).join(''));
  } else if (tab === 'rules') {
    const rules = await get('/api/v5/rules');
    if (!rules) return;
    rows('#rules', (rules.data || rules || []).map(r =>
      `<tr><td>${esc(r.id)}</td>` +
      `<td class="${r.enable ? 'ok' : 'bad'}">${esc(r.enable)}</td>` +
      `<td>${esc(r.metrics ? r.metrics.matched : '')}</td>` +
      `<td>${esc(r.metrics ? r.metrics.passed : '')}</td>` +
      `<td>${esc(r.metrics ? r.metrics.failed : '')}</td>` +
      `<td><button data-rule="${esc(r.id)}"` +
      ` data-enable="${r.enable ? '' : '1'}">` +
      `${r.enable ? 'disable' : 'enable'}</button></td></tr>`).join(''));
  } else if (tab === 'bridges') {
    const bridges = await get('/api/v5/bridges');
    if (!bridges) return;
    rows('#bridges', (bridges || []).map(b => {
      const m = b.metrics || {};
      const cls = b.status === 'connected' ? 'ok' : 'bad';
      return `<tr><td>${esc(b.name)}</td>` +
        `<td class="${cls}">${esc(b.status)}</td>` +
        `<td>${esc(m.success ?? 0)}</td><td>${esc(m.failed ?? 0)}</td>` +
        `<td>${esc(m.queuing ?? 0)}</td><td>${esc(m.inflight ?? 0)}</td>` +
        `</tr>`;
    }).join(''));
  } else if (tab === 'listeners') {
    const ls = await get('/api/v5/listeners');
    if (!ls) return;
    rows('#listeners', (ls || []).map(l =>
      `<tr><td>${esc(l.id ?? l.name ?? '')}</td><td>${esc(l.type ?? '')}` +
      `</td><td>${esc(l.bind ?? '')}</td><td>${esc(l.running ?? '')}` +
      `</td></tr>`).join(''));
  } else if (tab === 'alarms') {
    const al = await get('/api/v5/alarms');
    if (!al) return;
    rows('#alarms', ((al.data || al) || []).map(a =>
      `<tr><td>${esc(a.name)}</td><td>${esc(a.severity ?? '')}</td>` +
      `<td>${esc(a.message ?? '')}</td>` +
      `<td>${esc(a.activate_at ?? a.activated_at ?? '')}</td></tr>`
      ).join(''));
  }
}
// action buttons carry their target in data attributes and are read
// back through the DOM API — an interpolated inline-JS handler would
// let a crafted client/rule id break out of the string literal (XSS
// with the admin token in scope)
document.getElementById('main').addEventListener('click', e => {
  const d = e.target.dataset || {};
  if (d.kick !== undefined) {
    act('DELETE', '/api/v5/clients/' + encodeURIComponent(d.kick));
  } else if (d.rule !== undefined) {
    toggleRule(d.rule, d.enable === '1');
  }
});
function toggleRule(id, enable) {
  act('PUT', '/api/v5/rules/' + encodeURIComponent(id), {enable});
}
</script>
</body>
</html>
"""


def install(api) -> None:
    """Mount GET / and /dashboard on a ManagementApi (no auth for the
    page itself — the page logs in via the API like the reference)."""
    from .http import Response

    def page(_req):
        return Response(body=PAGE.encode(), content_type="text/html; charset=utf-8")

    api.http.route("GET", "/", page)
    api.http.route("GET", "/dashboard", page)
