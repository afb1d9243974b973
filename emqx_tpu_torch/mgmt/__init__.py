"""Management surface of the port: REST API + CLI (the port's own copy
of emqx_tpu/mgmt/, the emqx_management / emqx_dashboard-login /
emqx_ctl analogs, SURVEY.md §2.2).

  * http — dependency-free asyncio HTTP/1.1 server with path-param
           routing (the minirest analog); a `NotPortedError` from a
           handler answers 501;
  * api  — the /api/v5 REST handlers over a live broker: clients,
           subscriptions, topics, publish, metrics/stats, configs,
           banned, api keys, rules, retainer, nodes, backup, the
           dashboard monitor;
  * cli  — the `emqx ctl` command registry/dispatcher.

`mgmt/telemetry.py` is not here: it comes with `telemetry.enable`
(ROADMAP Queue 1 item 9b.2).
"""

from .api import ManagementApi  # noqa: F401
from .cli import Ctl  # noqa: F401
from .http import HttpServer, Request, Response  # noqa: F401
