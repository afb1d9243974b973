"""Shared read-model helpers used by both the REST API and the CLI so
the two surfaces can never diverge (emqx_mgmt.erl plays this role for
emqx_mgmt_api_* and emqx_mgmt_cli in the reference). The port's own
copy of emqx_tpu/mgmt/views.py. An API subscribe's retained messages
come from `Broker.subscribe`, whose one-filter read goes through the
retained device leg when it is on (K8 on the card, `_read_retained`),
else the host trie; `deliver_retained` only delivers them."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

# (ROADMAP Queue 1 item, subsystem) of each API route family and ctl
# command over a subsystem the port has not ported yet
NOT_PORTED = {
    "gateways": ("9b.5", "the gateways"),
    "plugins": ("9b.8", "the plugin manager"),
    "bridges": ("9b.3", "the bridges"),
    "license": ("9b.7", "license enforcement"),
    "load_rebalance": ("8b", "node purge and evacuation"),
}


def routes_view(broker, node_name: str) -> List[Tuple[str, str]]:
    """(topic/filter, node) pairs of the local router (a single node:
    the cluster route table is item 8's)."""
    return [(t, node_name) for t in broker.router.topics()]


def listeners_view(broker) -> List[Dict[str, Any]]:
    out = []
    for srv in getattr(broker, "servers", ()):
        if srv.listen_addr is not None:
            out.append(
                {
                    "id": srv.name,
                    "type": srv.proto,
                    "bind": f"{srv.listen_addr[0]}:{srv.listen_addr[1]}",
                    "running": True,
                    "current_connections": len(srv._conns),
                }
            )
    return out


def deliver_retained(broker, session, retained, opts) -> None:
    """Deliver retained messages for an API-initiated subscription the
    same way the channel does on SUBSCRIBE (retain flag preserved,
    subscription qos cap)."""
    from ..broker.message import Message

    sink = getattr(session, "outgoing_sink", None)
    for m in retained:
        rm = Message(**{**m.__dict__})
        rm.retain = True
        ropts = type(opts)(
            qos=opts.qos,
            no_local=opts.no_local,
            retain_as_published=True,
            retain_handling=opts.retain_handling,
        )
        pkts = session.deliver(rm, ropts)
        if pkts and sink is not None:
            sink(pkts)
