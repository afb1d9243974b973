"""The eviction agent (the port's copy of the EvictionAgent of
emqx_tpu/cluster/rebalance.py, the emqx_eviction_agent analog): it
holds every live listener's accept gate while enabled and disconnects
connected clients on demand with a v5 USE_ANOTHER_SERVER reason, so
they reconnect and take their sessions over. Node evacuation and
rebalance need the cluster layer (ROADMAP Queue 1 item 8) and are not
ported.
"""

from __future__ import annotations

from ..broker.packet import Disconnect, RC


class EvictionAgent:
    """Per-node: blocks new connections while enabled and disconnects
    existing clients on demand (emqx_eviction_agent.erl)."""

    def __init__(self, broker):
        self.broker = broker
        self.enabled = False
        self.evicted = 0

    def enable(self) -> None:
        """New connections are shed at accept while enabled (a HOLD per
        agent — concurrent agents never reopen each other's gate)."""
        if self.enabled:
            return
        self.enabled = True
        self._held = list(self.broker.servers)
        for srv in self._held:
            srv.evict_hold()

    def disable(self) -> None:
        if not self.enabled:
            return
        self.enabled = False
        for srv in getattr(self, "_held", ()):
            srv.evict_release()
        self._held = []

    def connection_count(self) -> int:
        return self.broker.connected_count()

    def evict_connections(self, n: int, server_reference: str = "") -> int:
        """Disconnect up to n connected clients: v5 clients get a
        DISCONNECT USE_ANOTHER_SERVER first; then the transport closes.
        Sessions (incl. durable) keep their state for the takeover."""
        done = 0
        for session in list(self.broker.sessions.values()):
            if done >= n:
                break
            if not getattr(session, "connected", False):
                continue
            sink = getattr(session, "outgoing_sink", None)
            closer = getattr(session, "closer", None)
            if sink is None and closer is None:
                continue  # not transport-attached (internal session)
            if sink is not None:
                try:
                    props = (
                        {"server_reference": server_reference}
                        if server_reference
                        else {}
                    )
                    sink([Disconnect(RC.USE_ANOTHER_SERVER, props=props)])
                except Exception:
                    pass
            if closer is not None:
                try:
                    closer()
                except Exception:
                    pass
            session.connected = False
            done += 1
        self.evicted += done
        return done
