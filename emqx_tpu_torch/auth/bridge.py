"""Hook bridge: installs the ban check and flapping into a Broker (the
port's copy of emqx_tpu/auth/bridge.py, reduced to what the port
serves).

The reference's auth apps attach to L1 via hookpoints
('client.authenticate' from emqx_channel:2080, flapping on
'client.disconnected') — SURVEY.md §2.6. The reference's node always
installs one `AuthPipeline` at boot; so does the port's, and a ban
made through the management API or ctl refuses the next CONNECT with
reason code 0x8C on both.

What the port's pipeline leaves out: the authn chains, the authz
sources and 'client.authorize' (ROADMAP Queue 1 item 9b.1). The boot
refuses every key that would fill them (`authentication`,
`authorization.sources`, `authorization.no_match` other than allow;
config/unported.py), so on every config the port boots the reference's
pipeline runs an empty chain (allow) and an empty source list with
no_match allow: the verdicts equal these.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..broker.hooks import Hooks, STOP
from .banned import Banned
from .flapping import FlappingDetector


class AuthPipeline:
    def __init__(
        self,
        banned: Optional[Banned] = None,
        flapping: Optional[FlappingDetector] = None,
    ):
        self.banned = banned or Banned()
        self.flapping = flapping or FlappingDetector(self.banned, enable=False)

    # --- hook callbacks -------------------------------------------------

    def _on_authenticate(self, info: Dict[str, Any], acc):
        if self.banned.check(
            info.get("client_id", ""), info.get("username"), info.get("peer", "")
        ) is not None:
            return (STOP, 0x8C)  # banned reason code
        return True  # the empty authn chain allows

    def _on_disconnected(self, client_id: str, reason: str):
        self.flapping.on_disconnect(client_id or "")

    # --- wiring ---------------------------------------------------------

    def install(self, hooks: Hooks) -> None:
        hooks.add("client.authenticate", self._on_authenticate, priority=100)
        hooks.add("client.disconnected", self._on_disconnected, priority=100)

    def uninstall(self, hooks: Hooks) -> None:
        hooks.delete("client.authenticate", self._on_authenticate)
        hooks.delete("client.disconnected", self._on_disconnected)
