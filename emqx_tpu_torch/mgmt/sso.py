"""Dashboard single sign-on — emqx_dashboard_sso analog (the port's copy
of emqx_tpu/mgmt/sso.py's registry).

The reference carries two protocol-real backends: `ldap` binds the
dashboard credentials through auth/ldap.py's LDAPv3 client, and `oidc`
verifies the id_token through auth/authn.py's JWT provider. Both sit
on the auth layer, which the port has not ported yet (ROADMAP Queue 1
item 9b.1), so configuring either raises `NotPortedError` naming that
item, and the API answers it with 501. The registry itself is here:
with no backend configured, `info`, `running`, `get` and
`default_role` answer what the reference's answer with none.
"""

from __future__ import annotations

from typing import Any, Dict

from ..config.unported import NotPortedError

# the reference's backends and the auth module each one needs
_BACKENDS = {"ldap": "the LDAP client", "oidc": "the JWT provider"}
SSO_ITEM = "9b.1"


class SsoError(Exception):
    pass


def not_ported(name: str) -> NotPortedError:
    return NotPortedError(
        f"sso.{name}", SSO_ITEM, f"dashboard SSO over {_BACKENDS[name]}"
    )


class SsoManager:
    """Configured SSO backends + login dispatch (emqx_dashboard_sso's
    running-backend registry)."""

    def __init__(self) -> None:
        self.backends: Dict[str, Any] = {}

    def update(self, name: str, conf: Dict[str, Any]):
        if name not in _BACKENDS:
            raise SsoError(f"unknown sso backend {name!r} "
                           f"(supported: {sorted(_BACKENDS)})")
        raise not_ported(name)

    def delete(self, name: str) -> bool:
        return self.backends.pop(name, None) is not None

    def get(self, name: str):
        b = self.backends.get(name)
        if b is None or not b.enable:
            return None
        return b

    def running(self):
        return sorted(n for n, b in self.backends.items() if b.enable)

    def info(self):
        return [b.info() for _n, b in sorted(self.backends.items())]

    def default_role(self, name: str) -> str:
        b = self.backends.get(name)
        return (b.conf.get("default_role", "viewer") if b else "viewer")
