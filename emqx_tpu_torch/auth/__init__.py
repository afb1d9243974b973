"""The port's auth layer: the ban list, flapping detection and the hook
pipeline that checks them at CONNECT. The authn chains and the authz
sources are ROADMAP Queue 1 item 9b.1."""

from .banned import Banned, BanEntry  # noqa: F401
from .bridge import AuthPipeline  # noqa: F401
from .flapping import FlappingDetector  # noqa: F401
