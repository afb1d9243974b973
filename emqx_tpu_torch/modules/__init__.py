"""Optional broker feature modules (the emqx_modules /
emqx_auto_subscribe analog): delayed publish, topic rewrite,
auto-subscribe. Each is a small object wired onto Broker hooks via
`enable()` and detached via `disable()`."""

from .auto_subscribe import AutoSubscribe
from .delayed import DelayedPublish
from .rewrite import TopicRewrite

__all__ = ["AutoSubscribe", "DelayedPublish", "TopicRewrite"]
