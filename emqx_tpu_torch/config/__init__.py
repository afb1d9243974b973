"""The port's config tree: the HOCON subset parser, the typed schema,
the runtime config store and the broker's root schema, copied from
emqx_tpu/config/ (the same keys, types and defaults, so any config the
reference accepts parses to the same document); `unported.py` names the
keys whose subsystem the port does not serve yet."""

from .hocon import loads as hocon_loads
from .schema import (
    Array,
    Bool,
    Bytesize,
    Duration,
    Enum,
    Field,
    Float,
    Int,
    Map,
    SchemaError,
    String,
    Struct,
    Union,
)
from .config import Config, ConfigHandler, UpdateError
from .default_schema import broker_schema
