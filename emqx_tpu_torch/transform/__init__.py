"""Payload governance: schema registry, schema validation, message
transformation — the emqx_schema_registry / emqx_schema_validation /
emqx_message_transformation trio (the port's own copy of
emqx_tpu/transform/).

All three hang off the 'message.publish' hook fold exactly where the
reference registers them (emqx_schema_validation.erl
on_message_publish; transformation runs after validation), with
topic-indexed matching so per-publish cost is one trie walk, not a
scan of every rule.
"""

from .registry import SchemaRegistry, SchemaError
from .transformation import MessageTransformation
from .validation import SchemaValidation

__all__ = [
    "SchemaRegistry",
    "SchemaError",
    "SchemaValidation",
    "MessageTransformation",
]
