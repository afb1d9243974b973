"""Schema registry (the port's own copy of
emqx_tpu/transform/registry.py): named payload schemas shared by validation,
transformation, and rules (emqx_schema_registry analog). Built-in
serde types: a JSON-Schema subset, AVRO binary (transform/avro.py,
written from the Avro spec like the reference's erlavro serde), a
proto3 subset compiled from .proto source (transform/protobuf.py),
plus a seam for callable external decoders. A process-default
registry instance backs the rule-engine schema_decode/schema_encode
functions (emqx_schema_registry_serde:handle_rule_function).
"""

from __future__ import annotations

import json
import math
from typing import Any, Callable, Dict, List, Optional


class SchemaError(ValueError):
    pass


def check_json_schema(schema: dict, value: Any, path: str = "$") -> None:
    """Validate `value` against a JSON-Schema subset: type, properties,
    required, items, enum, minimum/maximum, minLength/maxLength.
    Raises SchemaError with the failing path."""
    t = schema.get("type")
    if t is not None:
        ok = {
            "object": lambda v: isinstance(v, dict),
            "array": lambda v: isinstance(v, list),
            "string": lambda v: isinstance(v, str),
            "number": lambda v: isinstance(v, (int, float))
            and not isinstance(v, bool),
            "integer": lambda v: isinstance(v, int) and not isinstance(v, bool),
            "boolean": lambda v: isinstance(v, bool),
            "null": lambda v: v is None,
        }.get(t)
        if ok is None:
            raise SchemaError(f"unknown schema type {t!r}")
        if not ok(value):
            raise SchemaError(f"{path}: expected {t}")
    if "enum" in schema and value not in schema["enum"]:
        raise SchemaError(f"{path}: {value!r} not in enum")
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        if "minimum" in schema and value < schema["minimum"]:
            raise SchemaError(f"{path}: {value} < minimum")
        if "maximum" in schema and value > schema["maximum"]:
            raise SchemaError(f"{path}: {value} > maximum")
    if isinstance(value, str):
        if "minLength" in schema and len(value) < schema["minLength"]:
            raise SchemaError(f"{path}: too short")
        if "maxLength" in schema and len(value) > schema["maxLength"]:
            raise SchemaError(f"{path}: too long")
    if isinstance(value, dict):
        for req in schema.get("required", ()):
            if req not in value:
                raise SchemaError(f"{path}.{req}: required")
        props = schema.get("properties", {})
        for k, sub in props.items():
            if k in value:
                check_json_schema(sub, value[k], f"{path}.{k}")
    if isinstance(value, list) and "items" in schema:
        for i, item in enumerate(value):
            check_json_schema(schema["items"], item, f"{path}[{i}]")


class SchemaRegistry:
    def __init__(self) -> None:
        self._schemas: Dict[str, dict] = {}
        # external decoder seam: name -> fn(payload: bytes) -> decoded
        self._external: Dict[str, Callable[[bytes], Any]] = {}
        # compiled avro/protobuf codecs
        self._codecs: Dict[str, Any] = {}

    def put(self, name: str, spec: dict) -> None:
        stype = spec.get("type")
        if stype == "json_schema":
            if not isinstance(spec.get("schema"), dict):
                raise SchemaError("json_schema needs a 'schema' object")
        elif stype == "avro":
            from .avro import AvroError, AvroSchema

            try:
                self._codecs[name] = AvroSchema(spec["schema"])
            except (AvroError, KeyError) as e:
                raise SchemaError(f"bad avro schema: {e}") from e
        elif stype == "protobuf":
            from .protobuf import ProtoCodec, ProtoFile, ProtobufError

            try:
                self._codecs[name] = ProtoCodec(
                    ProtoFile(spec["source"]), spec["message_type"]
                )
            except (ProtobufError, KeyError) as e:
                # a schema the codec can't honor is rejected at
                # registration, never mid-traffic
                raise SchemaError(f"bad protobuf schema: {e}") from e
        elif stype != "external":
            raise SchemaError(f"unsupported schema type {stype!r}")
        self._schemas[name] = spec

    def put_external(self, name: str, decoder: Callable[[bytes], Any]) -> None:
        self._schemas[name] = {"type": "external"}
        self._external[name] = decoder

    def delete(self, name: str) -> bool:
        self._external.pop(name, None)
        self._codecs.pop(name, None)
        return self._schemas.pop(name, None) is not None

    def get(self, name: str) -> Optional[dict]:
        return self._schemas.get(name)

    def list(self) -> List[str]:
        return sorted(self._schemas)

    def check_payload(self, name: str, payload: bytes) -> Any:
        """Decode + validate; raises SchemaError; returns decoded value."""
        spec = self._schemas.get(name)
        if spec is None:
            raise SchemaError(f"schema {name!r} not found")
        if spec["type"] == "external":
            try:
                return self._external[name](payload)
            except SchemaError:
                raise
            except Exception as e:
                raise SchemaError(f"external decode failed: {e}") from e
        if spec["type"] in ("avro", "protobuf"):
            try:
                return self._codecs[name].decode(payload)
            except Exception as e:
                raise SchemaError(f"{spec['type']} decode failed: {e}") from e
        try:
            value = json.loads(payload)
        except (ValueError, UnicodeDecodeError) as e:
            raise SchemaError(f"payload is not JSON: {e}") from e
        check_json_schema(spec["schema"], value)
        return value

    def encode_payload(self, name: str, value: Any) -> bytes:
        """Encode a decoded value back to wire bytes (rule function
        schema_encode; json_schema validates then dumps)."""
        spec = self._schemas.get(name)
        if spec is None:
            raise SchemaError(f"schema {name!r} not found")
        if spec["type"] in ("avro", "protobuf"):
            try:
                return self._codecs[name].encode(value)
            except Exception as e:
                raise SchemaError(f"{spec['type']} encode failed: {e}") from e
        if spec["type"] == "json_schema":
            check_json_schema(spec["schema"], value)
            return json.dumps(value).encode()
        raise SchemaError(f"schema {name!r} cannot encode")


_default: Optional[SchemaRegistry] = None


def default_registry() -> SchemaRegistry:
    """Process-default instance (the reference's registry is a global
    gen_server); boot shares it between validation, transformation,
    and the rule functions."""
    global _default
    if _default is None:
        _default = SchemaRegistry()
    return _default


def set_default_registry(reg: SchemaRegistry) -> None:
    global _default
    _default = reg
