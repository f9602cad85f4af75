"""Minimal JSON Schema validator for kv-schemas.

The port's copy of ``nucliadb_tpu/utils/jsonschema.py``,
kept verbatim: the port imports nothing of the JAX package.

The image carries no `jsonschema` package, so this implements the subset
the kv-schema API needs (parity target: reference /kv-schemas validating
key_value fields): type, properties, required, items, enum, additionalProperties,
minimum/maximum, minLength/maxLength. Unknown keywords are ignored (like a
lenient draft validator).
"""

from __future__ import annotations

from typing import Any

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "integer": int,
    "number": (int, float),
    "boolean": bool,
    "null": type(None),
}


def validate_schema(schema: Any, path: str = "$") -> None:
    """Sanity-check a schema document itself."""
    if not isinstance(schema, dict):
        raise ValueError(f"{path}: schema must be an object")
    t = schema.get("type")
    if t is not None and t not in _TYPES:
        raise ValueError(f"{path}: unknown type {t!r}")
    for name, sub in (schema.get("properties") or {}).items():
        validate_schema(sub, f"{path}.{name}")
    if "items" in schema:
        validate_schema(schema["items"], f"{path}[]")
    req = schema.get("required")
    if req is not None and (
        not isinstance(req, list) or not all(isinstance(x, str) for x in req)
    ):
        raise ValueError(f"{path}: required must be a list of strings")


def validate_instance(value: Any, schema: dict, path: str = "$") -> None:
    """Raises ValueError on the first violation."""
    t = schema.get("type")
    if t is not None:
        expected = _TYPES[t]
        ok = isinstance(value, expected)
        if t == "integer" and isinstance(value, bool):
            ok = False
        if t == "number" and isinstance(value, bool):
            ok = False
        if not ok:
            raise ValueError(f"{path}: expected {t}, got {type(value).__name__}")
    if "enum" in schema and value not in schema["enum"]:
        raise ValueError(f"{path}: {value!r} not in enum")
    if isinstance(value, dict):
        props = schema.get("properties") or {}
        for name in schema.get("required", []):
            if name not in value:
                raise ValueError(f"{path}: missing required property {name!r}")
        for name, sub in value.items():
            if name in props:
                validate_instance(sub, props[name], f"{path}.{name}")
            elif schema.get("additionalProperties") is False:
                raise ValueError(f"{path}: unexpected property {name!r}")
    if isinstance(value, list) and "items" in schema:
        for i, item in enumerate(value):
            validate_instance(item, schema["items"], f"{path}[{i}]")
    if isinstance(value, str):
        if "minLength" in schema and len(value) < schema["minLength"]:
            raise ValueError(f"{path}: shorter than minLength")
        if "maxLength" in schema and len(value) > schema["maxLength"]:
            raise ValueError(f"{path}: longer than maxLength")
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        if "minimum" in schema and value < schema["minimum"]:
            raise ValueError(f"{path}: below minimum")
        if "maximum" in schema and value > schema["maximum"]:
            raise ValueError(f"{path}: above maximum")
