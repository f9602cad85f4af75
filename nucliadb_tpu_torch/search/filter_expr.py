"""Rich HTTP filter expressions -> native query trees.

The port's copy of ``nucliadb_tpu/search/filter_expr.py``,
kept verbatim: the port imports nothing of the JAX package.

The reference's public `filter_expression` is a STRUCTURED model
(nucliadb_models/filters.py FilterExpression): a `field` tree of typed
atoms (resource/field/keyword/created/modified/label/mimetypes/entity/
language/origin_*/generated), a `paragraph` tree (label/kind), a
`key_value` tree (eq/inequalities/contains against KV schemas) and an
`operator` choosing how field and paragraph filters combine. This module
is the counterpart of the reference's converter
(nucliadb/common/filter_expression.py parse_expression +
facet_from_filter): it lowers the wire dicts to this build's
query_language atoms / JsonExpression, with the same facet spellings.

Parsing is STRICT — an unknown prop, a missing required key, or an
unexpected extra key raises ValueError (HTTP 422); silently ignoring a
filter would return results the caller asked to exclude.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..index.json import JsonAnd, JsonExpression, JsonOr, JsonPredicate
from ..query_language import (
    BooleanExpression,
    DateRangeAtom,
    FacetPrefixAtom,
    FieldAtom,
    KeyPrefixAtom,
    KeywordAtom,
    and_,
    not_,
    or_,
)

# nucliadb_models FieldTypeName -> key letter (nucliadb/common/ids.py:42-49)
FIELD_TYPE_NAME_TO_STR = {
    "text": "t",
    "file": "f",
    "link": "u",
    "generic": "a",
    "conversation": "c",
    "key_value": "k",
}

SlugResolver = Callable[[str], Optional[str]]


def _require(d: dict, key: str, ctx: str) -> object:
    if key not in d or d[key] in (None, ""):
        raise ValueError(f"filter_expression: {ctx} requires {key!r}")
    return d[key]


def _ts(v) -> float:
    from .find import _parse_ts

    out = _parse_ts(v)
    if out is None:
        raise ValueError(f"filter_expression: bad timestamp {v!r}")
    return out


def _facet_from_atom(d: dict, prop: str) -> str:
    """Typed facet atoms -> facet strings (the reference's
    facet_from_filter, common/filter_expression.py:352-403)."""
    if prop == "origin_tag":
        return f"/t/{_require(d, 'tag', prop)}"
    if prop == "label":
        facet = f"/l/{_require(d, 'labelset', prop)}"
        if d.get("label"):
            facet += f"/{d['label']}"
        return facet
    if prop == "resource_mimetype":
        facet = f"/n/i/{_require(d, 'type', prop)}"
        if d.get("subtype"):
            facet += f"/{d['subtype']}"
        return facet
    if prop == "field_mimetype":
        facet = f"/mt/{_require(d, 'type', prop)}"
        if d.get("subtype"):
            facet += f"/{d['subtype']}"
        return facet
    if prop == "entity":
        facet = f"/e/{_require(d, 'subtype', prop)}"
        if d.get("value"):
            facet += f"/{d['value']}"
        return facet
    if prop == "language":
        lang = _require(d, "language", prop)
        return f"/s/p/{lang}" if d.get("only_primary") else f"/s/s/{lang}"
    if prop == "origin_metadata":
        facet = f"/m/{_require(d, 'field', prop)}"
        if d.get("value"):
            facet += f"/{d['value']}"
        return facet
    if prop == "origin_path":
        facet = "/p"
        if d.get("prefix"):
            facet += "/" + str(d["prefix"]).strip("/")
        return facet
    if prop == "generated":
        if d.get("by", "data-augmentation") != "data-augmentation":
            raise ValueError(f"filter_expression: unsupported generated.by {d.get('by')!r}")
        facet = "/g/da"
        if d.get("da_task"):
            facet += f"/{d['da_task']}"
        return facet
    if prop == "kind":
        return f"/k/{str(_require(d, 'kind', prop)).lower()}"
    if prop == "origin_collaborator":
        return f"/u/o/{_require(d, 'collaborator', prop)}"
    if prop == "origin_source":
        facet = "/u/s"
        if d.get("id"):
            facet += f"/{d['id']}"
        return facet
    if prop == "status":
        return f"/n/s/{str(_require(d, 'status', prop)).upper()}"
    raise ValueError(f"filter_expression: unknown prop {prop!r}")


_FACET_PROPS = {
    "origin_tag", "label", "resource_mimetype", "field_mimetype", "entity",
    "language", "origin_metadata", "origin_path", "generated", "kind",
    "origin_collaborator", "origin_source", "status",
}
_PARAGRAPH_PROPS = {"label", "kind"}


def parse_expr(
    d: dict, resolve_slug: SlugResolver, *, paragraph: bool = False
) -> BooleanExpression:
    """One field/paragraph expression node -> BooleanExpression."""
    if not isinstance(d, dict):
        raise ValueError(f"filter_expression: node must be an object, got {d!r}")
    if "and" in d:
        return and_(*[parse_expr(x, resolve_slug, paragraph=paragraph) for x in d["and"]])
    if "or" in d:
        return or_(*[parse_expr(x, resolve_slug, paragraph=paragraph) for x in d["or"]])
    if "not" in d:
        return not_(parse_expr(d["not"], resolve_slug, paragraph=paragraph))
    prop = d.get("prop")
    if prop is None:
        raise ValueError(f"filter_expression: node needs and/or/not or prop: {d!r}")
    if paragraph and prop not in _PARAGRAPH_PROPS:
        raise ValueError(
            f"filter_expression: prop {prop!r} is not valid in a paragraph filter"
        )
    if prop in _FACET_PROPS:
        return FacetPrefixAtom(_facet_from_atom(d, prop))
    if prop == "resource":
        rid = d.get("id")
        if not rid:
            slug = _require(d, "slug", "resource (id or slug)")
            rid = resolve_slug(str(slug))
            if rid is None:
                raise ValueError(f"filter_expression: cannot find slug {slug!r}")
        return KeyPrefixAtom((f"{rid}/",))
    if prop == "field":
        ftype = FIELD_TYPE_NAME_TO_STR.get(str(_require(d, "type", "field")))
        if ftype is None:
            raise ValueError(f"filter_expression: unknown field type {d.get('type')!r}")
        return FieldAtom(field_type=ftype, field_name=d.get("name") or None)
    if prop == "resource_field_prefix":
        rid = d.get("resource_id")
        if not rid:
            slug = _require(d, "resource_slug", "resource_field_prefix")
            rid = resolve_slug(str(slug))
            if rid is None:
                raise ValueError(f"filter_expression: cannot find slug {slug!r}")
        ftype = FIELD_TYPE_NAME_TO_STR.get(str(_require(d, "field_type", "resource_field_prefix")))
        if ftype is None:
            raise ValueError(
                f"filter_expression: unknown field type {d.get('field_type')!r}"
            )
        return KeyPrefixAtom((f"{rid}/{ftype}/{d.get('field_name_prefix', '')}",))
    if prop == "keyword":
        return KeywordAtom(str(_require(d, "word", "keyword")))
    if prop in ("created", "modified"):
        since, until = d.get("since"), d.get("until")
        if since is None and until is None:
            raise ValueError(f"filter_expression: {prop} needs since or until")
        return DateRangeAtom(
            column=prop,
            since=_ts(since) if since is not None else None,
            until=_ts(until) if until is not None else None,
        )
    raise ValueError(f"filter_expression: unknown prop {prop!r}")


# ---------------------------------------------------------------------------
# key_value expressions -> JsonExpression over the kv/{schema_id} json fields
# ---------------------------------------------------------------------------


def _kv_value(v):
    """DateTime values compare as RFC3339 strings (how json fields store
    them); everything else passes through."""
    return v


def parse_kv_expr(d: dict) -> JsonExpression:
    """key_value tree -> JsonExpression. KV documents are ingested as json
    fields ``kv/{schema_id}`` with flattened paths = the schema keys
    (ingest/brain.py), so ``schema_id`` scopes via JsonPredicate.field_id."""
    if not isinstance(d, dict):
        raise ValueError(f"filter_expression: key_value node must be an object: {d!r}")
    if "and" in d:
        return JsonAnd([parse_kv_expr(x) for x in d["and"]])
    if "or" in d:
        return JsonOr([parse_kv_expr(x) for x in d["or"]])
    if "not" in d:
        from ..index.json import JsonNot

        return JsonNot(parse_kv_expr(d["not"]))
    schema_id = str(_require(d, "schema_id", "key_value"))
    key = str(_require(d, "key", "key_value"))
    field_id = f"kv/{schema_id}"

    def pred(path, op, value):
        return JsonPredicate(path=path, op=op, value=value, field_id=field_id)

    if "eq" in d:
        return pred(key, "eq", _kv_value(d["eq"]))
    if "gte" in d or "lte" in d:
        parts = []
        if d.get("gte") is not None:
            parts.append(pred(key, "gte", _kv_value(d["gte"])))
        if d.get("lte") is not None:
            parts.append(pred(key, "lte", _kv_value(d["lte"])))
        return parts[0] if len(parts) == 1 else JsonAnd(parts)
    if "contains" in d:
        v = _kv_value(d["contains"])
        # a repeated field contains v when any of its values equals v; a
        # range field {gte, lte} contains v when gte <= v <= lte — a field
        # is one or the other, so OR of both readings is exact
        return JsonOr([
            pred(key, "eq", v),
            JsonAnd([
                pred(f"{key}.gte", "lte", v),
                pred(f"{key}.lte", "gte", v),
            ]),
        ])
    raise ValueError(f"filter_expression: key_value needs eq/gte/lte/contains: {d!r}")


def parse_filter_expression(f, resolve_slug: SlugResolver):
    """models.api.FilterExpression (rich form) ->
    (field_expr, paragraph_expr, json_expr, operator)."""
    field_expr = (
        parse_expr(f.field, resolve_slug) if f.field is not None else None
    )
    para_expr = (
        parse_expr(f.paragraph, resolve_slug, paragraph=True)
        if f.paragraph is not None
        else None
    )
    json_expr = parse_kv_expr(f.key_value) if f.key_value is not None else None
    return field_expr, para_expr, json_expr, f.operator or "and"
