"""KB-scoped vocabulary services: labelsets, entity groups, synonyms.

The port's copy of ``nucliadb_tpu/common/kb_services.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's writer "services" endpoints
(nucliadb/src/nucliadb/writer/api/v1/services.py — labelsets CRUD, entities
groups CRUD, custom synonyms) with state in the main KV. Synonyms feed query
expansion in search (the reference applies them in the query parser).
"""

from __future__ import annotations

import json
from typing import Optional

from ..maindb import Driver

LABELSET_KEY = "/kbs/{kbid}/labels/{labelset}"
LABELSET_PREFIX = "/kbs/{kbid}/labels/"
ENTITIES_KEY = "/kbs/{kbid}/entities/{group}"
ENTITIES_PREFIX = "/kbs/{kbid}/entities/"
SYNONYMS_KEY = "/kbs/{kbid}/synonyms"


class LabelsService:
    def __init__(self, driver: Driver):
        self.driver = driver

    def set_labelset(self, kbid: str, labelset: str, definition: dict) -> None:
        """definition: {title, color, multiple, kind, labels: [{title, ...}]}"""
        with self.driver as txn:
            txn.set(
                LABELSET_KEY.format(kbid=kbid, labelset=labelset),
                json.dumps(definition).encode(),
            )

    def get_labelset(self, kbid: str, labelset: str) -> Optional[dict]:
        with self.driver as txn:
            raw = txn.get(LABELSET_KEY.format(kbid=kbid, labelset=labelset))
        return json.loads(raw) if raw else None

    def list_labelsets(self, kbid: str) -> dict[str, dict]:
        prefix = LABELSET_PREFIX.format(kbid=kbid)
        with self.driver as txn:
            keys = list(txn.keys(prefix))
            out = {}
            for key in keys:
                raw = txn.get(key)
                if raw:
                    out[key[len(prefix):]] = json.loads(raw)
        return out

    def delete_labelset(self, kbid: str, labelset: str) -> None:
        with self.driver as txn:
            txn.delete(LABELSET_KEY.format(kbid=kbid, labelset=labelset))


class EntitiesService:
    def __init__(self, driver: Driver):
        self.driver = driver

    def set_group(self, kbid: str, group: str, definition: dict) -> None:
        """definition: {title, color, entities: {name: {value, represents...}}}"""
        with self.driver as txn:
            txn.set(
                ENTITIES_KEY.format(kbid=kbid, group=group),
                json.dumps(definition).encode(),
            )

    def get_group(self, kbid: str, group: str) -> Optional[dict]:
        with self.driver as txn:
            raw = txn.get(ENTITIES_KEY.format(kbid=kbid, group=group))
        return json.loads(raw) if raw else None

    def list_groups(self, kbid: str) -> list[str]:
        prefix = ENTITIES_PREFIX.format(kbid=kbid)
        with self.driver as txn:
            return [k[len(prefix):] for k in txn.keys(prefix)]

    def delete_group(self, kbid: str, group: str) -> None:
        with self.driver as txn:
            txn.delete(ENTITIES_KEY.format(kbid=kbid, group=group))


class SynonymsService:
    def __init__(self, driver: Driver):
        self.driver = driver

    def set_synonyms(self, kbid: str, synonyms: dict[str, list[str]]) -> None:
        with self.driver as txn:
            txn.set(SYNONYMS_KEY.format(kbid=kbid), json.dumps(synonyms).encode())

    def get_synonyms(self, kbid: str) -> dict[str, list[str]]:
        with self.driver as txn:
            raw = txn.get(SYNONYMS_KEY.format(kbid=kbid))
        return json.loads(raw) if raw else {}

    def delete_synonyms(self, kbid: str) -> None:
        with self.driver as txn:
            txn.delete(SYNONYMS_KEY.format(kbid=kbid))

    def expand_query(self, kbid: str, query: str) -> str:
        """Append custom synonyms of query terms (parity: the query parser's
        with_synonyms behavior — expanded terms join the keyword search)."""
        synonyms = self.get_synonyms(kbid)
        if not synonyms:
            return query
        from ..index.text_engine.tokenizer import tokenize

        extra: list[str] = []
        lowered = {k.lower(): v for k, v in synonyms.items()}
        for token in tokenize(query):
            extra.extend(lowered.get(token, []))
        return query if not extra else f"{query} {' '.join(extra)}"
