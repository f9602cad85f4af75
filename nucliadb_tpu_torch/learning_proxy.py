"""Learning configuration proxy.

The port's copy of ``nucliadb_tpu/learning_proxy.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's learning_proxy
(nucliadb/src/nucliadb/learning_proxy.py): per-KB learning configuration
(which embedding model / generative model the platform uses) with a proxy
seam to an external learning backend. Embedded deployments keep the config
in KV and serve it locally; if a backend base_url is configured, calls
proxy through (httpx) — this image is egress-free so that path is exercised
only in tests with local servers.
"""

from __future__ import annotations

import json
from typing import Any, Optional

import httpx

from .maindb import Driver
from .utils.encryption import Endecryptor

LEARNING_KEY = "/kbs/{kbid}/learning/config"

# fields holding credentials: encrypted at rest when NDBTPU_ENCRYPTION_KEY
# is set (parity: the reference encrypts learning secrets via
# nucliadb_utils encryption)
SECRET_FIELDS = {"api_key", "openai_key", "azure_key", "user_token"}


class LearningProxy:
    def __init__(self, driver: Driver, base_url: Optional[str] = None,
                 endecryptor: Optional[Endecryptor] = None):
        self.driver = driver
        self.base_url = base_url
        self.endecryptor = endecryptor or Endecryptor()

    def get_configuration(self, kbid: str) -> dict[str, Any]:
        if self.base_url:
            resp = httpx.get(f"{self.base_url}/config/{kbid}", timeout=10)
            resp.raise_for_status()
            return resp.json()
        with self.driver as txn:
            raw = txn.get(LEARNING_KEY.format(kbid=kbid))
        config = json.loads(raw) if raw else {}
        return {
            k: self.endecryptor.decrypt(v) if k in SECRET_FIELDS and isinstance(v, str) else v
            for k, v in config.items()
        }

    def set_configuration(self, kbid: str, config: dict[str, Any]) -> dict[str, Any]:
        if self.base_url:
            resp = httpx.patch(
                f"{self.base_url}/config/{kbid}", json=config, timeout=10
            )
            resp.raise_for_status()
            return resp.json()
        # read+merge+write in ONE transaction (the driver lock spans the
        # with-block) — separate txns lost concurrent updates' fields
        with self.driver as txn:
            raw = txn.get(LEARNING_KEY.format(kbid=kbid))
            current = {
                k: self.endecryptor.decrypt(v)
                if k in SECRET_FIELDS and isinstance(v, str) else v
                for k, v in (json.loads(raw) if raw else {}).items()
            }
            current.update(config)
            stored = {
                k: self.endecryptor.encrypt(v)
                if k in SECRET_FIELDS and isinstance(v, str) else v
                for k, v in current.items()
            }
            txn.set(LEARNING_KEY.format(kbid=kbid), json.dumps(stored).encode())
        return current

    def delete_configuration(self, kbid: str) -> None:
        if self.base_url:
            # get/set proxy to the backend — delete must too, or the
            # "deleted" config reappears on the next GET
            resp = httpx.delete(f"{self.base_url}/config/{kbid}", timeout=10)
            resp.raise_for_status()
            return
        with self.driver as txn:
            txn.delete(LEARNING_KEY.format(kbid=kbid))

    def get_schema(self, kbid: str) -> dict[str, Any]:
        """JSON schema of the configuration fields (parity: GET /schema —
        the reference proxies the learning API's schema; embedded serves
        the known-field schema below)."""
        if self.base_url:
            resp = httpx.get(f"{self.base_url}/schema/{kbid}", timeout=10)
            resp.raise_for_status()
            return resp.json()
        return {
            "title": "LearningConfiguration",
            "type": "object",
            "properties": dict(KNOWN_FIELDS),
            "additionalProperties": False,
        }

    def validate_fields(self, config: dict[str, Any]) -> None:
        """Reject unknown configuration fields (the reference's POST
        /configuration 422s on fields the schema doesn't know)."""
        unknown = sorted(set(config) - set(KNOWN_FIELDS))
        if unknown:
            raise ValueError(f"unknown configuration fields: {', '.join(unknown)}")

    # ---- extract / split strategies (parity: writer/api/v1/
    # learning_config.py add_strategy/delete_strategy — proxied CRUD on the
    # learning backend; embedded deployments keep them in KV) -------------

    STRATEGY_KEY = "/kbs/{kbid}/learning/{kind}_strategies"

    def _strategies(self, kbid: str, kind: str) -> dict[str, Any]:
        with self.driver as txn:
            raw = txn.get(self.STRATEGY_KEY.format(kbid=kbid, kind=kind))
        return json.loads(raw) if raw else {}

    def add_strategy(self, kbid: str, kind: str, config: dict[str, Any]) -> str:
        if self.base_url:
            resp = httpx.post(
                f"{self.base_url}/{kind}_strategies/{kbid}", json=config, timeout=10
            )
            resp.raise_for_status()
            return resp.json()
        import uuid

        sid = uuid.uuid4().hex[:8]
        with self.driver as txn:  # RMW in one txn (no lost updates)
            raw = txn.get(self.STRATEGY_KEY.format(kbid=kbid, kind=kind))
            strategies = json.loads(raw) if raw else {}
            strategies[sid] = config
            txn.set(
                self.STRATEGY_KEY.format(kbid=kbid, kind=kind),
                json.dumps(strategies).encode(),
            )
        return sid

    def list_strategies(self, kbid: str, kind: str) -> dict[str, Any]:
        if self.base_url:
            resp = httpx.get(f"{self.base_url}/{kind}_strategies/{kbid}", timeout=10)
            resp.raise_for_status()
            return resp.json()
        return self._strategies(kbid, kind)

    def get_strategy(self, kbid: str, kind: str, sid: str) -> Optional[dict]:
        if self.base_url:
            # list/add proxy to the backend — reads must too (local KV is
            # empty when a backend owns the strategies)
            return self.list_strategies(kbid, kind).get(sid)
        return self._strategies(kbid, kind).get(sid)

    def delete_strategy(self, kbid: str, kind: str, sid: str) -> bool:
        if self.base_url:
            # reference parity: the learning API's delete path nests a
            # '/strategies/' segment (writer/api/v1/learning_config.py:99)
            resp = httpx.delete(
                f"{self.base_url}/{kind}_strategies/{kbid}/strategies/{sid}",
                timeout=10,
            )
            resp.raise_for_status()
            return True
        with self.driver as txn:  # RMW in one txn (no lost updates)
            raw = txn.get(self.STRATEGY_KEY.format(kbid=kbid, kind=kind))
            strategies = json.loads(raw) if raw else {}
            if sid not in strategies:
                return False
            del strategies[sid]
            txn.set(
                self.STRATEGY_KEY.format(kbid=kbid, kind=kind),
                json.dumps(strategies).encode(),
            )
        return True

    def generative_providers(self, kbid: str) -> dict[str, Any]:
        """Provider → generative-model listing (parity: GET
        /generative_providers). Embedded deployments report the locally
        configured generative model under the 'local' provider."""
        if self.base_url:
            resp = httpx.get(
                f"{self.base_url}/generative_providers/{kbid}", timeout=10
            )
            resp.raise_for_status()
            return resp.json()
        config = self.get_configuration(kbid)
        model = config.get("generative_model") or ""
        return {
            "providers": {
                "local": {"models": [model] if model else [], "default": model}
            }
        }


# Configuration fields mirroring the reference's LearningConfiguration
# (learning_proxy.py:87-107) + the generation/NER/summary settings its
# learning API schema exposes; secret fields encrypt at rest.
KNOWN_FIELDS: dict[str, dict] = {
    "semantic_model": {"type": "string"},
    "semantic_models": {"type": "array", "items": {"type": "string"}},
    "semantic_vector_similarity": {"type": "string"},
    "semantic_vector_size": {"type": ["integer", "null"]},
    "semantic_threshold": {"type": ["number", "null"]},
    "semantic_matryoshka_dims": {"type": "array", "items": {"type": "integer"}},
    "generative_model": {"type": "string"},
    "anonymization_model": {"type": "string"},
    "ner_model": {"type": "string"},
    "relation_model": {"type": "string"},
    "summary": {"type": "string"},
    "summary_model": {"type": "string"},
    "summary_prompt": {"type": "object"},
    "resource_labelers_models": {"type": "array", "items": {"type": "string"}},
    "user_keys": {"type": "object"},
    "user_prompts": {"type": "object"},
    "visual_labeling": {"type": "string"},
    **{name: {"type": "string"} for name in sorted(SECRET_FIELDS)},
}
