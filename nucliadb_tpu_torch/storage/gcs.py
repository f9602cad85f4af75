"""Google Cloud Storage backend over the JSON API.

The port's copy of ``nucliadb_tpu/storage/gcs.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity: reference `nucliadb_utils/storages/gcs.py` (aiohttp against
storage.googleapis.com) and nidx's object_store GCS kind. Speaks the GCS
JSON/upload REST surface directly over httpx: media upload
(`/upload/storage/v1/b/{bucket}/o?uploadType=media`), media download
(`?alt=media`), objects list with pageToken pagination, delete.

Auth: bearer tokens via a pluggable callable (service-account token
exchange or metadata-server fetch live behind it; in tests a static
token). The reference refreshes its token the same way (gcs.py
_get_access_token).
"""

from __future__ import annotations

import json
from typing import Callable, Iterable, Optional
from urllib.parse import quote

import httpx


class GCSStorage:
    def __init__(
        self,
        bucket: str,
        *,
        endpoint: str = "https://storage.googleapis.com",
        token_provider: Optional[Callable[[], str]] = None,
        prefix: str = "",
        client: Optional[httpx.Client] = None,
    ):
        self.bucket = bucket
        self.endpoint = endpoint.rstrip("/")
        self.token_provider = token_provider or (lambda: "")
        self.prefix = prefix
        self._client = client or httpx.Client(timeout=60)

    def _headers(self) -> dict[str, str]:
        token = self.token_provider()
        return {"Authorization": f"Bearer {token}"} if token else {}

    def _obj(self, key: str) -> str:
        return quote(self.prefix + key, safe="")

    # ---- Storage interface -------------------------------------------

    def put(self, key: str, data: bytes) -> None:
        resp = self._client.post(
            f"{self.endpoint}/upload/storage/v1/b/{self.bucket}/o",
            params={"uploadType": "media", "name": self.prefix + key},
            content=bytes(data),
            headers={**self._headers(), "Content-Type": "application/octet-stream"},
        )
        if resp.status_code != 200:
            raise IOError(f"GCS upload {key}: {resp.status_code} {resp.text[:200]}")

    def get(self, key: str) -> bytes:
        resp = self._client.get(
            f"{self.endpoint}/storage/v1/b/{self.bucket}/o/{self._obj(key)}",
            params={"alt": "media"},
            headers=self._headers(),
        )
        if resp.status_code == 404:
            raise KeyError(key)
        if resp.status_code != 200:
            raise IOError(f"GCS get {key}: {resp.status_code}")
        return resp.content

    def exists(self, key: str) -> bool:
        resp = self._client.get(
            f"{self.endpoint}/storage/v1/b/{self.bucket}/o/{self._obj(key)}",
            headers=self._headers(),
        )
        if resp.status_code == 200:
            return True
        if resp.status_code == 404:
            return False
        # an auth/server failure must NOT read as "missing" — callers treat
        # False as ground truth (export lookups, purge decisions)
        raise IOError(f"GCS exists {key}: {resp.status_code}")

    def delete(self, key: str) -> None:
        resp = self._client.delete(
            f"{self.endpoint}/storage/v1/b/{self.bucket}/o/{self._obj(key)}",
            headers=self._headers(),
        )
        if resp.status_code not in (204, 404):
            raise IOError(f"GCS delete {key}: {resp.status_code}")

    def list(self, prefix: str = "") -> Iterable[str]:
        out: list[str] = []
        token: Optional[str] = None
        while True:
            params = {"prefix": self.prefix + prefix, "maxResults": "1000"}
            if token:
                params["pageToken"] = token
            resp = self._client.get(
                f"{self.endpoint}/storage/v1/b/{self.bucket}/o",
                params=params,
                headers=self._headers(),
            )
            if resp.status_code != 200:
                raise IOError(f"GCS list: {resp.status_code}")
            payload = json.loads(resp.text)
            out.extend(
                item["name"][len(self.prefix):] for item in payload.get("items", [])
            )
            token = payload.get("nextPageToken")
            if not token:
                break
        return sorted(out)
