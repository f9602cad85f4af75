"""Azure Blob Storage backend over the Blob REST API.

The port's copy of ``nucliadb_tpu/storage/azure.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity: reference `nucliadb_utils/storages/azure.py` (azure-storage-blob
SDK). No Azure SDK in this image, so the backend speaks the Blob service
REST surface with SharedKey authorization: Put Blob (BlockBlob), Get Blob,
Delete Blob, List Blobs (flat listing with marker pagination).

SharedKey signing per
https://learn.microsoft.com/rest/api/storageservices/authorize-with-shared-key
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import re
from typing import Iterable, Optional
from urllib.parse import quote

import httpx

from xml.sax.saxutils import unescape as _sax_unescape


def _xml_unescape(s: str) -> str:
    return _sax_unescape(s, {"&quot;": '"', "&apos;": "'"})


_API_VERSION = "2023-11-03"


def sign_shared_key(
    method: str,
    account: str,
    path: str,
    query: dict[str, str],
    headers: dict[str, str],
    account_key: str,
    content_length: int,
) -> str:
    """Returns the SharedKey Authorization header value. Split out so tests
    can verify signatures with an independent implementation."""
    ms_headers = sorted(
        (k.lower(), v.strip()) for k, v in headers.items()
        if k.lower().startswith("x-ms-")
    )
    canonical_headers = "".join(f"{k}:{v}\n" for k, v in ms_headers)
    canonical_resource = f"/{account}{path}"
    for k in sorted(query):
        canonical_resource += f"\n{k.lower()}:{query[k]}"
    string_to_sign = "\n".join(
        [
            method,
            "",  # Content-Encoding
            "",  # Content-Language
            str(content_length) if content_length else "",
            "",  # Content-MD5
            headers.get("Content-Type", ""),
            "",  # Date (x-ms-date used instead)
            "",  # If-Modified-Since
            "",  # If-Match
            "",  # If-None-Match
            "",  # If-Unmodified-Since
            "",  # Range
            canonical_headers + canonical_resource,
        ]
    )
    signature = base64.b64encode(
        hmac.new(
            base64.b64decode(account_key), string_to_sign.encode(), hashlib.sha256
        ).digest()
    ).decode()
    return f"SharedKey {account}:{signature}"


class AzureStorage:
    def __init__(
        self,
        account: str,
        account_key: str,
        container: str,
        *,
        endpoint: Optional[str] = None,  # default https://{account}.blob.core.windows.net
        prefix: str = "",
        client: Optional[httpx.Client] = None,
    ):
        self.account = account
        self.account_key = account_key
        self.container = container
        self.endpoint = (endpoint or f"https://{account}.blob.core.windows.net").rstrip("/")
        self.prefix = prefix
        self._client = client or httpx.Client(timeout=60)

    def _request(
        self,
        method: str,
        key: str = "",
        *,
        query: Optional[dict[str, str]] = None,
        body: bytes = b"",
        extra_headers: Optional[dict[str, str]] = None,
        ok: tuple[int, ...] = (200,),
    ) -> httpx.Response:
        query = query or {}
        path = f"/{self.container}"
        if key:
            path += f"/{self.prefix}{key}"
        now = datetime.datetime.now(datetime.timezone.utc)
        headers = {
            "x-ms-date": now.strftime("%a, %d %b %Y %H:%M:%S GMT"),
            "x-ms-version": _API_VERSION,
            **(extra_headers or {}),
        }
        # CanonicalizedResource is the ENCODED URI path (SharedKey spec):
        # signing the raw path 403s for any key needing percent-encoding
        enc_path = quote(path, safe="-._~/")
        headers["Authorization"] = sign_shared_key(
            method, self.account, enc_path, query, headers, self.account_key, len(body)
        )
        resp = self._client.request(
            method,
            self.endpoint + enc_path,
            params=query,
            content=body,
            headers=headers,
        )
        if resp.status_code not in ok:
            raise IOError(
                f"Azure {method} {path}: {resp.status_code} {resp.text[:200]}"
            )
        return resp

    # ---- Storage interface -------------------------------------------

    def put(self, key: str, data: bytes) -> None:
        self._request(
            "PUT", key, body=bytes(data),
            extra_headers={"x-ms-blob-type": "BlockBlob"}, ok=(201,),
        )

    def get(self, key: str) -> bytes:
        resp = self._request("GET", key, ok=(200, 404))
        if resp.status_code == 404:
            raise KeyError(key)
        return resp.content

    def exists(self, key: str) -> bool:
        return self._request("HEAD", key, ok=(200, 404)).status_code == 200

    def delete(self, key: str) -> None:
        self._request("DELETE", key, ok=(202, 404))

    def list(self, prefix: str = "") -> Iterable[str]:
        out: list[str] = []
        marker = ""
        while True:
            query = {
                "restype": "container",
                "comp": "list",
                "prefix": self.prefix + prefix,
                "maxresults": "1000",
            }
            if marker:
                query["marker"] = marker
            text = self._request("GET", "", query=query).text
            out.extend(
                _xml_unescape(m)[len(self.prefix):]
                for m in re.findall(r"<Name>(.*?)</Name>", text)
            )
            nxt = re.search(r"<NextMarker>(.+?)</NextMarker>", text)
            if nxt:
                marker = nxt.group(1)
            else:
                break
        return sorted(out)
