"""S3-compatible object storage backend.

The port's copy of ``nucliadb_tpu/storage/s3.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity: reference `nucliadb_utils/storages/s3.py` (aiobotocore) and nidx's
`object_store` S3 backend (nidx/src/settings.rs ObjectStoreKind::S3). This
image carries no AWS SDK, so the backend speaks the S3 REST API directly
over httpx with AWS Signature Version 4 request signing — which also makes
it work against any S3-compatible endpoint (MinIO, Ceph, GCS interop).

Implemented surface (all the Storage interface needs): PutObject, GetObject,
HeadObject, DeleteObject, ListObjectsV2 with continuation-token pagination.
"""

from __future__ import annotations

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


_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _uri_encode(value: str, *, encode_slash: bool) -> str:
    safe = "-._~" if encode_slash else "-._~/"
    return quote(value, safe=safe)


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sign_v4(
    method: str,
    host: str,
    path: str,
    query: dict[str, str],
    headers: dict[str, str],
    payload_hash: str,
    *,
    access_key: str,
    secret_key: str,
    region: str,
    service: str = "s3",
    now: Optional[datetime.datetime] = None,
) -> dict[str, str]:
    """AWS SigV4 (https://docs.aws.amazon.com/IAM/latest/UserGuide/
    create-signed-request.html). Returns the headers to add (incl.
    Authorization). Split out so tests can verify signatures independently."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date_stamp = now.strftime("%Y%m%d")

    all_headers = {k.lower(): v.strip() for k, v in headers.items()}
    all_headers["host"] = host
    all_headers["x-amz-date"] = amz_date
    all_headers["x-amz-content-sha256"] = payload_hash

    signed_names = sorted(all_headers)
    canonical_headers = "".join(f"{k}:{all_headers[k]}\n" for k in signed_names)
    signed_headers = ";".join(signed_names)
    canonical_query = "&".join(
        f"{_uri_encode(k, encode_slash=True)}={_uri_encode(v, encode_slash=True)}"
        for k, v in sorted(query.items())
    )
    canonical_request = "\n".join(
        [
            method,
            _uri_encode(path, encode_slash=False),
            canonical_query,
            canonical_headers,
            signed_headers,
            payload_hash,
        ]
    )
    scope = f"{date_stamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        [
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canonical_request.encode()).hexdigest(),
        ]
    )
    k_date = _hmac(("AWS4" + secret_key).encode(), date_stamp)
    k_region = _hmac(k_date, region)
    k_service = _hmac(k_region, service)
    k_signing = _hmac(k_service, "aws4_request")
    signature = hmac.new(k_signing, string_to_sign.encode(), hashlib.sha256).hexdigest()
    return {
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_hash,
        "Authorization": (
            f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}"
        ),
    }


class S3Storage:
    """Storage over an S3-compatible endpoint (path-style addressing)."""

    def __init__(
        self,
        endpoint: str,
        bucket: str,
        access_key: str,
        secret_key: str,
        *,
        region: str = "us-east-1",
        prefix: str = "",
        client: Optional[httpx.Client] = None,
    ):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.prefix = prefix
        self._client = client or httpx.Client(timeout=60)
        self._host = re.sub(r"^https?://", "", self.endpoint)

    # ------------------------------------------------------------------

    def _request(
        self,
        method: str,
        key: str = "",
        *,
        query: Optional[dict[str, str]] = None,
        body: bytes = b"",
        ok: tuple[int, ...] = (200,),
    ) -> httpx.Response:
        query = query or {}
        path = f"/{self.bucket}"
        if key:
            path += f"/{self.prefix}{key}"
        payload_hash = hashlib.sha256(body).hexdigest() if body else _EMPTY_SHA256
        headers = sign_v4(
            method, self._host, path, query, {}, payload_hash,
            access_key=self.access_key, secret_key=self.secret_key,
            region=self.region,
        )
        resp = self._client.request(
            method,
            self.endpoint + quote(path, safe="-._~/"),
            params=query,
            content=body,
            headers=headers,
        )
        if resp.status_code not in ok:
            raise IOError(
                f"S3 {method} {path}: {resp.status_code} {resp.text[:200]}"
            )
        return resp

    # ---- Storage interface -------------------------------------------

    def put(self, key: str, data: bytes) -> None:
        self._request("PUT", key, body=bytes(data))

    def get(self, key: str) -> bytes:
        resp = self._request("GET", key, ok=(200, 404))
        if resp.status_code == 404:
            raise KeyError(key)
        return resp.content

    def exists(self, key: str) -> bool:
        resp = self._request("HEAD", key, ok=(200, 404))
        return resp.status_code == 200

    def delete(self, key: str) -> None:
        self._request("DELETE", key, ok=(204, 200, 404))

    def list(self, prefix: str = "") -> Iterable[str]:
        out: list[str] = []
        token: Optional[str] = None
        while True:
            query = {
                "list-type": "2",
                "prefix": self.prefix + prefix,
                "max-keys": "1000",
            }
            if token:
                query["continuation-token"] = token
            text = self._request("GET", "", query=query).text
            out.extend(
                # keys with &/</> come back XML-escaped; unescape or the
                # listed name misses the real object on get/delete
                _xml_unescape(m)[len(self.prefix):]
                for m in re.findall(r"<Key>(.*?)</Key>", text)
            )
            truncated = re.search(r"<IsTruncated>true</IsTruncated>", text)
            next_tok = re.search(
                r"<NextContinuationToken>(.*?)</NextContinuationToken>", text
            )
            if truncated and next_tok:
                token = next_tok.group(1)
            else:
                break
        return sorted(out)
