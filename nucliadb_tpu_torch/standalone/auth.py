"""Standalone auth policies.

The port's copy of ``nucliadb_tpu/standalone/auth.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity: reference standalone/auth.py — the standalone server trusts an
upstream proxy to authenticate and forwards identity/roles via headers
(UPSTREAM_NAIVE), or runs without auth (the reference's default local mode).
An `api_key` policy adds self-contained static bearer tokens mapped to
roles. Roles mirror NucliaDBRoles: READER / WRITER / MANAGER.

Route classification: search/read surfaces need READER, content writes need
WRITER, KB lifecycle + admin need MANAGER (reference writer/reader/search
api `requires_one` annotations).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..http import HTTPError, Request

READER = "READER"
WRITER = "WRITER"
MANAGER = "MANAGER"

import re as _re

# POST endpoints that are reads (retrieval surfaces). ANCHORED patterns —
# matching on a path suffix would let a client forge READER access by
# naming an object 'ask'/'find' (e.g. POST /labelset/ask).
_READER_POST_RE = _re.compile(
    r"^/api/v1/kb/[^/]+/"
    r"(find|search|suggest|catalog(/facets)?|graph(/nodes|/relations)?|ask"
    r"|summarize|hydrate|augment|feedback|retrieve|predict/[^/]+"
    # resource-scoped retrieval (rid and slug twins) is a read surface too
    r"|(resource/[^/]+|slug/[^/]+)/(find|search|ask))$"
)

# management-only read surfaces: KB enumeration, full-data exports, backups,
# admin introspection
_MANAGER_GET_RE = _re.compile(
    r"^(/api/v1/kbs$|/api/v1/admin|/api/v1/backups"
    r"|/api/v1/kb/[^/]+/export(/|$))"
)


@dataclass
class AuthSettings:
    policy: str = "insecure"  # insecure | upstream_naive | api_key
    roles_header: str = "x-nucliadb-roles"
    user_header: str = "x-nucliadb-user"
    # api_key policy: token -> roles
    api_keys: dict[str, list[str]] = field(default_factory=dict)
    # HMAC secret for short-lived temp access tokens (parity: the
    # reference's JWE temp tokens, standalone/api_router.py
    # get_temp_access_token — used e.g. in download URLs where headers
    # cannot be set). Auto-generated per process when empty.
    token_secret: str = ""

    def secret(self) -> bytes:
        if not self.token_secret:
            import secrets

            self.token_secret = secrets.token_hex(32)
        return self.token_secret.encode()


TEMP_TOKEN_TTL_S = 5 * 60  # parity: TEMP_TOKEN_EXPIRATION


def issue_temp_token(
    settings: AuthSettings, username: str, roles: list[str],
    ttl_s: float = TEMP_TOKEN_TTL_S,
) -> str:
    """Signed short-lived token carrying the caller's identity + roles."""
    import base64
    import hashlib
    import hmac as _hmac
    import json
    import time

    payload = json.dumps(
        {"exp": time.time() + ttl_s, "username": username, "scopes": roles}
    ).encode()
    sig = _hmac.new(settings.secret(), payload, hashlib.sha256).digest()
    return (
        base64.urlsafe_b64encode(payload).decode().rstrip("=")
        + "."
        + base64.urlsafe_b64encode(sig).decode().rstrip("=")
    )


def verify_temp_token(settings: AuthSettings, token: str) -> Optional[list[str]]:
    """Roles carried by a valid, unexpired temp token; None otherwise."""
    import base64
    import hashlib
    import hmac as _hmac
    import json
    import time

    try:
        payload_b64, sig_b64 = token.split(".", 1)
        pad = lambda s: s + "=" * (-len(s) % 4)
        payload = base64.urlsafe_b64decode(pad(payload_b64))
        sig = base64.urlsafe_b64decode(pad(sig_b64))
    except Exception:
        return None
    want = _hmac.new(settings.secret(), payload, hashlib.sha256).digest()
    if not _hmac.compare_digest(sig, want):
        return None
    try:
        claims = json.loads(payload)
    except ValueError:
        return None
    if float(claims.get("exp", 0)) < time.time():
        return None
    return [str(r).upper() for r in claims.get("scopes", [])]


def required_role(method: str, path: str) -> Optional[str]:
    """Role needed for a route; None = open (health, metrics, docs)."""
    if (
        path in ("/", "/metrics", "/api/v1/openapi.json")
        or path.startswith("/health")
    ):
        return None
    if method == "OPTIONS":
        # CORS preflights carry no credentials (browsers strip them) and
        # trigger no action; requiring a role here locks out every
        # cross-origin client regardless of its keys
        return None
    if method in ("GET", "HEAD"):
        return MANAGER if _MANAGER_GET_RE.match(path) else READER
    if method == "POST" and _READER_POST_RE.match(path):
        return READER
    # KB lifecycle + admin + import/backup restore are management surface
    if path == "/api/v1/kbs" or path.startswith(
        ("/api/v1/admin", "/api/v1/kbs/import", "/api/v1/backups")
    ):
        return MANAGER
    if method == "DELETE" and path.count("/") == 4 and path.startswith("/api/v1/kb/"):
        return MANAGER  # DELETE /api/v1/kb/{kbid}
    return WRITER


def _roles_for(settings: AuthSettings, request: Request) -> Optional[list[str]]:
    """None = unauthenticated."""
    if settings.policy == "insecure":
        return [READER, WRITER, MANAGER]
    # temp tokens work under every authenticated policy — via the eph-token
    # query param (download links cannot set headers) or a bearer token
    eph = request.query.get("eph-token")
    if eph:
        roles = verify_temp_token(settings, eph)
        if roles is not None:
            return roles
    if settings.policy == "upstream_naive":
        raw = request.headers.get(settings.roles_header)
        if raw is None or settings.user_header not in request.headers:
            return None
        return [r.strip().upper() for r in raw.split(";") if r.strip()]
    if settings.policy == "api_key":
        auth = request.headers.get("authorization", "")
        token = auth[7:] if auth.lower().startswith("bearer ") else (
            request.headers.get("x-nuclia-nuakey") or ""
        )
        roles = settings.api_keys.get(token)
        return list(roles) if roles is not None else None
    raise ValueError(f"unknown auth policy {settings.policy!r}")


def make_auth_hook(settings: AuthSettings):
    """Returns a callable(request) raising 401/403, or None when open."""
    if settings.policy == "insecure":
        return None

    def hook(request: Request) -> None:
        need = required_role(request.method, request.path)
        if need is None:
            return
        roles = _roles_for(settings, request)
        if roles is None:
            raise HTTPError(401, "missing or invalid credentials")
        if need not in roles and MANAGER not in roles:
            raise HTTPError(403, f"requires role {need}")

    return hook
