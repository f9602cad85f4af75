"""TUS 1.0.0 resumable uploads (creation + creation-defer-length).

The port's copy of ``nucliadb_tpu/standalone/tus.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity: reference writer TUS endpoints
(nucliadb/src/nucliadb/writer/api/v1/upload.py:93-635 and writer/tus/) —
POST creates an upload session, HEAD reports the committed offset, PATCH
appends `application/offset+octet-stream` chunks at the declared offset and
finalizes when offset == Upload-Length.

Object-store-friendly layout: each PATCH chunk is stored as its own
immutable object `tus/{kbid}/{upload_id}/{index:08d}` (the reference rides
S3/GCS multipart uploads the same way, writer/tus/s3.py append_data);
finalize concatenates chunks into the blob key and records the file field.
"""

from __future__ import annotations

import base64
import hashlib
import json
import re
import threading
import time
import uuid
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field
from typing import Optional

from ..maindb import Driver
from ..storage import Storage

TUS_HEADERS = {
    "Tus-Resumable": "1.0.0",
    "Tus-Version": "1.0.0",
    "Tus-Extension": "creation-defer-length",
}

TUS_KEY = "/kbs/{kbid}/tus/{upload_id}"
CHUNK_KEY = "tus/{kbid}/{upload_id}/{index:08d}"
FILE_FIELD_KEY = "/kbs/{kbid}/r/{rid}/files/{field}"
BLOB_KEY = "blobs/{kbid}/{rid}/{field}"

# stale sessions are garbage-collected after this many seconds
SESSION_TTL = 24 * 3600

_TUS_SESSION_KEY_RE = re.compile(r"^/kbs/[^/]+/tus/[^/]+$")


class TusError(Exception):
    def __init__(self, status: int, detail: str):
        self.status = status
        self.detail = detail
        super().__init__(detail)


@dataclass
class TusSession:
    upload_id: str
    kbid: str
    rid: str
    field: str
    size: int = -1  # -1 = deferred (Upload-Defer-Length)
    offset: int = 0
    chunks: int = 0
    filename: str = ""
    content_type: str = "application/octet-stream"
    language: Optional[str] = None
    md5: Optional[str] = None
    created: float = field(default_factory=time.time)

    def to_json(self) -> bytes:
        return json.dumps(asdict(self)).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "TusSession":
        return cls(**json.loads(raw))


def parse_upload_metadata(header: str) -> dict[str, str]:
    """`Upload-Metadata: key1 b64val1,key2 b64val2` (TUS creation ext)."""
    out: dict[str, str] = {}
    for part in header.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, value = part.partition(" ")
        if not name:
            raise TusError(400, f"Upload-Metadata header contains errors: {part!r}")
        try:
            out[name] = base64.b64decode(value).decode() if value.strip() else ""
        except Exception:
            # the reference tolerates unencoded values (maybe_b64decode)
            out[name] = value.strip()
    return out


def deterministic_upload_id(kbid: str, rid: str, field: str) -> str:
    """Field-addressed uploads resume across clients (parity:
    upload.py:285 md5(kbid__rid__field))."""
    return hashlib.md5(f"{kbid}__{rid}__{field}".encode()).hexdigest()


class TusManager:
    def __init__(self, driver: Driver, storage: Storage):
        self.driver = driver
        self.storage = storage
        self._mutex = threading.Lock()  # guards the session-lock map only
        # per-upload locks: chunk PUTs can take seconds on cloud backends;
        # one global lock would serialize unrelated uploads. Entries are
        # refcounted so the map can shrink without ever letting two threads
        # hold DIFFERENT locks for the same upload id (popping the lock while
        # another thread is still blocked on it would allow exactly that).
        self._session_locks: dict[str, list] = {}  # id -> [Lock, refcount]

    @contextmanager
    def _session_lock(self, upload_id: str):
        with self._mutex:
            entry = self._session_locks.setdefault(upload_id, [threading.Lock(), 0])
            entry[1] += 1
        try:
            with entry[0]:
                yield
        finally:
            with self._mutex:
                entry[1] -= 1
                if entry[1] <= 0:
                    self._session_locks.pop(upload_id, None)

    # ---- session lifecycle ------------------------------------------------

    def create(
        self,
        kbid: str,
        rid: str,
        field: str,
        *,
        size: int = -1,
        metadata: Optional[dict[str, str]] = None,
        deterministic: bool = True,
    ) -> TusSession:
        metadata = metadata or {}
        upload_id = (
            deterministic_upload_id(kbid, rid, field)
            if deterministic
            else uuid.uuid4().hex
        )
        session = TusSession(
            upload_id=upload_id,
            kbid=kbid,
            rid=rid,
            field=field,
            size=size,
            filename=metadata.get("filename", field),
            content_type=metadata.get("content_type")
            or metadata.get("content-type")
            or "application/octet-stream",
            language=metadata.get("language"),
            md5=metadata.get("md5"),
        )
        with self._session_lock(upload_id):
            # restarting an upload for the same field resets prior state
            self._purge_chunks(session)
            with self.driver as txn:
                txn.set(TUS_KEY.format(kbid=kbid, upload_id=upload_id), session.to_json())
        return session

    def get(self, kbid: str, upload_id: str) -> TusSession:
        with self.driver as txn:
            raw = txn.get(TUS_KEY.format(kbid=kbid, upload_id=upload_id))
        if raw is None:
            raise TusError(404, f"unknown upload {upload_id}")
        return TusSession.from_json(raw)

    # ---- data plane ---------------------------------------------------------

    def patch(
        self, kbid: str, upload_id: str, offset: int, body: bytes,
        declared_size: Optional[int] = None,
    ) -> tuple[TusSession, bool]:
        """Append a chunk at `offset`. Returns (session, finished)."""
        with self._session_lock(upload_id):
            session = self.get(kbid, upload_id)
            if offset != session.offset:
                raise TusError(
                    409,
                    f"Upload-Offset mismatch: expected {session.offset}, got {offset}",
                )
            if declared_size is not None and session.size < 0:
                session.size = declared_size  # creation-defer-length resolution
            if session.size >= 0 and session.offset + len(body) > session.size:
                raise TusError(400, "chunk exceeds Upload-Length")
            if body:
                self.storage.put(
                    CHUNK_KEY.format(kbid=kbid, upload_id=upload_id, index=session.chunks),
                    body,
                )
                session.chunks += 1
                session.offset += len(body)
            finished = session.size >= 0 and session.offset == session.size
            if finished:
                self._finalize(session)
            else:
                with self.driver as txn:
                    txn.set(
                        TUS_KEY.format(kbid=kbid, upload_id=upload_id), session.to_json()
                    )
            return session, finished

    def _finalize(self, session: TusSession) -> None:
        blob_key = BLOB_KEY.format(
            kbid=session.kbid, rid=session.rid, field=session.field
        )
        # stream chunk-by-chunk (md5 computed incrementally): a multi-GB
        # upload must never be materialized as one bytes object here
        digest = hashlib.md5()

        def chunk_iter():
            for i in range(session.chunks):
                chunk = self.storage.get(
                    CHUNK_KEY.format(
                        kbid=session.kbid, upload_id=session.upload_id, index=i
                    )
                )
                digest.update(chunk)
                yield chunk

        put_stream = getattr(self.storage, "put_stream", None)
        if put_stream is not None:
            put_stream(blob_key, chunk_iter())
        else:
            self.storage.put(blob_key, b"".join(chunk_iter()))
        if session.md5 and digest.hexdigest() != session.md5:
            self.storage.delete(blob_key)
            self._purge_chunks(session)
            with self.driver as txn:
                txn.delete(
                    TUS_KEY.format(kbid=session.kbid, upload_id=session.upload_id)
                )
            raise TusError(412, "md5 checksum mismatch")
        with self.driver as txn:
            txn.set(
                FILE_FIELD_KEY.format(
                    kbid=session.kbid, rid=session.rid, field=session.field
                ),
                json.dumps(
                    {
                        "key": blob_key,
                        "filename": session.filename,
                        "content_type": session.content_type,
                        "size": session.offset,
                        "language": session.language,
                    }
                ).encode(),
            )
            txn.delete(TUS_KEY.format(kbid=session.kbid, upload_id=session.upload_id))
        self._purge_chunks(session)

    def _purge_chunks(self, session: TusSession) -> None:
        prefix = f"tus/{session.kbid}/{session.upload_id}/"
        for key in list(self.storage.list(prefix)):
            self.storage.delete(key)

    # ---- gc -----------------------------------------------------------------

    def purge_stale(self, now: Optional[float] = None) -> int:
        """Drop sessions older than SESSION_TTL (parity: tus storage
        manager cleanup); returns number purged."""
        now = now or time.time()
        purged = 0
        with self.driver as txn:
            for key in list(txn.keys("/kbs/")):
                # exact session-key shape only: other /kbs/ keys (e.g. a
                # resource slug containing '/tus/') must not be parsed as
                # sessions — a raising parse would abort the whole gc tick
                if not _TUS_SESSION_KEY_RE.match(key):
                    continue
                raw = txn.get(key)
                if raw is None:
                    continue
                try:
                    session = TusSession.from_json(raw)
                except Exception:
                    continue
                if now - session.created > SESSION_TTL:
                    self._purge_chunks(session)
                    txn.delete(key)
                    purged += 1
        return purged
