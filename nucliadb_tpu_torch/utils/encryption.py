"""Secret encryption for stored configuration.

The port's copy of ``nucliadb_tpu/utils/encryption.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity: nucliadb_utils encryption (EndecryptorUtility) — learning/config
secrets persist encrypted at rest when an encryption key is configured
(env ``NDBTPU_ENCRYPTION_KEY``, a urlsafe-base64 32-byte Fernet key).
Without a key the utility is a documented no-op passthrough so embedded
dev deployments keep working.
"""

from __future__ import annotations

import os
from typing import Optional

_PREFIX = "enc::"


class Endecryptor:
    def __init__(self, key: Optional[str] = None):
        key = key or os.environ.get("NDBTPU_ENCRYPTION_KEY", "")
        self._fernet = None
        if key:
            from cryptography.fernet import Fernet

            self._fernet = Fernet(key.encode())

    @staticmethod
    def generate_key() -> str:
        from cryptography.fernet import Fernet

        return Fernet.generate_key().decode()

    @property
    def active(self) -> bool:
        return self._fernet is not None

    def encrypt(self, value: str) -> str:
        if self._fernet is None:
            return value
        return _PREFIX + self._fernet.encrypt(value.encode()).decode()

    def decrypt(self, value: str) -> str:
        if self._fernet is None or not value.startswith(_PREFIX):
            return value
        return self._fernet.decrypt(value[len(_PREFIX):].encode()).decode()
