"""The scenarios of ``tests/test_storage_cloud.py`` on the port: the port's
``make_storage`` and its S3, GCS and Azure backends against the same
protocol fakes (``tests/cloud_fakes.py``).

The reference file's own docstring:

Cloud storage backends against in-process protocol fakes.

The same contract suite runs over S3 (SigV4-verified), GCS (bearer), and
Azure (SharedKey-verified) plus local/memory, so every backend honors the
Storage interface identically — including multi-page listing.
"""

import pytest

from nucliadb_tpu_torch.settings import StorageSettings
from nucliadb_tpu_torch.storage import LocalStorage, MemoryStorage, make_storage

from cloud_fakes import make_fake_azure, make_fake_gcs, make_fake_s3


def _contract(storage):
    keys = [f"seg/{i:02d}" for i in range(5)] + ["other/x"]
    for i, key in enumerate(keys):
        storage.put(key, f"payload-{i}".encode() * 10)
    assert storage.exists("seg/00")
    assert not storage.exists("seg/99")
    assert storage.get("seg/03") == b"payload-3" * 10
    # paginated listing (fakes use page size 2 -> 3 round trips)
    assert list(storage.list("seg/")) == [f"seg/{i:02d}" for i in range(5)]
    assert list(storage.list()) == sorted(keys)
    storage.delete("seg/01")
    storage.delete("seg/01")  # idempotent
    assert not storage.exists("seg/01")
    assert list(storage.list("seg/")) == ["seg/00", "seg/02", "seg/03", "seg/04"]
    # overwrite
    storage.put("seg/00", b"v2")
    assert storage.get("seg/00") == b"v2"


def test_local_contract(tmp_path):
    _contract(LocalStorage(str(tmp_path / "root")))


def test_memory_contract():
    _contract(MemoryStorage())


def test_s3_contract_and_signing():
    server, endpoint, blobs = make_fake_s3("ndb", "AKID", "sekrit")
    try:
        storage = make_storage(
            StorageSettings(
                backend="s3", endpoint=endpoint, bucket="ndb",
                access_key="AKID", secret_key="sekrit", region="eu-west-3",
            )
        )
        _contract(storage)
        # a wrong secret is rejected by the fake's independent verifier
        bad = make_storage(
            StorageSettings(
                backend="s3", endpoint=endpoint, bucket="ndb",
                access_key="AKID", secret_key="wrong",
            )
        )
        with pytest.raises(IOError):
            bad.put("k", b"v")
    finally:
        server.shutdown()


def test_s3_key_prefix():
    server, endpoint, blobs = make_fake_s3("ndb", "AKID", "sekrit")
    try:
        storage = make_storage(
            StorageSettings(
                backend="s3", endpoint=endpoint, bucket="ndb",
                access_key="AKID", secret_key="sekrit", key_prefix="kb1/",
            )
        )
        storage.put("a", b"1")
        assert "kb1/a" in blobs  # namespaced in the bucket
        assert list(storage.list()) == ["a"]  # transparent to callers
    finally:
        server.shutdown()


def test_gcs_contract():
    server, endpoint, _ = make_fake_gcs("ndb", "tok123")
    try:
        storage = make_storage(
            StorageSettings(backend="gcs", endpoint=endpoint, bucket="ndb", token="tok123")
        )
        _contract(storage)
        bad = make_storage(
            StorageSettings(backend="gcs", endpoint=endpoint, bucket="ndb", token="nope")
        )
        with pytest.raises(IOError):
            bad.get("seg/00")
    finally:
        server.shutdown()


def test_azure_contract_and_signing():
    import base64

    key = base64.b64encode(b"0123456789abcdef0123456789abcdef").decode()
    server, endpoint, _ = make_fake_azure("acct", key, "ndb")
    try:
        storage = make_storage(
            StorageSettings(
                backend="azure", endpoint=endpoint, account="acct",
                account_key=key, container="ndb",
            )
        )
        _contract(storage)
        # regression: the SharedKey signature must canonicalize the ENCODED
        # path — keys needing percent-encoding 403'd against real Azure
        for tricky in ("dir/a b.txt", "pct %25 plus +.bin", "uni-é日.dat"):
            storage.put(tricky, b"enc")
            assert storage.get(tricky) == b"enc"
            storage.delete(tricky)
        wrong = base64.b64encode(b"ffffffffffffffffffffffffffffffff").decode()
        bad = make_storage(
            StorageSettings(
                backend="azure", endpoint=endpoint, account="acct",
                account_key=wrong, container="ndb",
            )
        )
        with pytest.raises(IOError):
            bad.put("k", b"v")
    finally:
        server.shutdown()


def test_unknown_backend():
    with pytest.raises(ValueError):
        make_storage(StorageSettings(backend="ftp"))
