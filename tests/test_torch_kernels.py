"""The kernel build cache of the port (``utils/kernels.py``): a library's
name hashes its source, every other file under ``csrc/`` (the headers a
source includes) and the nvcc flags, so an edited header rebuilds."""

from nucliadb_tpu_torch.utils import kernels


def test_library_path_follows_headers_and_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "scan.cu").write_text('#include "table.cuh"\n')
    (csrc / "table.cuh").write_text("// v1\n")
    (csrc / "other.cu").write_text("// other\n")
    monkeypatch.setattr(kernels, "CSRC", csrc)
    first = kernels.library_path("scan")
    assert first == kernels.library_path("scan")  # unchanged tree: same build
    assert first.parent == kernels.BUILD_DIR and first.name.startswith("libscan-")
    (csrc / "table.cuh").write_text("// v2\n")
    second = kernels.library_path("scan")
    assert second != first  # an edited header rebuilds
    (csrc / "scan.cu").write_text('#include "table.cuh"\n// edited\n')
    assert kernels.library_path("scan") not in (first, second)
    monkeypatch.setattr(kernels, "NVCC_FLAGS", (*kernels.NVCC_FLAGS, "-lineinfo"))
    assert kernels.library_path("scan") != second


def test_package_data_ships_every_kernel_file():
    """Every file a build hashes and compiles is package data, headers
    included, and each wrapper's source is there."""
    import fnmatch
    import tomllib
    from pathlib import Path

    pyproject = Path(__file__).resolve().parents[1] / "pyproject.toml"
    globs = tomllib.loads(pyproject.read_text())["tool"]["setuptools"]["package-data"][
        "nucliadb_tpu_torch"
    ]
    root = kernels.CSRC.parent
    for path in kernels.CSRC.rglob("*"):
        rel = str(path.relative_to(root))
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel
    for name in ("int8_slot_scan", "binary_slot_scan"):
        assert (kernels.CSRC / f"{name}.cu").is_file()
