"""The port stands alone: importing every module of fabric_tpu_torch
brings in neither JAX, the JAX package, protobuf nor cryptography, no
source file names them, and an entry point asked for the default CUDA
device on a host without one raises instead of falling back."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "fabric_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "fabric_tpu", "google.protobuf", "cryptography")


def _sources():
    """The package's Python files (``_build/`` holds generated files only)."""
    return sorted(p for p in PKG.rglob("*.py") if "_build" not in p.relative_to(PKG).parts)


def _modules():
    out = []
    for f in _sources():
        parts = f.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_brings_in_no_reference_package():
    mods = _modules()
    assert "fabric_tpu_torch.peer.validator" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    import json

    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "fabric_tpu_torch.ops.p256v3" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", [str(p.relative_to(ROOT)) for p in _sources()]
                         + ["chip_smoke.py"])
def test_sources_name_no_reference_package(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert [n for n in names if _forbidden(n)] == []


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    from fabric_tpu_torch import resolve_device
    from fabric_tpu_torch.ledger.statedb import MemVersionedDB
    from fabric_tpu_torch.ops import mvcc, p256v3
    from fabric_tpu_torch.peer.validator import BlockValidator, PolicyProvider

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        BlockValidator(PolicyProvider({}), MemVersionedDB())
    with pytest.raises(RuntimeError, match="CUDA"):
        p256v3.verify_launch([(1, 1, 1, 1, 1)])
    with pytest.raises(RuntimeError, match="CUDA"):
        mvcc.mvcc_validate_block([mvcc.TxRWSet([("k", (1, 0))], ["k"], [])], {})
    assert BlockValidator(PolicyProvider({}), MemVersionedDB(), device="cpu").device.type == "cpu"
