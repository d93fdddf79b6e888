"""The port stands alone: importing every module of fabric_tpu_torch
brings in neither JAX, the JAX package, protobuf nor cryptography (the
idemix MSP, ``crypto/idemix.py``, the ledger and catch-up modules, the
gossip layer and BFT consenter, the operator surface — the CLI,
node configs, the operations server, ccaas and the offline tools — and
the traffic autopilot, the SLO engine and the flight recorder
included), no source file names them,
no file of its host C++ (``native/``) names the JAX package's, and an entry point asked for the default CUDA device on a
host without one raises instead of falling back.  A host C++ build that
fails raises too: the wire block is not decoded in Python instead.  The
validator's phase timers fill the reference's keys."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "fabric_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "fabric_tpu", "google.protobuf", "cryptography")
# the ledger and catch-up modules (each a copy of a jax-free reference module)
LEDGER = ("fabric_tpu_torch.faults", "fabric_tpu_torch.faults.plan",
          "fabric_tpu_torch.ledger.statedb", "fabric_tpu_torch.ledger.history",
          "fabric_tpu_torch.ledger.confighistory", "fabric_tpu_torch.ledger.pvtdata",
          "fabric_tpu_torch.ledger.blockstore", "fabric_tpu_torch.ledger.committer",
          "fabric_tpu_torch.ledger.kvledger", "fabric_tpu_torch.ledger.snapshot",
          "fabric_tpu_torch.peer.replay")
# the operator surface: the CLI, node configs, the operations server,
# chaincode packages and ccaas, the JSON codec and the offline tools
OPERATOR = ("fabric_tpu_torch.cli", "fabric_tpu_torch.nodeconfig", "fabric_tpu_torch.opsserver",
            "fabric_tpu_torch.peer.ccaas", "fabric_tpu_torch.peer.ccpackage",
            "fabric_tpu_torch.protos.jsonfmt", "fabric_tpu_torch.tools.configtxlator",
            "fabric_tpu_torch.tools.ledgerutil", "fabric_tpu_torch.tools.nodeops")

# the traffic autopilot, the SLO engine and the flight recorder
AUTOPILOT = ("fabric_tpu_torch.control", "fabric_tpu_torch.control.autopilot",
             "fabric_tpu_torch.observe.slo", "fabric_tpu_torch.observe.timeseries",
             "fabric_tpu_torch.observe.blackbox")


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
    assert "fabric_tpu_torch.parallel.hostpool" in mods  # the reference's pool, copied
    assert {"fabric_tpu_torch.channelconfig", "fabric_tpu_torch.tools.configtxgen",
            "fabric_tpu_torch.crypto.idemix"} <= set(mods)
    assert set(LEDGER) <= set(mods)
    assert set(OPERATOR) <= set(mods)
    assert set(AUTOPILOT) <= set(mods)
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
    assert "fabric_tpu_torch.sidecar.server" in loaded
    assert "fabric_tpu_torch.channelconfig" in loaded
    assert "fabric_tpu_torch.crypto.idemix" in loaded
    assert {"fabric_tpu_torch.gossip", "fabric_tpu_torch.ordering.bft"} <= set(loaded)
    assert set(LEDGER) <= set(loaded)
    assert set(OPERATOR) <= set(loaded)
    assert set(AUTOPILOT) <= set(loaded)
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
    from fabric_tpu_torch.crypto.msp import MSPManager
    from fabric_tpu_torch.ops import mvcc, p256, p256sign, p256v3, sha256
    from fabric_tpu_torch.peer import signlane
    from fabric_tpu_torch.peer.validator import BlockValidator, PolicyProvider
    from fabric_tpu_torch.sidecar import SidecarServer
    from fabric_tpu_torch.state import ResidencyManager

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        BlockValidator(PolicyProvider({}), MemVersionedDB())
    with pytest.raises(RuntimeError, match="CUDA"):
        p256v3.verify_launch([(1, 1, 1, 1, 1)])
    with pytest.raises(RuntimeError, match="CUDA"):
        p256v3.verify_launch_many([[(1, 1, 1, 1, 1)], []])
    with pytest.raises(RuntimeError, match="CUDA"):
        BlockValidator(PolicyProvider({}), MemVersionedDB(), host_stage_workers=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        mvcc.mvcc_validate_block([mvcc.TxRWSet([("k", (1, 0))], ["k"], [])], {})
    with pytest.raises(RuntimeError, match="CUDA"):
        BlockValidator(PolicyProvider({}), MemVersionedDB(), state_resident=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        ResidencyManager(slots=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        p256sign.sign_launch([1], 5)
    with pytest.raises(RuntimeError, match="CUDA"):
        signlane.device_sign_backend(5)
    with pytest.raises(RuntimeError, match="CUDA"):
        sha256.sha256_host([b"abc"])
    with pytest.raises(RuntimeError, match="CUDA"):
        BlockValidator(PolicyProvider({}), MemVersionedDB(), msp=MSPManager())
    for kernel in ("v1", "v2"):
        with pytest.raises(RuntimeError, match="CUDA"):
            p256.verify_host([(1, 1, 1, 1, 1)], kernel=kernel)
        with pytest.raises(RuntimeError, match="CUDA"):
            BlockValidator(PolicyProvider({}), MemVersionedDB(), kernel=kernel)
    with pytest.raises(RuntimeError, match="CUDA"):
        SidecarServer()
    from fabric_tpu_torch.peer.node import PeerNode

    with pytest.raises(RuntimeError, match="CUDA"):
        PeerNode("p", "/nonexistent", MSPManager(), None)  # before any file is touched
    v = BlockValidator(PolicyProvider({}), MemVersionedDB(), device="cpu", state_resident=True)
    assert v.resident.device.type == "cpu"
    assert BlockValidator(PolicyProvider({}), MemVersionedDB(), device="cpu").device.type == "cpu"
    assert BlockValidator(PolicyProvider({}), MemVersionedDB(), device="cpu",
                          msp=MSPManager()).device.type == "cpu"
    assert sha256.sha256_host([b"abc"], device="cpu")[0].hex().startswith("ba7816bf")


def test_chip_smoke_without_the_package_exits_2_with_one_line(tmp_path):
    """``chip_smoke.py`` in a directory that holds nothing else of the
    repository: exit 2, one line on stderr that names the missing
    package, no traceback and no result on stdout."""
    import os
    import shutil

    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""
    lines = out.stderr.strip().splitlines()
    assert len(lines) == 1 and "fabric_tpu_torch" in lines[0], out.stderr
    assert "Traceback" not in out.stderr


def test_host_cpp_names_no_reference_file():
    files = sorted((PKG / "native").glob("*.[cp][py]*"))
    assert {f.suffix for f in files} == {".py", ".cpp"}
    for f in files:
        text = f.read_text()
        assert "fabric_tpu/native" not in text and "fabric_tpu.native" not in text, f.name


def _wire_block():
    from fabric_tpu_torch.peer import txassembly

    return txassembly.build_block(3, b"prev", [b"", b"\x13garbage-bytes"])


def test_failed_host_build_raises(tmp_path, monkeypatch):
    """A compiler that fails: the first wire block's validation raises
    with the compiler's name and output, and nothing reaches the front
    end's Python decode."""
    from fabric_tpu_torch import native
    from fabric_tpu_torch.crypto.msp import MSPManager
    from fabric_tpu_torch.ledger.statedb import MemVersionedDB
    from fabric_tpu_torch.peer import frontend
    from fabric_tpu_torch.peer.validator import BlockValidator, PolicyProvider

    monkeypatch.setattr(native, "CXX", "/bin/false")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    decoded = []
    monkeypatch.setattr(frontend, "decode_envelope", lambda *a: decoded.append(a))
    v = BlockValidator(PolicyProvider({}), MemVersionedDB(), device="cpu", msp=MSPManager())
    with pytest.raises(RuntimeError, match="/bin/false failed"):
        v.validate(_wire_block())
    assert decoded == [] and list(tmp_path.iterdir()) == []


def test_timers_fill_the_reference_keys(tmp_path):
    """``timings = {}``: one wire block through the device path fills
    each phase key of the reference's that the path passes through."""
    from fabric_tpu_torch.crypto.msp import MSPManager
    from fabric_tpu_torch.ledger.statedb import MemVersionedDB
    from fabric_tpu_torch.peer.validator import BlockValidator, PolicyProvider, WireBlock

    v = BlockValidator(PolicyProvider({}), MemVersionedDB(), device="cpu", msp=MSPManager())
    v.timings = {}
    pend = v.validate_launch(_wire_block())
    flt, _, _ = v.validate_finish(pend)
    assert isinstance(pend.block, WireBlock) and pend.block.n_front_end == 2
    assert flt == bytes([1, 2])  # NIL_ENVELOPE, BAD_PAYLOAD
    assert set(v.timings) == {"host_parse", "sig_prepare_launch", "device_pre", "state_fill",
                              "stage2_dispatch", "device_wait", "postprocess"}
    assert all(t >= 0.0 for t in v.timings.values())
    assert pend.hd_bytes is None
    # with a ledger's block store attached, the prefetch thread also
    # frames the block's header and data for the commit
    from fabric_tpu_torch import protoutil
    from fabric_tpu_torch.ledger.blockstore import BlockStore

    v.blocks = BlockStore(str(tmp_path / "chains"))
    v.timings = {}
    blk = _wire_block()
    pend = v.validate_launch(blk)
    v.validate_finish(pend)
    v.blocks.close()
    assert "hd_frame" in v.timings
    assert pend.hd_bytes == protoutil.block_header_data_bytes(blk)
