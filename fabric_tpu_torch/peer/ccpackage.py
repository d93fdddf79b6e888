"""Chaincode packages and the peer's install store (counterpart:
``fabric_tpu/peer/ccpackage.py``).

A package is a tar.gz holding ``metadata.json`` (``{"label", "type":
"ccaas"}``) and ``code.tar.gz``, whose ``connection.json`` names the
chaincode server's ``{"address": "host:port"}`` (chaincode as a
service).  The tarballs are deterministic as the reference's are
(sorted members, mtime 0, root owner, GNU format, gzip level 6 with its
MTIME zeroed), so the same label and address give byte-equal packages
and the same package id, ``label:sha256hex(package)``.
``PackageStore`` keeps installed packages as
``<data_dir>/lifecycle/chaincodes/<label>.<sha256>.tgz``; they survive a
restart.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import tarfile

_LABEL_RE = re.compile(r"^[a-zA-Z0-9][a-zA-Z0-9_.+-]*$")


def _tar_bytes(entries: dict[str, bytes]) -> bytes:
    """Deterministic tar.gz of {name: content} (fixed mtime/owner so
    the same logical package always yields the same package id)."""
    buf = io.BytesIO()
    # mtime pinned in the gzip header AND per-member for determinism
    with tarfile.open(fileobj=buf, mode="w:gz", compresslevel=6,
                      format=tarfile.GNU_FORMAT) as tf:
        for name in sorted(entries):
            data = entries[name]
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            ti.mtime = 0
            ti.uid = ti.gid = 0
            ti.uname = ti.gname = ""
            tf.addfile(ti, io.BytesIO(data))
    raw = bytearray(buf.getvalue())
    raw[4:8] = b"\x00\x00\x00\x00"  # gzip MTIME field
    return bytes(raw)


def _tar_read(raw: bytes) -> dict[str, bytes]:
    out = {}
    with tarfile.open(fileobj=io.BytesIO(raw), mode="r:*") as tf:
        for m in tf.getmembers():
            if not m.isfile() or m.size > 16 * 1024 * 1024:
                continue
            f = tf.extractfile(m)
            if f is not None:
                out[m.name.lstrip("./")] = f.read()
    return out


def package_ccaas(label: str, address: str) -> bytes:
    """Build a ccaas chaincode package (peer lifecycle chaincode
    package --lang ccaas analog)."""
    if not _LABEL_RE.match(label or ""):
        raise ValueError(f"invalid package label {label!r}")
    code = _tar_bytes({
        "connection.json": json.dumps(
            {"address": address}, sort_keys=True
        ).encode(),
    })
    return _tar_bytes({
        "metadata.json": json.dumps(
            {"type": "ccaas", "label": label}, sort_keys=True
        ).encode(),
        "code.tar.gz": code,
    })


def parse_package(raw: bytes) -> dict:
    """→ {"label", "type", "connection": {...}|None}; raises ValueError
    on anything that isn't a well-formed package."""
    try:
        entries = _tar_read(raw)
        meta = json.loads(entries["metadata.json"])
        label = meta["label"]
        cc_type = meta["type"]
    except Exception as e:
        raise ValueError(f"malformed chaincode package: {e}") from None
    if not _LABEL_RE.match(label or ""):
        raise ValueError(f"invalid package label {label!r}")
    conn = None
    if "code.tar.gz" in entries:
        try:
            code = _tar_read(entries["code.tar.gz"])
            if "connection.json" in code:
                conn = json.loads(code["connection.json"])
        except Exception:
            conn = None
    return {"label": label, "type": cc_type, "connection": conn}


def package_id(label: str, raw: bytes) -> str:
    """``label:sha256hex`` (calculatepackageid.go)."""
    return f"{label}:{hashlib.sha256(raw).hexdigest()}"


class PackageStore:
    """Installed-package persistence (core/chaincode/persistence
    Store): packages live as <data_dir>/lifecycle/chaincodes/<id>.tgz
    and survive peer restarts."""

    def __init__(self, data_dir: str):
        self.dir = os.path.join(data_dir, "lifecycle", "chaincodes")
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, pkg_id: str) -> str:
        # filename <label>.<sha256>.tgz (the reference's persistence
        # naming): the hash never contains dots, so rsplit on the last
        # one is unambiguous even for dotted labels
        label, _, digest = pkg_id.rpartition(":")
        if not _LABEL_RE.match(label) or not re.fullmatch(
            r"[0-9a-f]{64}", digest
        ):
            raise ValueError(f"invalid package id {pkg_id!r}")
        return os.path.join(self.dir, f"{label}.{digest}.tgz")

    def install(self, raw: bytes) -> dict:
        """Validate + persist; → {"package_id", "label"}.  Installing
        the same bytes twice is idempotent (the reference returns the
        existing id)."""
        info = parse_package(raw)
        pid = package_id(info["label"], raw)
        path = self._path(pid)
        if not os.path.exists(path):
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(raw)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        return {"package_id": pid, "label": info["label"]}

    def list(self) -> list[dict]:
        """QueryInstalledChaincodes: [{"package_id", "label"}]."""
        out = []
        for name in sorted(os.listdir(self.dir)):
            if not name.endswith(".tgz"):
                continue
            label, _, digest = name[:-4].rpartition(".")
            out.append({
                "package_id": f"{label}:{digest}", "label": label,
            })
        return out

    def get(self, pkg_id: str) -> bytes | None:
        """GetInstalledChaincodePackage: the raw package bytes."""
        try:
            with open(self._path(pkg_id), "rb") as f:
                return f.read()
        except (OSError, ValueError):
            return None

    def connection(self, pkg_id: str) -> dict | None:
        """The ccaas endpoint the package binds (connection.json)."""
        raw = self.get(pkg_id)
        if raw is None:
            return None
        try:
            return parse_package(raw)["connection"]
        except ValueError:
            return None
