"""The commit path's host C++, built with g++ at first use and bound with
ctypes (counterpart: the JAX package's ``native/__init__.py``).

Each ``native/<name>.cpp`` is this package's own copy of the reference's
file of that name, cut down or adapted to the port's types (each file's
header names its counterpart):

* ``blockparse`` — one call a block: walks every envelope's wire form,
  hashes every signed message (SHA-NI where the CPU has it) and splits
  every DER signature (``native/blockparse.py``);
* ``ecprep`` — one call a signature batch: admission, the Montgomery
  batch inversion and u1/u2, written straight into the port's int16
  launch frame (``ops/p256v3.py::stage_frame``);
* ``mvccprep`` — one call a block: parses the read/write sets, interns
  the keys, emits flat arrays (``native/mvccprep.py``).

Each library compiles with ``g++ -O3 -shared -fPIC -std=c++17`` (the
reference's flags) into ``fabric_tpu_torch/_build/``, named by a hash of
its source and flags so an edit rebuilds, and is written there by an
atomic rename: two threads or processes may build at once.  Each entry's
``argtypes`` and ``restype`` are set once, at load.  A ctypes call
releases the GIL, so the prefetch thread's staging overlaps the
committer's Python.

There is no fallback: a missing compiler, a failed build or a failed
load raises with the compiler's output (the reference quietly takes its
Python paths instead).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("blockparse", "ecprep", "mvccprep")
CXX = "g++"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGS = {
    "blockparse": {
        "bp_parse_block": (_I64, [_P, _P, _P, _I64, _I64, _I64] + [_P] * 25),
        "bp_sha256": (None, [_P, _I64, ctypes.c_int32, _P]),
    },
    "ecprep": {
        "ec_stage_frame": (None, [_P, _P, _P, _P, _P, _P, _I64, _P, _I64]),
        "ec_q_admit": (None, [_P, _I64, _P]),
    },
    "mvccprep": {
        "mvcc_prep": (_I64, [_P, _P, _P, _I64, _I64, _I64, _I64] + [_P] * 19),
    },
}

_libs: dict = {}
_lock = threading.Lock()
# seconds each library's g++ took in this process (0.0: found built)
build_seconds: dict = {}


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((SRC_DIR / f"{name}.cpp").read_bytes())
    h.update(" ".join((CXX, *FLAGS)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def compiler_version() -> str:
    """The first line of ``g++ --version``."""
    out = subprocess.run([CXX, "--version"], capture_output=True, text=True, check=True)
    return out.stdout.splitlines()[0]


def build(names=SOURCES) -> float:
    """Compile (if not built) and load the named libraries, one g++
    process each, all started at once; returns the seconds spent.
    Raises ``RuntimeError`` with the compiler's output on a failure."""
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for n in todo:
            out = _lib_path(n)
            if out.exists():
                build_seconds[n] = 0.0
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            try:
                proc = subprocess.Popen([CXX, *FLAGS, str(SRC_DIR / f"{n}.cpp"), "-o", str(tmp)],
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            except OSError as e:
                raise RuntimeError(f"{n}.cpp: cannot run {CXX!r}: {e}") from e
            procs.append((n, out, tmp, proc, time.perf_counter()))
        failed = []
        for n, out, tmp, proc, ts in procs:
            stdout, stderr = proc.communicate()
            build_seconds[n] = time.perf_counter() - ts
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{n}.cpp (exit {proc.returncode}):\n{stdout}{stderr}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError(f"{CXX} failed:\n" + "\n".join(failed))
        for n in todo:
            lib = ctypes.CDLL(str(_lib_path(n)))
            for fn, (restype, argtypes) in _SIGS[n].items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _libs[n] = lib
    return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built at its first use."""
    got = _libs.get(name)
    if got is None:
        build((name,))
        got = _libs[name]
    return got


def ptr(a) -> int:
    """A C-contiguous numpy array's data address."""
    if not a.flags.c_contiguous:
        raise ValueError("native operands must be C-contiguous")
    return a.ctypes.data
