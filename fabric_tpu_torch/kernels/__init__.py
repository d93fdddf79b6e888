"""The port's hand-written CUDA kernels: build at first use, bind with
ctypes, count launches.

Each ``csrc/<name>.cu`` compiles with ``nvcc -shared`` for ``sm_90a``
into its own shared library with a plain C interface (one nvcc process
per source, all started together), under ``fabric_tpu_torch/_build/``,
named by a hash of the source so an edit rebuilds.  Nothing here
includes PyTorch's headers: the wrappers pass ``data_ptr()`` integers
and PyTorch's current stream, and each C entry point returns
``cudaGetLastError()`` after its launches, which the wrapper raises on.

``launches`` counts the wrappers' kernel launches by name; a wrapper
adds one where it launches and nowhere else.  One count is one call of
the named kernel: ``stage2_mvcc`` is two CUDA launches (bitsets, then
the fixpoint block) and ``mvcc_validate`` three (the per-read compare
first).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("p256_verify", "stage2")
ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)

launches = {"p256_verify": 0, "stage2_policy": 0, "stage2_mvcc": 0,
            "mvcc_validate": 0}
# nvcc's -Xptxas=-v report per source (registers, spills), for logs
build_log: dict = {}

_libs: dict = {}
_lock = threading.Lock()
_count_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    "p256_verify": {
        "fab_p256_verify": [_P, _I, _P, _P, _P],
    },
    "stage2": {
        "fab_stage2_policy": [_P, _I, _P, _I, _I, _I, _P, _P, _I, _P, _P],
        "fab_mvcc_verok": [_P, _P, _P, _P, _P, _I, _I, _P, _P],
        "fab_mvcc_bitsets": [_P, _I, _I, _I, _I, _P, _P, _P],
        "fab_mvcc_fixpoint": [_I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P],
    },
}


def reset_counts() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        launches[name] += 1


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "build on a host with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh") and (f.stem == name or f.suffix == ".cuh"):
            h.update(f.name.encode() + f.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> float:
    """Compile (if not built) and load the named sources; returns the
    seconds spent.  Every missing library compiles in its own nvcc
    process, all started at once."""
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
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                   "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo",
                   "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs.append((n, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for n, out, tmp, proc in procs:
            stdout, stderr = proc.communicate()
            build_log[n] = stdout + stderr
            if proc.returncode != 0:
                failed.append(f"{n}.cu:\n{stderr}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for n in todo:
            lib = ctypes.CDLL(str(_lib_path(n)))
            for fn, argtypes in _SIGS[n].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.fab_error_string.argtypes = [ctypes.c_int]
            lib.fab_error_string.restype = ctypes.c_char_p
            _libs[n] = lib
    return time.perf_counter() - t0


def _fn(lib_name: str, fn: str):
    if lib_name not in _libs:
        build((lib_name,))
    return _libs[lib_name], getattr(_libs[lib_name], fn)


def _call(lib_name: str, fn: str, *args) -> None:
    lib, f = _fn(lib_name, fn)
    rc = f(*args)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc}: "
                           f"{lib.fab_error_string(rc).decode()}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _cuda(*ts) -> None:
    for t in ts:
        if t is not None and (t.device.type != "cuda" or not t.is_contiguous()):
            raise ValueError("kernel operands must be contiguous CUDA tensors")


# ---------------------------------------------------------------------------
# Launch wrappers: the ops modules call these only for CUDA tensors.


def p256_verify(frame: torch.Tensor, consts: torch.Tensor) -> torch.Tensor:
    """[B, cols] int16 frame → [B] bool (``ops/p256v3.py``)."""
    _cuda(frame, consts)
    out = torch.empty(frame.shape[0], dtype=torch.bool, device=frame.device)
    _call("p256_verify", "fab_p256_verify", frame.data_ptr(), frame.shape[0],
          consts.data_ptr(), out.data_ptr(), _stream(frame))
    _count("p256_verify")
    return out


def stage2_policy(sig_valid, gp, S: int, P: int, plan, policy_ok, safe_out) -> None:
    """One policy group: safe bits into ``safe_out`` (int8 [Eb]) and
    ``atomicMin`` of each entry's verdict into ``policy_ok`` (int32 [T+1])."""
    _cuda(sig_valid, gp, plan, policy_ok, safe_out)
    _call("stage2", "fab_stage2_policy", sig_valid.data_ptr(), sig_valid.shape[0],
          gp.data_ptr(), gp.shape[0], S, P, plan.data_ptr(), policy_ok.data_ptr(),
          policy_ok.shape[0] - 1, safe_out.data_ptr(), _stream(gp))
    _count("stage2_policy")


def _bitsets(static_p, R: int, W: int, Q: int):
    if static_p.shape[1] != R + W + 2 * Q:
        raise ValueError(f"static frame has {static_p.shape[1]} columns, "
                         f"expected R + W + 2Q = {R + W + 2 * Q}")
    T = static_p.shape[0]
    nw = (T + 31) // 32
    direct = torch.empty((T, nw), dtype=torch.int32, device=static_p.device)
    phantom = torch.empty_like(direct)
    return direct, phantom


def stage2_mvcc(static_p, R: int, W: int, Q: int, launch_vec, sig_valid,
                policy_ok, out) -> None:
    """Conflict bitsets + the validity fixpoint of one block, writing
    valid | conflict | phantom | creator_ok | policy_ok | sig_valid into
    ``out`` (int8 [5T + n_sig + ...])."""
    _cuda(static_p, launch_vec, sig_valid, policy_ok, out)
    T = static_p.shape[0]
    direct, phantom = _bitsets(static_p, R, W, Q)
    s = _stream(static_p)
    _call("stage2", "fab_mvcc_bitsets", static_p.data_ptr(), T, R, W, Q,
          direct.data_ptr(), phantom.data_ptr(), s)
    _call("stage2", "fab_mvcc_fixpoint", T, direct.data_ptr(), phantom.data_ptr(),
          None, None, launch_vec.data_ptr(), sig_valid.data_ptr(), sig_valid.shape[0],
          policy_ok.data_ptr(), out.data_ptr(), s)
    _count("stage2_mvcc")


def mvcc_hostver(static_p, R: int, W: int, Q: int, ver_ok, pre_ok, out) -> None:
    """Conflict bitsets + fixpoint with the per-read compare done on the
    host, writing valid | conflict | phantom into ``out`` (int8 [3T])."""
    _cuda(static_p, ver_ok, pre_ok, out)
    T = static_p.shape[0]
    direct, phantom = _bitsets(static_p, R, W, Q)
    s = _stream(static_p)
    _call("stage2", "fab_mvcc_bitsets", static_p.data_ptr(), T, R, W, Q,
          direct.data_ptr(), phantom.data_ptr(), s)
    _call("stage2", "fab_mvcc_fixpoint", T, direct.data_ptr(), phantom.data_ptr(),
          ver_ok.data_ptr(), pre_ok.data_ptr(), None, None, 0, None, out.data_ptr(), s)
    _count("stage2_mvcc")


def mvcc_validate(read_keys, read_present, read_vers, comm_present, comm_vers,
                  static_p, R: int, W: int, Q: int, pre_ok, out) -> None:
    """Per-read version compare, conflict bitsets and fixpoint, writing
    valid | conflict | phantom into ``out`` (int8 [3T])."""
    _cuda(read_keys, read_present, read_vers, comm_present, comm_vers,
          static_p, pre_ok, out)
    T = static_p.shape[0]
    ver_ok = torch.empty(T, dtype=torch.bool, device=static_p.device)
    direct, phantom = _bitsets(static_p, R, W, Q)
    s = _stream(static_p)
    _call("stage2", "fab_mvcc_verok", read_keys.data_ptr(), read_present.data_ptr(),
          read_vers.data_ptr(), comm_present.data_ptr(), comm_vers.data_ptr(),
          T, read_keys.shape[1], ver_ok.data_ptr(), s)
    _call("stage2", "fab_mvcc_bitsets", static_p.data_ptr(), T, R, W, Q,
          direct.data_ptr(), phantom.data_ptr(), s)
    _call("stage2", "fab_mvcc_fixpoint", T, direct.data_ptr(), phantom.data_ptr(),
          ver_ok.data_ptr(), pre_ok.data_ptr(), None, None, 0, None, out.data_ptr(), s)
    _count("mvcc_validate")
