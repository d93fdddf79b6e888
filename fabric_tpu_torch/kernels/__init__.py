"""The port's hand-written CUDA kernels: build at first use, bind with
ctypes, count launches.

Each ``csrc/<name>.cu`` compiles with ``nvcc -shared`` for ``sm_90a``
into its own shared library with a plain C interface (one nvcc process
per source, all started together), under ``fabric_tpu_torch/_build/``,
named by a hash of the source so an edit rebuilds.  Nothing here
includes PyTorch's headers: the wrappers pass ``data_ptr()`` integers
and PyTorch's current stream, and each C entry point returns
``cudaGetLastError()`` after its launches, which the wrapper raises on.

A launch's host path is kept short, since at the commit path's small
shapes it is most of a kernel's time: each C entry point is resolved
once, when its library loads (``_Entry``); the stream is PyTorch's
current one as a raw handle, with no ``torch.cuda.Stream`` object; the
operand checks are ``is_cuda`` and ``is_contiguous()``.
``fabric_tpu_torch/tools/launch_steps.py`` times each of these steps.

``launches`` counts the wrappers' kernel launches by name; a wrapper
adds one where it launches and nowhere else.  ``first_launch(name)`` is
True until the named kernel has launched once in this process (the
launch ledger's cache-miss verdict on the card, ``observe/ledger.py``);
``reset_counts`` leaves it as it is.  One count is one call of
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
SOURCES = ("p256_verify", "stage2", "resident", "p256_sign", "sha256", "p256_v1", "p256_v2")
ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)

launches = {"p256_verify": 0, "stage2_policy": 0, "stage2_mvcc": 0,
            "mvcc_validate": 0, "resident_verok": 0, "table_scatter": 0,
            "p256_sign": 0, "sha256_blocks": 0, "p256_verify_v1": 0, "p256_verify_v2": 0}
# nvcc's -Xptxas=-v report per source (registers, spills), for logs
build_log: dict = {}

_libs: dict = {}
_launched: set = set()  # kernels launched at least once in this process
_lock = threading.Lock()
_count_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    "p256_verify": {
        "fab_p256_verify": [_P, _I, _P, _P, _P],
    },
    "stage2": {
        "fab_stage2_policy": [_P, _I, _P, _P, _I, _I, _I, _P, _P, _P],
        "fab_mvcc_verok": [_P, _P, _P, _P, _P, _I, _I, _P, _P],
        "fab_mvcc_bitsets": [_P, _I, _I, _I, _I, _P, _P, _P],
        "fab_mvcc_fixpoint": [_I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P],
        "fab_mvcc_fixpoint_in_smem": [_I],
    },
    "resident": {
        "fab_resident_verok": [_P, _I, _I, _I, _P, _I, _P, _I, _P, _P, _P],
        "fab_table_scatter": [_P, _P, _P, _I, _P],
    },
    "p256_sign": {
        "fab_p256_sign": [_P, _I, _I, _P, _P, _P, _P],
        "fab_p256_sign_tpi": [_I],
    },
    "sha256": {
        "fab_sha256_blocks": [_P, _P, _I, _I, _P, _P],
    },
    "p256_v1": {
        "fab_p256_verify_v1": [_P, _I, _P, _P, _P],
        "fab_p256_verify_v1_attrs": [_I, _P],
    },
    "p256_v2": {
        "fab_p256_verify_v2": [_P, _I, _P, _P, _P],
        "fab_p256_verify_v2_attrs": [_I, _P],
    },
}


class _Entry:
    """One C entry point: its ctypes function ``fn`` is looked up once,
    when its library loads (until then a stub that builds the library).
    A call launches and raises on a non-zero ``cudaError_t``."""

    __slots__ = ("lib_name", "name", "fn", "lib")

    def __init__(self, lib_name: str, name: str):
        self.lib_name, self.name, self.lib = lib_name, name, None
        self.fn = self._load

    def _load(self, *args) -> int:
        build((self.lib_name,))
        return self.fn(*args)

    def __call__(self, *args) -> None:
        rc = self.fn(*args)
        if rc:
            raise RuntimeError(f"{self.name}: CUDA error {rc}: "
                               f"{self.lib.fab_error_string(rc).decode()}")


_entries = {fn: _Entry(lib, fn) for lib, fns in _SIGS.items() for fn in fns}
# PyTorch's current stream as a raw handle, without a torch.cuda.Stream
# object (CUDA builds of torch only; a CPU tensor never reaches it)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def reset_counts() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def first_launch(name: str) -> bool:
    """True until ``name`` has launched once in this process: its next
    launch loads its library if nothing built it yet, and pays CUDA's
    lazy load of its module onto the card."""
    return name not in _launched


def _count(name: str) -> None:
    with _count_lock:
        launches[name] += 1
        _launched.add(name)


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
            lib.fab_error_string.argtypes = [ctypes.c_int]
            lib.fab_error_string.restype = ctypes.c_char_p
            for fn, argtypes in _SIGS[n].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                _entries[fn].lib = lib
                _entries[fn].fn = f
            _libs[n] = lib
    return time.perf_counter() - t0


def _stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return _raw_stream(t.get_device())


def _cuda(*ts) -> None:
    for t in ts:
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError("kernel operands must be contiguous CUDA tensors")


# ---------------------------------------------------------------------------
# Launch wrappers: the ops modules call these only for CUDA tensors.


def p256_verify(frame: torch.Tensor, consts: torch.Tensor,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """[B, cols] int16 frame → [B] bool (``ops/p256v3.py``), written
    into ``out`` when given (a contiguous [B] bool tensor: one chunk's
    slice of a chunked launch's output vector)."""
    if out is None:
        out = torch.empty(frame.shape[0], dtype=torch.bool, device=frame.device)
    elif out.dtype != torch.bool or out.shape != (frame.shape[0],):
        raise ValueError(f"p256_verify: out must be a [{frame.shape[0]}] bool tensor")
    _cuda(frame, consts, out)
    _entries["fab_p256_verify"](frame.data_ptr(), frame.shape[0], consts.data_ptr(),
                                out.data_ptr(), _stream(frame))
    _count("p256_verify")
    return out


# the policy kernel's sizes: stage2.cu's (rows, plan words), and the
# entries a CTA the host gives it, at most its 128 threads (more CTAs,
# fewer staged words and signature bits a thread)
POLICY_ENTRIES = 32
POLICY_ROW_BYTES = 32768  # a CTA's staged rows (dynamic shared memory)
POLICY_PLAN_WORDS = 256   # a plan's int32 words


def stage2_policy(sig_valid, frames, meta, n_cta: int, smem: int, T: int, safe_out,
                  fail_tx) -> None:
    """Every policy group of one block in one launch: ``frames`` (int32,
    the groups' frames one after another), ``meta`` (int32, the CTA
    table and plans, ``device_block.PolicyTable``) → the entries' safe
    bits into ``safe_out`` (int8 [E]) and each entry's transaction into
    ``fail_tx`` (int32 [E]) where its verdict is false, else -1."""
    _cuda(sig_valid, frames, meta, safe_out, fail_tx)
    if meta.data_ptr() % 16:
        raise ValueError("stage2_policy: the table's CTA rows are read 16 bytes at a time")
    _entries["fab_stage2_policy"](sig_valid.data_ptr(), sig_valid.shape[0], frames.data_ptr(),
                                  meta.data_ptr(), n_cta, smem, T, safe_out.data_ptr(),
                                  fail_tx.data_ptr(), _stream(frames))
    _count("stage2_policy")


def mvcc_fixpoint_in_smem(T: int) -> bool:
    """Whether ``fab_mvcc_fixpoint`` stages direct | phantom in shared
    memory at T transactions (else its rounds read global memory)."""
    return bool(_entries["fab_mvcc_fixpoint_in_smem"].fn(T))


def _bitsets(static_p, R: int, W: int, Q: int):
    """The direct and phantom words, [T, ceil(T/32)] each, in one allocation."""
    if static_p.shape[1] != R + W + 2 * Q:
        raise ValueError(f"static frame has {static_p.shape[1]} columns, "
                         f"expected R + W + 2Q = {R + W + 2 * Q}")
    T = static_p.shape[0]
    both = torch.empty((2, T, (T + 31) // 32), dtype=torch.int32, device=static_p.device)
    return both[0], both[1]


def stage2_mvcc(static_p, R: int, W: int, Q: int, launch_vec, sig_valid,
                fail_tx, out) -> None:
    """Conflict bitsets + the validity fixpoint of one block, writing
    valid | conflict | phantom | creator_ok | policy_ok | sig_valid into
    ``out`` (int8 [5T + n_sig + ...]); ``fail_tx`` (int32 [E]) names the
    transactions whose policy failed (``stage2_policy``'s), -1 elsewhere."""
    _cuda(static_p, launch_vec, sig_valid, fail_tx, out)
    T = static_p.shape[0]
    direct, phantom = _bitsets(static_p, R, W, Q)
    s = _stream(static_p)
    _entries["fab_mvcc_bitsets"](static_p.data_ptr(), T, R, W, Q,
                                 direct.data_ptr(), phantom.data_ptr(), s)
    _entries["fab_mvcc_fixpoint"](T, direct.data_ptr(), phantom.data_ptr(), None, None,
                                  launch_vec.data_ptr(), sig_valid.data_ptr(), sig_valid.shape[0],
                                  fail_tx.data_ptr(), fail_tx.shape[0], out.data_ptr(), s)
    _count("stage2_mvcc")


def mvcc_hostver(static_p, R: int, W: int, Q: int, ver_ok, pre_ok, out) -> None:
    """Conflict bitsets + fixpoint with the per-read compare done on the
    host, writing valid | conflict | phantom into ``out`` (int8 [3T])."""
    _cuda(static_p, ver_ok, pre_ok, out)
    T = static_p.shape[0]
    direct, phantom = _bitsets(static_p, R, W, Q)
    s = _stream(static_p)
    _entries["fab_mvcc_bitsets"](static_p.data_ptr(), T, R, W, Q,
                                 direct.data_ptr(), phantom.data_ptr(), s)
    _entries["fab_mvcc_fixpoint"](T, direct.data_ptr(), phantom.data_ptr(), ver_ok.data_ptr(),
                                  pre_ok.data_ptr(), None, None, 0, None, 0, out.data_ptr(), s)
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
    _entries["fab_mvcc_verok"](read_keys.data_ptr(), read_present.data_ptr(),
                               read_vers.data_ptr(), comm_present.data_ptr(), comm_vers.data_ptr(),
                               T, read_keys.shape[1], ver_ok.data_ptr(), s)
    _entries["fab_mvcc_bitsets"](static_p.data_ptr(), T, R, W, Q,
                                 direct.data_ptr(), phantom.data_ptr(), s)
    _entries["fab_mvcc_fixpoint"](T, direct.data_ptr(), phantom.data_ptr(), ver_ok.data_ptr(),
                                  pre_ok.data_ptr(), None, None, 0, None, 0, out.data_ptr(), s)
    _count("mvcc_validate")


def resident_verok(static_p, R: int, table, u_pack, read_pv, launch_vec) -> None:
    """The committed-version check of one block against the resident
    table, written into column 2 of ``launch_vec`` (int32 [T, 3])."""
    _cuda(static_p, table, u_pack, read_pv, launch_vec)
    T, cols = static_p.shape
    if read_pv.shape != (T, R, 3) or launch_vec.shape != (T, 3) or u_pack.shape[1] != 4:
        raise ValueError("resident_verok: operand shapes disagree")
    if u_pack.data_ptr() % 16:
        raise ValueError("resident_verok: u_pack rows are read 16 bytes at a time")
    _entries["fab_resident_verok"](static_p.data_ptr(), T, cols, R, table.data_ptr(),
                                   table.shape[0], u_pack.data_ptr(), u_pack.shape[0],
                                   read_pv.data_ptr(), launch_vec.data_ptr(), _stream(table))
    _count("resident_verok")


def table_scatter(table, idx, rows) -> None:
    """table[idx[i]] = rows[i] for int32 [k] ``idx`` (checked in range
    by the caller) and int32 [k, 3] ``rows``."""
    _cuda(table, idx, rows)
    _entries["fab_table_scatter"](table.data_ptr(), idx.data_ptr(), rows.data_ptr(), idx.shape[0],
                                  _stream(table))
    _count("table_scatter")


def p256_sign(limbs, consts, comb, chains: int) -> torch.Tensor:
    """[B, 16] int16 nonce limbs → [B, 2, 8] int32 (uint32 bit patterns
    of the projective X and Z of k·G, Montgomery form), each lane's
    digits summed in ``chains`` chains (1, 2, 4, 8 or 16)."""
    _cuda(limbs, consts, comb)
    out = torch.empty((limbs.shape[0], 2, 8), dtype=torch.int32, device=limbs.device)
    _entries["fab_p256_sign"](limbs.data_ptr(), limbs.shape[0], chains, consts.data_ptr(),
                              comb.data_ptr(), out.data_ptr(), _stream(limbs))
    _count("p256_sign")
    return out


def p256_sign_tpi(B: int) -> int:
    """The threads a chain ``p256_sign`` runs a B-lane batch with (8 or 4)."""
    return _entries["fab_p256_sign_tpi"].fn(B)


def sha256_blocks(blocks, nblocks) -> torch.Tensor:
    """[B, M, 16] int32 padded big-endian words, [B] int32 block counts
    → [B, 8] int32 digest words (uint32 bit patterns)."""
    _cuda(blocks, nblocks)
    if blocks.data_ptr() % 16:
        raise ValueError("sha256_blocks: blocks are staged 16 bytes at a time")
    B, M = blocks.shape[0], blocks.shape[1]
    out = torch.empty((B, 8), dtype=torch.int32, device=blocks.device)
    _entries["fab_sha256_blocks"](blocks.data_ptr(), nblocks.data_ptr(), B, M,
                                  out.data_ptr(), _stream(blocks))
    _count("sha256_blocks")
    return out


def p256_verify_v1(frame, consts) -> torch.Tensor:
    """[B, 80] int32 frame of 16-bit limbs → [B] bool (``ops/p256.py``, v1)."""
    _cuda(frame, consts)
    out = torch.empty(frame.shape[0], dtype=torch.bool, device=frame.device)
    _entries["fab_p256_verify_v1"](frame.data_ptr(), frame.shape[0], consts.data_ptr(),
                                   out.data_ptr(), _stream(frame))
    _count("p256_verify_v1")
    return out


def p256_verify_v2(frame, consts) -> torch.Tensor:
    """[B, 260] int32 digit frame → [B] bool (``ops/p256v2.py``)."""
    _cuda(frame, consts)
    out = torch.empty(frame.shape[0], dtype=torch.bool, device=frame.device)
    _entries["fab_p256_verify_v2"](frame.data_ptr(), frame.shape[0], consts.data_ptr(),
                                   out.data_ptr(), _stream(frame))
    _count("p256_verify_v2")
    return out


def verify_attrs(name: str, B: int) -> dict:
    """The kernel ``p256_verify_v1`` or ``p256_verify_v2`` (``name``) runs a
    B-lane batch with: its threads a lane (``tpi``), registers a thread and
    local bytes a thread (stack frame, spills included), as
    ``cudaFuncGetAttributes`` reports them."""
    out = (ctypes.c_int * 3)()
    _entries[f"fab_{name}_attrs"](B, out)
    return {"tpi": out[0], "registers": out[1], "local_bytes": out[2]}
