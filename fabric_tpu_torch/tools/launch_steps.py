"""Where a kernel's time goes: ``p256_verify`` at each team size, and the
launch path's steps one at a time against the device's time alone.

    python3 -m fabric_tpu_torch.tools.launch_steps [--parent-csrc DIR]
        [--phase all|team_sizes|scatter|small] [--team-lanes 3072,6144,12288]

Run from the repository root on a CUDA host: it reuses ``chip_smoke.py``'s
operand builders.  One JSON line per measurement.

- ``team_sizes``: ``p256_verify`` built twice more with
  ``FAB_TEAM8_LANES`` set so that every batch runs at TPI = 8, or at 4,
  beside the wrapper (which picks by batch), on ``chip_smoke.py``'s
  adversarial frames at each of ``--team-lanes``; each build is checked
  against ``verify_batch_ref`` first.
- ``scatter``: ``table_scatter`` on the 48 MiB resident table at k = 16
  and 2,048.  The wrapper's host microseconds per call (wall time over
  1,000 calls, then one synchronize) with the launch path as it was
  before its redesign (a ``torch.cuda.Stream`` object per call, a
  ``torch.device`` per operand check, a library and ``getattr`` lookup
  per call), with each step of the redesign applied alone, as the
  wrappers have it (one checked call of the entry point), and with the
  error check written out in the wrapper; beside ``index_copy_``.  With
  ``--parent-csrc``, the older path also launches the kernel built from
  that directory's ``resident.cu`` (one thread per row).  Then the same
  variants' time per call on the card's clock (CUDA events around 100
  calls), as ``chip_smoke.py`` reports ``ms``, and the device's time
  alone per launch (200 launches captured in one CUDA graph, replayed)
  of the kernel, ``index_copy_`` and the older kernel.
- ``small``: ``stage2_policy`` and ``resident_verok`` at their
  ``chip_smoke.py`` shapes, outputs allocated once: device alone, host
  microseconds and event time per call.

Every variant runs in each of 8 rounds, the order reversed every other
round (ABBA); the lines give medians and the rounds.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROUNDS = 8
ROOT = Path(__file__).resolve().parents[2]


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def host_us(fn, n: int = 1000) -> float:
    """Wall microseconds per call over ``n`` calls, then one synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / n


def event_ms(fn, n: int = 100) -> float:
    """Milliseconds per call on the card's clock, events around ``n`` calls."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def graph_us(fn, n: int = 200, reps: int = 5) -> float:
    """Device microseconds per call alone: ``n`` calls captured in one
    CUDA graph, replayed ``reps`` times between two events."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e3 / (n * reps)


def abba(variants: dict, measure) -> dict:
    """``measure(fn)`` of every variant in ROUNDS rounds, the order
    reversed every other round → {name: {"median", "rounds"}}."""
    names = list(variants)
    got = {k: [] for k in names}
    for r in range(ROUNDS):
        for k in (names if r % 2 == 0 else names[::-1]):
            got[k].append(measure(variants[k]))
    return {k: {"median": float(np.median(v)), "rounds": v} for k, v in got.items()}


def _build_libs(specs: dict) -> dict:
    """{tag: (source .cu, extra nvcc flags, entry)} → {tag: ctypes library},
    each built by its own nvcc, all started together, with the flags
    ``kernels.build`` uses; ``entry`` is bound with the wrapper's types."""
    from fabric_tpu_torch import kernels

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (src, flags, _) in specs.items():
        out = kernels.BUILD_DIR / f"lib{Path(src).stem}-{tag}.so"
        procs[tag] = (out, subprocess.Popen(
            [kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", *flags, "-o", str(out), str(src)]))
    libs = {}
    for tag, (out, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {tag}")
        lib = ctypes.CDLL(str(out))
        entry = specs[tag][2]
        lib_name = next(n for n, fns in kernels._SIGS.items() if entry in fns)
        getattr(lib, entry).argtypes = kernels._SIGS[lib_name][entry]
        getattr(lib, entry).restype = ctypes.c_int
        lib.fab_error_string.argtypes = [ctypes.c_int]
        lib.fab_error_string.restype = ctypes.c_char_p
        libs[tag] = lib
    return libs


def scatter_variants(parent_lib):
    """The launch path before its redesign, each step alone, and now."""
    from fabric_tpu_torch import kernels

    entry = kernels._entries["fab_table_scatter"]
    libs = {"resident": entry.lib}

    def old_checks(*ts):
        for t in ts:
            if t is not None and (t.device.type != "cuda" or not t.is_contiguous()):
                raise ValueError("kernel operands must be contiguous CUDA tensors")

    def old_stream(t):
        return torch.cuda.current_stream(t.device).cuda_stream

    def _fn(lib_name, fn):
        if lib_name not in libs:
            raise KeyError(lib_name)
        return libs[lib_name], getattr(libs[lib_name], fn)

    def lookup(lib_name):
        def call(*args):  # a library and getattr lookup per call
            lib, f = _fn(lib_name, "fab_table_scatter")
            rc = f(*args)
            if rc != 0:
                raise RuntimeError(f"CUDA error {rc}: {lib.fab_error_string(rc).decode()}")
        return call

    def checked(*args):  # the entry point resolved once, its error checked in a helper
        rc = entry.fn(*args)
        if rc:
            raise RuntimeError(f"CUDA error {rc}")

    def inline(table, idx, rows):  # as the wrappers have it, the check written out
        kernels._cuda(table, idx, rows)
        rc = entry.fn(table.data_ptr(), idx.data_ptr(), rows.data_ptr(), idx.shape[0],
                      kernels._stream(table))
        if rc:
            raise RuntimeError(f"CUDA error {rc}")
        kernels._count("table_scatter")

    def wrapper(checks, stream, call):
        def launch(table, idx, rows):
            checks(table, idx, rows)
            call(table.data_ptr(), idx.data_ptr(), rows.data_ptr(), idx.shape[0],
                 stream(table))
            kernels._count("table_scatter")
        return launch

    new_checks, new_stream = kernels._cuda, kernels._stream
    out = {
        "before": wrapper(old_checks, old_stream, lookup("resident")),
        "raw_stream_only": wrapper(old_checks, new_stream, lookup("resident")),
        "cheap_checks_only": wrapper(new_checks, old_stream, lookup("resident")),
        "bound_once_only": wrapper(old_checks, old_stream, checked),
        "all_checked_in_a_call": kernels.table_scatter,
        "all_inline": inline,
    }
    if parent_lib is not None:
        libs["parent"] = parent_lib
        out["before_older_kernel"] = wrapper(old_checks, old_stream, lookup("parent"))
    return out


def phase_scatter(dev, parent_lib) -> None:
    import chip_smoke as cs
    from fabric_tpu_torch.state import residency

    table = torch.zeros((cs.TABLE_SLOTS, 3), dtype=torch.int32, device=dev)
    variants = scatter_variants(parent_lib)
    rng = np.random.default_rng(cs.SEED + 6)
    for k in (16, 2048):
        idx = rng.choice(cs.TABLE_SLOTS, k, replace=False).astype(np.int32)
        rows = rng.integers(-(1 << 31), 1 << 31, (k, 3)).astype(np.int32)
        it, rt = torch.from_numpy(idx).to(dev), torch.from_numpy(rows).to(dev)
        want = table.clone()
        residency.table_scatter_ref(want, it, rt)
        for name, fn in variants.items():
            got = table.clone()
            fn(got, it, rt)
            if not torch.equal(got, want):
                raise AssertionError(f"table_scatter variant {name} differs at k = {k}")
        ilong = it.long()
        calls = {name: (lambda fn=fn: fn(table, it, rt)) for name, fn in variants.items()}
        calls["index_copy_"] = lambda: table.index_copy_(0, ilong, rt)
        log("scatter_host_us", k=k, **abba(calls, host_us))
        log("scatter_event_ms", k=k, **abba(calls, event_ms))
        dev_calls = {"kernel": calls["all_checked_in_a_call"],
                     "index_copy_": calls["index_copy_"]}
        if parent_lib is not None:
            dev_calls["older_kernel"] = calls["before_older_kernel"]
        log("scatter_device_us", k=k, **abba(dev_calls, graph_us))


def phase_small_kernels(dev) -> None:
    import chip_smoke as cs
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.peer import device_block as db

    sv, lv, groups, sp, _ = cs.stage2_inputs(dev)
    T = lv.shape[0]
    plan, gp, Eb, S = groups[0]
    pt = torch.tensor(db.plan_vector(plan), dtype=torch.int32, device=dev)
    pok = torch.ones(T + 1, dtype=torch.int32, device=dev)
    safe = torch.empty(Eb, dtype=torch.int8, device=dev)
    policy = lambda: kernels.stage2_policy(sv, gp, S, len(plan.principals), pt, pok, safe)
    (rsp, table, u_pack, rpv), _ = cs.resident_inputs(dev, 2048)
    rlv = torch.zeros((cs.RES_T, 3), dtype=torch.int32, device=dev)
    verok = lambda: kernels.resident_verok(rsp, cs.RES_R, table, u_pack, rpv, rlv)
    for name, fn in (("stage2_policy", policy), ("resident_verok", verok)):
        calls = {"device_us": lambda fn=fn: graph_us(fn), "host_us": lambda fn=fn: host_us(fn),
                 "event_ms": lambda fn=fn: event_ms(fn)}
        log("small_kernel", name=name, **abba(calls, lambda m: m()))


def phase_team_sizes(dev, shapes) -> None:
    """p256_verify at each team size alone (builds of p256_verify.cu
    whose FAB_TEAM8_LANES sends every batch to one size), at each of
    ``shapes`` lanes, beside the wrapper's own choice."""
    import chip_smoke as cs
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.ops import p256v3 as v3

    src = kernels.CSRC / "p256_verify.cu"
    libs = _build_libs({"tpi8": (src, ["-DFAB_TEAM8_LANES=2147483647"], "fab_p256_verify"),
                        "tpi4": (src, ["-DFAB_TEAM8_LANES=0"], "fab_p256_verify")})

    def launch(lib, frame, consts, out):
        rc = lib.fab_p256_verify(frame.data_ptr(), frame.shape[0], consts.data_ptr(),
                                 out.data_ptr(), kernels._stream(frame))
        if rc:
            raise RuntimeError(f"CUDA error {rc}")

    net = cs.Net(cs.SEED)
    consts = v3._kernel_consts(dev)
    for lanes in shapes:
        items, _ = cs.adversarial_items(net, lanes)
        frame = torch.from_numpy(v3.stage_frame(items, v3._bucket(len(items)))).to(dev)
        want = v3.verify_batch_ref(frame)
        out = torch.empty(frame.shape[0], dtype=torch.bool, device=dev)
        calls = {tag: (lambda lib=lib: launch(lib, frame, consts, out))
                 for tag, lib in libs.items()}
        calls["wrapper"] = lambda: kernels.p256_verify(frame, consts)
        for tag in libs:
            calls[tag]()
            if not torch.equal(out, want):
                raise AssertionError(f"p256_verify built {tag}, {lanes} lanes: differs")
        if not torch.equal(kernels.p256_verify(frame, consts), want):
            raise AssertionError(f"p256_verify at {lanes} lanes differs")
        log("team_sizes", lanes=lanes, **abba(calls, lambda fn: event_ms(fn, 5)))


def main() -> int:
    if not torch.cuda.is_available():
        print("launch_steps: needs a CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", type=Path, default=None,
                    help="a csrc directory whose resident.cu is the older table_scatter")
    ap.add_argument("--phase", choices=("all", "team_sizes", "scatter", "small"), default="all")
    ap.add_argument("--team-lanes", default="3072,6144,12288")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from fabric_tpu_torch import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log("device", nvidia_smi=smi, torch=torch.__version__)
    kernels.build(("resident", "stage2", "p256_verify"))
    parent = None
    if args.parent_csrc:
        parent = _build_libs({"parent": (args.parent_csrc / "resident.cu", [],
                                         "fab_table_scatter")})["parent"]
    dev = torch.device("cuda")
    if args.phase in ("all", "team_sizes"):
        phase_team_sizes(dev, [int(x) for x in args.team_lanes.split(",")])
    if args.phase in ("all", "scatter"):
        phase_scatter(dev, parent)
    if args.phase in ("all", "small"):
        phase_small_kernels(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
