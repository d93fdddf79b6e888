"""Where a kernel's time goes: ``p256_verify`` at each team size,
``p256_sign`` at each team size and chain count, the stage-2 MVCC
kernels alone and as one launch, the launch path's steps one at a
time against the device's time alone, the comparison verifiers at each
team size, the comparison path with this tree's or the parent's
verifier, and the wire commit path's phases with this tree's package or
an older one.

    python3 -m fabric_tpu_torch.tools.launch_steps [--parent-csrc DIR]
        [--parent-tree DIR]
        [--phase all|team_sizes|sign_shapes|stage2|scatter|small|sha256|
                 comparison|comparison_path|main_path|wire_path|coalesced_path|
                 sidecar|config5_path|ledger_path]
        [--team-lanes 3072,6144,12288]
        [--sign-lanes 16,32,64,128,256,512,1024,4096]
        [--comparison-lanes 16,4096,12288] [--path-blocks 12]

Run from the repository root on a CUDA host: it reuses ``chip_smoke.py``'s
operand builders.  One JSON line per measurement.  ``--parent-csrc``
names another ``csrc`` directory (an older commit's, unpacked with
``git archive``) whose kernels run beside this tree's.

- ``team_sizes``: ``p256_verify`` built twice more with
  ``FAB_TEAM8_LANES`` set so that every batch runs at TPI = 8, or at 4,
  beside the wrapper (which picks by batch), on ``chip_smoke.py``'s
  adversarial frames at each of ``--team-lanes``; each build is checked
  against ``verify_batch_ref`` first.
- ``sign_shapes``: ``p256_sign`` built twice more with
  ``FAB_SIGN_TEAM8_LANES`` set so that every batch runs at TPI = 8, or
  at 4, at every chain count (1, 2, 4, 8, 16), beside the wrapper
  (``sign_chains`` and the source's TPI rule) and the parent's kernel,
  on ``chip_smoke.py``'s nonces (edge nonces first) at each of
  ``--sign-lanes``; each (TPI, C) is checked bit for bit against
  ``sign_batch_ref(chains=C)``, the parent's on the affine x of 16 lanes.
- ``stage2``: ``mvcc_bitsets`` and ``mvcc_fixpoint`` each alone on the
  device (a CUDA graph) and the ``stage2_mvcc`` wrapper as one launch
  (card clock, its allocation included), this tree's and the parent's
  kernels, at two sets of operands: ``chip_smoke.stage2_inputs``
  (T = 1024, a 20-deep chain) and the first block of ``chip_smoke.py``'s
  main path, captured at its ``stage2_mvcc`` call; with the Jacobi round
  count of each and the packed outputs checked equal.
- ``scatter``: ``table_scatter`` on the 48 MiB resident table at k = 16
  and 2,048.  The wrapper's host microseconds per call (wall time over
  1,000 calls, then one synchronize) with the launch path as it was
  before its redesign (a ``torch.cuda.Stream`` object per call, a
  ``torch.device`` per operand check, a library and ``getattr`` lookup
  per call), with each step of the redesign applied alone, as the
  wrappers have it (one checked call of the entry point), and with the
  error check written out in the wrapper; beside ``index_copy_``.  With
  ``--parent-csrc``, the older path also launches the kernel built from
  that directory's ``resident.cu``.  Then the same variants' time per
  call on the card's clock (CUDA events around 100 calls), as
  ``chip_smoke.py`` reports ``ms``, and the device's time alone per
  launch (200 launches captured in one CUDA graph, replayed) of the
  kernel, ``index_copy_`` and the older kernel.
- ``small``: ``stage2_policy``, ``resident_verok``, ``table_scatter``
  and ``sha256_blocks``, each at its smallest shape (one entry, one
  read, one row, one message) and at its path's (``chip_smoke.py``'s:
  the main path's two policy groups, Eb = 1,024 + 16, and a config-4
  block's three; T = 1,024 with 2,048 pack rows; k = 2,048 rows; 4,096
  x 200 B, and the first wire block's signed messages as ``sha256_host``
  buckets them): device alone (a CUDA graph), host microseconds and
  event time per call, the launch floor of each.  With
  ``--parent-csrc`` the older ``stage2.cu``'s policy stage (a
  ``torch.ones`` fill and one launch a group), ``resident.cu``'s
  ``resident_verok`` and ``sha256.cu``'s kernel, each where its source
  differs from this tree's, run beside this tree's, in turns, each
  checked against the plain version.
- ``sha256``: ``sha256_blocks`` and, with ``--parent-csrc``, the older
  kernel, each with ptxas's report and its round loop's SASS by pipe,
  in turns alone on the device at one message, 4,096 x 200 B and the
  first wire block's messages, beside the bound, serial ``hashlib`` and
  each kernel's chain floor.
- ``comparison``: ``p256_verify_v1`` built twice more with
  ``FAB_V1_TEAM8_LANES`` set so that every batch runs at TPI = 8, or at
  4, beside the wrapper (v1 picks its team size by batch, v2 runs at
  TPI = 8) and (with ``--parent-csrc``) the parent's kernels (the
  one-thread v2 with its constant block in ``__constant__`` memory), on
  ``chip_smoke.comparison_items`` at each of ``--comparison-lanes``
  (below 3,072 lanes a random sample of its 3,072);
  each variant checked against the plain version, timed on the card's
  clock (events around 3 calls).
- ``comparison_path`` (needs ``--parent-csrc``): ``chip_smoke.py``'s
  comparison path (``BlockValidator(kernel="v1"|"v2")`` under
  ``CommitPipeline(depth=2)``) over ``--path-blocks`` bench-shaped
  blocks, with this tree's verifier and with the parent's swapped into
  the wrapper's entry point, in turns parent, tree, tree, parent: wall ms
  a block over all blocks and over the blocks after the first (the
  first holds the pipeline's fill and the run's first launches).
- ``wire_path`` (needs ``--parent-tree``, an older checkout unpacked
  with ``git archive``): ``chip_smoke.py``'s wire blocks (one, then
  ``--path-blocks``) through ``CommitPipeline(depth=2)`` with
  ``BlockValidator.timings`` on, each run in a process of its own that
  imports ``fabric_tpu_torch`` from that tree or from this one, in turns
  parent, tree, tree, parent: wall ms a block over the blocks after the
  first, ms a block by phase, and the front end's ``decode_block`` ms a
  block on the same blocks; every run's filters equal the
  construction's.  A package without phase timers gets them from
  ``add_timers``, which wraps its validator's methods where this tree's
  ``BlockValidator`` reads its clock.

- ``main_path`` (needs ``--parent-tree``): ``chip_smoke.py``'s main
  path (bench-shaped ``DecodedBlock``s of 1,000 transactions, one then
  ``--path-blocks``, through ``CommitPipeline(depth=2)``) as the wire
  path above, in turns parent, tree, tree, parent: wall ms a block over
  the blocks after the first, and ms a block by phase, the first block
  apart; every run's filters equal the construction's.

- ``coalesced_path`` (needs ``--parent-tree``): the wire path as above
  with the parent's package and with this tree's, each one ``submit`` a
  block and coalesced (``submit_many`` with ``coalesce_blocks=4`` over
  ``BlockValidator(host_stage_workers=-1)``: the first block alone, then
  groups of 4, one ``p256_verify`` launch a group), in turns parent,
  tree, tree, parent, each a process of its own; a turn's two modes
  share its process, in the other order in a package's second turn.

- ``sidecar`` (needs ``--parent-tree``): ``chip_smoke.py``'s sidecar
  tenants (3 ``SidecarValidator``s of weights 1, 1 and 2, each over its
  own ``--path-blocks`` bench-shaped ``DecodedBlock``s, under
  ``CommitPipeline(depth=2)`` at once, one ``SidecarServer`` on
  127.0.0.1 with coalesce 4 and 8 queued blocks a tenant) with the
  parent's package and this tree's, in turns parent, tree, tree,
  parent, each a process of its own: ``tx_per_s_all``, each tenant's
  tx/s, the server's dispatches and coalesce occupancy, and the peers'
  host-path phase ms a block; every tenant's filters equal the
  construction's.

- ``config5_path`` (needs ``--parent-tree``): ``chip_smoke.py``'s
  config 5 blocks (built once, in this process, and handed to each turn
  as bytes) through ``CommitPipeline(depth=2)`` with the parent's
  package and this tree's, in turns parent, tree, tree, parent: wall ms
  a block after the first, ms a block by phase, the idemix proof checks'
  host ms; every turn's filters equal the construction's.  A package
  that refuses idemix creators fails its turn.

- ``ledger_path`` (needs ``--parent-tree``): ``chip_smoke.py``'s ledger
  chain (12 wire blocks of 1,000 txs, built once here and handed to
  each turn as bytes with the orgs' root certificates) committed into a
  source ``KVLedger`` (sqlite state, history, the async applier), then
  ``replay_into`` a fresh one at depth 2, with the parent's package and
  this tree's, in turns parent, tree, tree, parent: the replay's wall
  ms a block after the first, the first apart, tx/s, ms a block by
  phase (the validator's timers, ``ledger_commit``, ``ledger_append``,
  ``state_apply``) and the fsyncs by trigger; every turn's filters
  equal the construction's and its replay the source's digest and
  commit hash.  A package without the ledger fails its turn.

Every variant runs in each of 8 rounds, the order reversed every other
round (ABBA); the lines give medians and the rounds.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import tempfile
import threading
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


# nvcc's output per tag of ``_build_libs`` (with ``-Xptxas=-v`` among a
# tag's flags: registers, stack, spills and shared memory)
BUILD_LOGS: dict = {}


def _build_libs(specs: dict) -> dict:
    """{tag: (source .cu, extra nvcc flags, entries)} → {tag: ctypes
    library}, each built by its own nvcc, all started together, with the
    flags ``kernels.build`` uses.  ``entries`` is one entry point's name,
    bound with the wrapper's types, or {name: argtypes}."""
    from fabric_tpu_torch import kernels

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (src, flags, _) in specs.items():
        out = kernels.BUILD_DIR / f"lib{Path(src).stem}-{tag}.so"
        procs[tag] = (out, subprocess.Popen(
            [kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", *flags, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (out, proc) in procs.items():
        BUILD_LOGS[tag] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{BUILD_LOGS[tag]}")
        lib = ctypes.CDLL(str(out))
        entries = specs[tag][2]
        if isinstance(entries, str):
            lib_name = next(n for n, fns in kernels._SIGS.items() if entries in fns)
            entries = {entries: kernels._SIGS[lib_name][entries]}
        for name, argtypes in entries.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        lib.fab_error_string.argtypes = [ctypes.c_int]
        lib.fab_error_string.restype = ctypes.c_char_p
        libs[tag] = lib
    return libs


def _check(rc: int) -> None:
    if rc:
        raise RuntimeError(f"CUDA error {rc}")


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


def swapped(entry: str, fn, call):
    """``call`` with the wrapper's C entry point ``entry`` bound to
    ``fn`` (another build's) for the call, so that two builds are timed
    through one wrapper."""
    from fabric_tpu_torch import kernels

    e = kernels._entries[entry]

    def run():
        own, e.fn = e.fn, fn
        try:
            call()
        finally:
            e.fn = own

    return run


def phase_small_kernels(dev, parent_csrc=None) -> None:
    """``stage2_policy``, ``resident_verok``, ``table_scatter`` and
    ``sha256_blocks``, each at its smallest shape and at its path's,
    beside the parent's kernels (``parent_csrc``) where their source
    differs from this tree's, three ways: the device's time alone (a
    CUDA graph), the host microseconds and the card-clock time per call.
    The policy stage is timed as a block runs it: this tree's one launch
    over every group (its fail list allocated), an older parent's
    ``torch.ones`` fill and one launch a group, at one entry, at
    ``stage2_inputs``' two groups and at
    ``chip_smoke.config4_policy_groups``' three.  ``sha256_blocks`` at one
    message, 4,096 x 200 B and the first wire block's signed messages.
    Each variant's outputs are checked against the plain version first."""
    import chip_smoke as cs
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.ops import sha256
    from fabric_tpu_torch.peer import device_block as db
    from fabric_tpu_torch.state import residency

    # the parent's kernels where its source differs from this tree's (a
    # differing stage2.cu's policy entry taken with its one-launch-a-group
    # signature): {tag: (source, ctypes entries, the entry called)}
    older = {"policy": ("stage2.cu", PARENT_STAGE2_SIGS, "fab_stage2_policy"),
             "verok": ("resident.cu", "fab_resident_verok", "fab_resident_verok"),
             "sha": ("sha256.cu", "fab_sha256_blocks", "fab_sha256_blocks")}
    older = {t: v for t, v in older.items() if parent_csrc is not None and
             (parent_csrc / v[0]).read_bytes() != (kernels.CSRC / v[0]).read_bytes()}
    libs = _build_libs({t: (parent_csrc / src, [], sigs)
                        for t, (src, sigs, _) in older.items()}) if older else {}
    parent = {t: getattr(libs[t], entry) for t, (_, _, entry) in older.items()}
    log("small_parent", compared=sorted(parent))

    sv, lv, groups, sp, _ = cs.stage2_inputs(dev)
    T = lv.shape[0]
    plan, gp, Eb, S = groups[0]
    P = len(plan.principals)

    def policy(gs):
        """{variant: the block's policy stage} over ``gs``, each checked."""
        launch, fail, safe, _ = cs.policy_launch(sv, gs, T)

        def tree():
            torch.empty(fail.shape[0], dtype=torch.int32, device=dev)
            launch()

        want_fail, want_safe = cs.policy_plain(sv, gs, T)
        tree()
        torch.cuda.synchronize()
        if not (torch.equal(fail, want_fail) and torch.equal(safe, want_safe)):
            raise AssertionError("stage2_policy differs from its plain version")
        out = {"tree": tree}
        if "policy" in parent:
            pts = [torch.tensor(db.plan_vector(p), dtype=torch.int32, device=dev)
                   for p, _, _, _ in gs]
            psafe = torch.empty(safe.shape[0], dtype=torch.int8, device=dev)
            got = {}

            def older():
                """The parent's stage 2 up to its MVCC launch: a fill,
                then its wrapper (checks, launch, count) a group."""
                pok = got["pok"] = torch.ones(T + 1, dtype=torch.int32, device=dev)
                off = 0
                for (p, g, eb, s), pt in zip(gs, pts):
                    out = psafe[off:off + eb]
                    kernels._cuda(sv, g, pt, pok, out)
                    _check(parent["policy"](sv.data_ptr(), sv.shape[0], g.data_ptr(), eb, s,
                                     len(p.principals), pt.data_ptr(), pok.data_ptr(), T,
                                     out.data_ptr(), kernels._stream(g)))
                    kernels._count("stage2_policy")
                    off += eb

            older()
            torch.cuda.synchronize()
            if not (torch.equal(got["pok"], policy_ok_of(want_fail, T))
                    and torch.equal(psafe, want_safe)):
                raise AssertionError("the parent's stage2_policy differs from the plain version")
            out["parent"] = older
        return out

    (rsp, table, u_pack, rpv), _ = cs.resident_inputs(dev, 2048)
    rsp1 = rsp[:1].clone()
    rsp1[0, 0], rsp1[0, 1] = 0, -1

    def verok(spk, up, pv):
        rlv = torch.zeros((spk.shape[0], 3), dtype=torch.int32, device=dev)
        want = db.resident_ver_ok_ref(spk, table, up, pv, cs.RES_R)
        call = lambda: kernels.resident_verok(spk, cs.RES_R, table, up, pv, rlv)
        out = {"tree": call}
        if "verok" in parent:  # the same wrapper, its entry point the parent's
            out["parent"] = swapped("fab_resident_verok", parent["verok"], call)
        for tag, fn in out.items():
            rlv.zero_()
            fn()
            if not torch.equal(rlv[:, 2] != 0, want):
                raise AssertionError(f"resident_verok ({tag}) differs from its plain version")
        return out

    rng = np.random.default_rng(cs.SEED + 6)

    def scatter(k):
        """(the kernel on device operands, the wrapper on host arrays
        as the commit path calls it)"""
        idx = rng.choice(cs.TABLE_SLOTS, k, replace=False).astype(np.int32)
        rows = rng.integers(0, 1 << 20, (k, 3)).astype(np.int32)
        it, rt = torch.from_numpy(idx).to(dev), torch.from_numpy(rows).to(dev)
        return (lambda: kernels.table_scatter(table, it, rt),
                lambda: residency.table_scatter(table, idx, rows))

    def sha(msgs, bucket=False):
        """{variant: the wrapper on ``msgs``} (this tree's kernel and the
        parent's, each checked against the plain version first)."""
        bt, nt = sha_operands(dev, msgs, bucket)
        call = lambda: sha256.sha256_blocks(bt, nt)
        out = {"tree": call}
        if "sha" in parent:
            out["parent"] = swapped("fab_sha256_blocks", parent["sha"], call)
        want = sha256.sha256_blocks_ref(bt, nt)
        sha_check(None, bt, nt, want, "tree")
        if "sha" in parent:
            sha_check(parent["sha"], bt, nt, want, "parent")
        return out

    msgs = [rng.bytes(200) for _ in range(4096)]
    c4 = cs.config4_policy_groups(dev, T, sv.shape[0])
    one = [(plan, gp[:1].contiguous(), 1, S)]
    cases = (("stage2_policy", "one_entry", policy(one)),
             ("stage2_policy", f"path_2_groups_Eb{Eb}+{groups[1][2]}_S{S}_P{P}", policy(groups)),
             ("stage2_policy", "config4_3_groups_Eb512+512+256_S4,4,8_P3,4,4", policy(c4)),
             ("resident_verok", "one_read", verok(rsp1, u_pack[:1].contiguous(),
                                                  rpv[:1].contiguous())),
             ("resident_verok", f"path_T{T}_R{cs.RES_R}_Ub2048", verok(rsp, u_pack, rpv)),
             ("table_scatter", "one_row", scatter(1)),
             ("table_scatter", "path_k2048", scatter(2048)),
             ("sha256_blocks", "one_message", sha([b"m"])),
             ("sha256_blocks", "path_4096x200B", sha(msgs)),
             ("sha256_blocks", "wire_block", sha(wire_block_messages(), bucket=True)))
    for name, shape, fns in cases:
        if not isinstance(fns, dict):  # (on device operands, the wrapper) or one call
            dev_fn, wrap = fns if isinstance(fns, tuple) else (fns, fns)
            fns = {"tree": (dev_fn, wrap)}
        calls = {}
        for tag, fn in fns.items():
            dev_fn, wrap = fn if isinstance(fn, tuple) else (fn, fn)
            calls[f"{tag}_device_us"] = lambda f=dev_fn: graph_us(f)
            calls[f"{tag}_host_us"] = lambda f=wrap: host_us(f)
            calls[f"{tag}_event_ms"] = lambda f=wrap: event_ms(f)
        log("small_kernel", name=name, shape=shape, **abba(calls, lambda m: m()))


def wire_block_messages() -> list:
    """The signed messages of ``chip_smoke.py``'s first wire block (its
    wire path's nine blocks, built the same way)."""
    import chip_smoke as cs
    from fabric_tpu_torch.protos import messages as m

    blocks, _, _, _ = cs.build_wire_blocks(cs.WireNet(cs.SEED + 9), cs.WIRE_BLOCKS)
    return cs.signed_messages(m.Block.parse(blocks[0].serialize()))


def sha_operands(dev, msgs, bucket: bool):
    """``msgs`` padded as device tensors: to their own longest message,
    or (``bucket``) to ``sha256_host``'s power-of-two batch and blocks."""
    from fabric_tpu_torch.ops import sha256
    from fabric_tpu_torch.utils.batching import next_pow2

    M = None
    if bucket:
        M = next_pow2(max((len(x) + 8) // 64 + 1 for x in msgs))
        msgs = list(msgs) + [b""] * (next_pow2(len(msgs)) - len(msgs))
    blocks, nb = sha256.pad_messages(msgs, M)
    return (torch.from_numpy(blocks.view(np.int32)).to(dev), torch.from_numpy(nb).to(dev))


def sha_check(entry_fn, bt, nt, want, what: str) -> None:
    """One call of the ``sha256_blocks`` wrapper with its entry point
    ``entry_fn`` (None: its own); raises unless it gives ``want``."""
    from fabric_tpu_torch.ops import sha256

    got = {}
    run = lambda: got.setdefault("d", sha256.sha256_blocks(bt, nt))
    (run if entry_fn is None else swapped("fab_sha256_blocks", entry_fn, run))()
    if not torch.equal(got["d"], want):
        raise AssertionError(f"sha256_blocks ({what}) differs from its plain version")


def phase_sha256(dev, parent_csrc=None) -> None:
    """``sha256_blocks`` (``tree``) and, with ``parent_csrc``, the
    parent's (``parent``), each built with ``-Xptxas -v`` (registers,
    stack, spills) and its round loop's SASS read by pipe
    (``chip_smoke.sha_sass``), run through the wrapper (its entry point
    swapped) in turns, alone on the device (a CUDA graph), at one
    message, at 4,096 x 200 B and at the first wire block's signed
    messages as ``sha256_host`` buckets them; each shape with its bound,
    serial ``hashlib`` of the same messages, and each kernel's chain
    floor."""
    import hashlib

    import chip_smoke as cs
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.ops import sha256

    csrc = {"tree": kernels.CSRC, "parent": parent_csrc}
    libs = _build_libs({tag: (d / "sha256.cu", ["-Xptxas=-v"], "fab_sha256_blocks")
                        for tag, d in csrc.items() if d is not None})
    sass = {}
    for tag in libs:
        sass[tag] = cs.sha_sass(kernels.BUILD_DIR / f"libsha256-{tag}.so")
        log("sha256_build", tag=tag, frames=cs.kernel_frames({tag: BUILD_LOGS[tag]},
                                                              ("sha256_blocks_kernel",)),
            smem=[ln.strip() for ln in BUILD_LOGS[tag].splitlines() if "smem" in ln],
            sass=sass[tag])
    rng = np.random.default_rng(cs.SEED + 11)
    shapes = {"one_message": ([b"m"], False),
              "path_4096x200B": ([rng.bytes(200) for _ in range(4096)], False),
              "wire_block": (wire_block_messages(), True)}
    for shape, (msgs, bucket) in shapes.items():
        bt, nt = sha_operands(dev, msgs, bucket)
        want = sha256.sha256_blocks_ref(bt, nt)
        calls = {}
        for tag, lib in libs.items():
            sha_check(lib.fab_sha256_blocks, bt, nt, want, f"{tag} at {shape}")
            calls[tag] = swapped("fab_sha256_blocks", lib.fab_sha256_blocks,
                                 lambda: sha256.sha256_blocks(bt, nt))
        t0 = time.perf_counter()
        for x in msgs:
            hashlib.sha256(x).digest()
        hashlib_ms = 1e3 * (time.perf_counter() - t0)
        nb = nt.cpu().numpy()
        comps, longest = int(nb.sum()), int(nb.max())
        bound_ms, bound_by = cs.sha_bound(64 * comps + 36 * len(nb), comps)
        log("sha256_shape", shape=shape, B=int(bt.shape[0]), M=int(bt.shape[1]),
            messages=len(msgs), compressions=comps, longest=longest, bound_ms=bound_ms,
            bound_by=bound_by, hashlib_serial_ms=hashlib_ms,
            chain_floor_ms={t: cs.sha_chain_floor_ms(sass[t], longest) for t in libs},
            device_us=abba(calls, graph_us))


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
        _check(lib.fab_p256_verify(frame.data_ptr(), frame.shape[0], consts.data_ptr(),
                                   out.data_ptr(), kernels._stream(frame)))

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


def phase_sign_shapes(dev, shapes, parent_csrc) -> None:
    """p256_sign at each team size alone (builds of p256_sign.cu whose
    FAB_SIGN_TEAM8_LANES sends every batch to one size) and each chain
    count, at each of ``shapes`` lanes, beside the wrapper's own choice
    and the parent's kernel."""
    import chip_smoke as cs
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.crypto import ec_ref
    from fabric_tpu_torch.ops import p256sign
    from fabric_tpu_torch.ops import p256v3 as v3

    src = kernels.CSRC / "p256_sign.cu"
    sig = {"fab_p256_sign": kernels._SIGS["p256_sign"]["fab_p256_sign"]}
    specs = {"tpi8": (src, ["-DFAB_SIGN_TEAM8_LANES=2147483647"], sig),
             "tpi4": (src, ["-DFAB_SIGN_TEAM8_LANES=0"], sig)}
    if parent_csrc is not None:  # one thread a lane: (limbs, B, consts, comb, out, stream)
        P, I = ctypes.c_void_p, ctypes.c_int
        specs["parent"] = (parent_csrc / "p256_sign.cu", [],
                           {"fab_p256_sign": [P, I, P, P, P, P]})
    libs = _build_libs(specs)
    consts, comb = p256sign._kernel_tables(dev)
    rng = np.random.default_rng(cs.SEED + 7)
    for lanes in shapes:
        ks = cs.sign_scalars(lanes, rng)
        limbs = torch.from_numpy(v3._limbs16(ks)).to(dev)
        out = torch.empty((lanes, 2, 8), dtype=torch.int32, device=dev)
        calls = {}
        for tpi in (8, 4):
            fn = libs[f"tpi{tpi}"].fab_p256_sign
            for C in p256sign.CHAINS:
                call = (lambda fn=fn, C=C: _check(fn(
                    limbs.data_ptr(), lanes, C, consts.data_ptr(), comb.data_ptr(),
                    out.data_ptr(), kernels._stream(limbs))))
                call()
                if not torch.equal(out, p256sign.sign_batch_ref(limbs, chains=C)):
                    raise AssertionError(f"p256_sign TPI = {tpi}, C = {C}, {lanes} lanes differs")
                calls[f"tpi{tpi}_c{C}"] = call
        chains = p256sign.sign_chains(lanes)
        calls["wrapper"] = lambda chains=chains: kernels.p256_sign(limbs, consts, comb, chains)
        if "parent" in libs:
            fn = libs["parent"].fab_p256_sign
            calls["parent"] = lambda fn=fn: _check(fn(
                limbs.data_ptr(), lanes, consts.data_ptr(), comb.data_ptr(), out.data_ptr(),
                kernels._stream(limbs)))
            calls["parent"]()
            xz = out.cpu().numpy().view(np.uint32)[:16]
            xs, zs = p256sign._to_ints(xz[:, 0]), p256sign._to_ints(xz[:, 1])
            if any(X * pow(Z, -1, ec_ref.P) % ec_ref.P != ec_ref.pt_mul(k, ec_ref.G)[0]
                   for k, X, Z in zip(ks, xs, zs)):
                raise AssertionError(f"the parent's p256_sign differs at {lanes} lanes")
        log("sign_shapes", lanes=lanes, wrapper_tpi=kernels.p256_sign_tpi(lanes),
            wrapper_chains=chains, **abba(calls, lambda fn: event_ms(fn, 10)))


@contextlib.contextmanager
def capture_mvcc():
    """The operands of the first ``kernels.stage2_mvcc`` call inside the
    block, cloned on the launching stream: [(static_p, (R, W, Q),
    launch_vec, sig_valid, fail_tx, out)]."""
    from fabric_tpu_torch import kernels

    seen, fn = [], kernels.stage2_mvcc

    def wrapped(static_p, R, W, Q, launch_vec, sig_valid, fail_tx, out):
        if not seen:
            seen.append((static_p.clone(), (R, W, Q), launch_vec.clone(), sig_valid.clone(),
                         fail_tx.clone(), out.clone()))
        return fn(static_p, R, W, Q, launch_vec, sig_valid, fail_tx, out)

    kernels.stage2_mvcc = wrapped
    try:
        yield seen
    finally:
        kernels.stage2_mvcc = fn


def policy_ok_of(fail, T: int) -> torch.Tensor:
    """The policy vector (int32 [T + 1], 1 = passes) that a fail list
    (``stage2_policy``'s) stands for: what the fixpoint took before it
    read a fail list."""
    pok = torch.ones(T + 1, dtype=torch.int32, device=fail.device)
    pok[fail[fail >= 0].long()] = 0
    return pok


_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entries of stage2.cu before the one-launch policy stage (``--parent-csrc``):
# a policy launch a group over a filled policy vector, a fixpoint that
# reads that vector; resident_verok's entry is unchanged
PARENT_STAGE2_SIGS = {
    "fab_stage2_policy": [_P, _I, _P, _I, _I, _I, _P, _P, _I, _P, _P],
    "fab_mvcc_bitsets": [_P, _I, _I, _I, _I, _P, _P, _P],
    "fab_mvcc_fixpoint": [_I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P],
}


def mvcc_launches(bitsets, fixpoint, sp, dims, lv, sv, fail, out, parent=False):
    """Over one block's stage-2 operands and C entry points (``kernels``'
    or another build's; ``parent``: the fixpoint before the fail list,
    which takes a policy vector, made here from ``fail``): (bitsets
    alone, fixpoint alone, both as the ``stage2_mvcc`` wrapper runs them,
    its allocation included).  The first two share one direct / phantom
    allocation."""
    from fabric_tpu_torch import kernels

    T = sp.shape[0]
    R, W, Q = dims
    d0, p0 = kernels._bitsets(sp, R, W, Q)

    def bits(d=d0, ph=p0):
        _check(bitsets(sp.data_ptr(), T, R, W, Q, d.data_ptr(), ph.data_ptr(),
                       kernels._stream(sp)))

    bits()  # the words the fixpoint alone reads

    pok = policy_ok_of(fail, T) if parent else None

    def fix(d=d0, ph=p0):
        # the closure holds pok itself: a freed vector's memory is reused
        policy = (pok.data_ptr(),) if parent else (fail.data_ptr(), fail.shape[0])
        _check(fixpoint(T, d.data_ptr(), ph.data_ptr(), None, None, lv.data_ptr(),
                        sv.data_ptr(), sv.shape[0], *policy, out.data_ptr(),
                        kernels._stream(sp)))

    def both():
        d, ph = kernels._bitsets(sp, R, W, Q)
        bits(d, ph)
        fix(d, ph)

    return bits, fix, both


def mvcc_rounds(sp, dims, lv, sv, fail) -> int:
    """The Jacobi rounds of one block's fixpoint (its plain version)."""
    from fabric_tpu_torch.ops import mvcc
    from fabric_tpu_torch.peer import device_block as db

    R, W, Q = dims
    T = sp.shape[0]
    direct, phantom = mvcc._relations(sp[:, :R], sp[:, R:R + W], sp[:, R + W:R + W + Q],
                                      sp[:, R + W + Q:])
    pre = (lv[:, 1] != 0) & db.creator_ok_ref(sv, lv[:, 0]) & (policy_ok_of(fail, T)[:T] != 0)
    return mvcc.jacobi(direct, phantom, (lv[:, 2] != 0) & pre)[1]


def phase_stage2(dev, parent_csrc) -> None:
    """The MVCC kernels alone and as one launch, this tree's and the
    parent's (its fixpoint given the policy vector that the tree's fail
    list stands for), at ``stage2_inputs`` and at the main path's first
    block."""
    import chip_smoke as cs
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.peer import device_block as db

    entries = {"tree": (kernels._entries["fab_mvcc_bitsets"].fn,
                        kernels._entries["fab_mvcc_fixpoint"].fn)}
    if parent_csrc is not None:
        lib = _build_libs({"parent": (parent_csrc / "stage2.cu", [],
                                      PARENT_STAGE2_SIGS)})["parent"]
        entries["parent"] = (lib.fab_mvcc_bitsets, lib.fab_mvcc_fixpoint)

    operands = {}
    sv, lv, groups, sp, dims = cs.stage2_inputs(dev)
    with capture_mvcc() as seen:
        db.stage2(sv, lv, groups, sp, dims)
    operands["stage2_inputs"] = seen[0]
    blocks, _, seed_rows = cs.build_blocks(cs.Net(cs.SEED))
    with capture_mvcc() as seen:
        cs.run_pipeline(blocks, seed_rows, "cuda")
    operands["main_block"] = seen[0]
    torch.cuda.synchronize()

    for name, (sp, dims, lv, sv, fail, out) in operands.items():
        calls, outs = {}, {}
        for tag, (b, f) in entries.items():
            o = out.clone()
            bits, fix, both = mvcc_launches(b, f, sp, dims, lv, sv, fail, o,
                                            parent=tag == "parent")
            both()
            torch.cuda.synchronize()
            outs[tag] = o.clone()
            calls[f"{tag}_bitsets_device_us"] = lambda fn=bits: graph_us(fn)
            calls[f"{tag}_fixpoint_device_us"] = lambda fn=fix: graph_us(fn)
            calls[f"{tag}_wrapper_event_ms"] = lambda fn=both: event_ms(fn)
        want = outs["tree"]
        for tag, o in outs.items():
            if not torch.equal(o, want):
                raise AssertionError(f"stage2 {name}: the {tag} kernels differ from the tree's")
        kernels.stage2_mvcc(sp, *dims, lv, sv, fail, out)
        if not torch.equal(out, want):
            raise AssertionError(f"stage2 {name}: the wrapper differs")
        T = sp.shape[0]
        log("stage2_kernels", operands=name, T=T, dims=list(dims),
            rounds=mvcc_rounds(sp, dims, lv, sv, fail),
            smem=kernels.mvcc_fixpoint_in_smem(T), **abba(calls, lambda m: m()))


def parent_v2_consts(dev) -> torch.Tensor:
    """The one-thread v2 kernel's constant block (int32): the settled bounds,
    R_p, R_n, F_p, F_n, the digits of p and n (its ``__constant__`` part,
    copied by ``fab_p256_v2_tables``), then TG and the digits of b."""
    from fabric_tpu_torch.ops import digits as dg
    from fabric_tpu_torch.ops import p256v2 as v2

    parts = [np.array([v2.SETTLED[v2.P], v2.SETTLED[v2.N]]), v2.MODP.R_np, v2.MODN.R_np,
             v2.MODP.F_np, v2.MODN.F_np, v2.MODP.digits_np, v2.MODN.digits_np, v2._TG,
             dg.int_to_digits(v2.B_COEF)]
    flat = np.concatenate([np.asarray(a, np.int64).reshape(-1) for a in parts])
    return torch.from_numpy(flat.astype(np.int32)).to(dev)


def phase_comparison(dev, shapes, parent_csrc) -> None:
    """``p256_verify_v1`` at each team size alone (builds whose
    FAB_V1_TEAM8_LANES sends every batch to one size) and
    ``p256_verify_v2``, beside the wrapper and the parent's kernel, on
    ``chip_smoke.comparison_items`` at each of ``shapes`` lanes; every
    variant checked against the plain version."""
    import chip_smoke as cs
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.ops import p256, p256v2

    P, I = ctypes.c_void_p, ctypes.c_int
    sig = [P, I, P, P, P]
    specs = {}
    for kernel, src, sizes in (
            ("v1", "p256_v1.cu", {8: "-DFAB_V1_TEAM8_LANES=2147483647",
                                  4: "-DFAB_V1_TEAM8_LANES=0"}),
            ("v2", "p256_v2.cu", {})):
        entry = f"fab_p256_verify_{kernel}"
        for tpi, flag in sizes.items():
            specs[f"{kernel}_tpi{tpi}"] = (kernels.CSRC / src, [flag], {entry: sig})
        if parent_csrc is not None:
            entries = {entry: sig}
            if kernel == "v2":
                entries["fab_p256_v2_tables"] = [P, P]
            specs[f"{kernel}_parent"] = (parent_csrc / src, [], entries)
    libs = _build_libs(specs)
    net = cs.Net(cs.SEED)
    consts = {"v1": p256.kernel_consts(dev), "v2": p256v2.kernel_consts(dev)}
    if parent_csrc is not None:
        pc = parent_v2_consts(dev)
        _check(libs["v2_parent"].fab_p256_v2_tables(pc.data_ptr(), kernels._stream(pc)))
    for kernel, stage, wrap, ref in (
            ("v1", p256.stage_frame, p256.verify_batch_v1, p256.verify_batch_v1_ref),
            ("v2", p256v2.stage_frame, p256v2.verify_batch_v2, p256v2.verify_batch_v2_ref)):
        entry = f"fab_p256_verify_{kernel}"
        for lanes in shapes:
            items, _ = cs.comparison_items(net, max(lanes, cs.VERIFY_LANES))
            if lanes < len(items):  # a mixed sample of the kinds
                pick = np.random.default_rng(cs.SEED + lanes).permutation(len(items))[:lanes]
                items = [items[i] for i in sorted(pick)]
            frame = torch.from_numpy(stage(items, lanes)).to(dev)
            want = ref(frame)
            out = torch.empty(lanes, dtype=torch.bool, device=dev)
            calls = {}
            for tag in (f"{kernel}_tpi8", f"{kernel}_tpi4", f"{kernel}_parent"):
                if tag not in libs:
                    continue
                c = consts[kernel] if tag != "v2_parent" else pc
                fn = getattr(libs[tag], entry)
                call = (lambda fn=fn, c=c: _check(fn(frame.data_ptr(), lanes, c.data_ptr(),
                                                     out.data_ptr(), kernels._stream(frame))))
                call()
                if not torch.equal(out, want):
                    raise AssertionError(f"{kernel} built {tag}, {lanes} lanes: differs")
                calls[tag.split("_", 1)[1]] = call
            calls["wrapper"] = lambda wrap=wrap: wrap(frame)
            if not torch.equal(wrap(frame), want):
                raise AssertionError(f"{kernel} at {lanes} lanes: the wrapper differs")
            log("comparison_kernels", kernel=kernel, lanes=lanes,
                wrapper_tpi=kernels.verify_attrs(f"p256_verify_{kernel}", lanes)["tpi"],
                **abba(calls, lambda fn: event_ms(fn, 3)))


def phase_comparison_path(dev, parent_csrc, n_blocks: int) -> None:
    """The comparison path over ``n_blocks`` blocks under v1 and v2, with
    this tree's verifier and the parent's, in turns parent, tree, tree,
    parent (the parent's v2 reads its own constant block); every run's
    filters equal the construction's.  Beside it, the host ms of each
    kernel's frame staging over ``chip_smoke.VERIFY_LANES`` signatures."""
    import chip_smoke as cs
    from fabric_tpu_torch import carry, kernels
    from fabric_tpu_torch.ops import p256, p256v2
    from fabric_tpu_torch.peer.validator import BlockValidator

    P, I = ctypes.c_void_p, ctypes.c_int
    sig = [P, I, P, P, P]
    libs = _build_libs({
        "v1": (parent_csrc / "p256_v1.cu", [], {"fab_p256_verify_v1": sig}),
        "v2": (parent_csrc / "p256_v2.cu", [], {"fab_p256_verify_v2": sig,
                                                "fab_p256_v2_tables": [P, P]})})
    pc = parent_v2_consts(dev)
    _check(libs["v2"].fab_p256_v2_tables(pc.data_ptr(), kernels._stream(pc)))
    v2_fn = libs["v2"].fab_p256_verify_v2
    parent_fn = {"v1": libs["v1"].fab_p256_verify_v1,
                 "v2": lambda f, B, c, o, s: v2_fn(f, B, pc.data_ptr(), o, s)}
    net = cs.Net(cs.SEED)
    blocks, expected, seed_rows = cs.build_blocks(net, n_blocks, unsafe=False)
    items, _ = cs.comparison_items(net, cs.VERIFY_LANES)
    stages = {"v1": lambda: p256.stage_frame(items, p256.bucket(len(items))),
              "v2": lambda: p256v2.stage_frame(items, p256v2.bucket(len(items)))}
    for kernel in ("v1", "v2"):
        entry = kernels._entries[f"fab_p256_verify_{kernel}"]
        tree_fn = entry.fn
        runs = {"parent": [], "tree": []}
        for tag in ("parent", "tree", "tree", "parent"):
            state, prov, _ = carry.from_reference(seed_rows, cs.NAMESPACES, [])
            v = BlockValidator(prov, state, device="cuda", kernel=kernel)
            entry.fn = parent_fn[kernel] if tag == "parent" else tree_fn
            try:
                res, secs, marks = cs.run_validator(blocks, v, depth=2)
            finally:
                entry.fn = tree_fn
            if [r.tx_filter for r in res] != expected:
                raise AssertionError(f"comparison path {kernel}, {tag}'s kernel: filters differ")
            runs[tag].append({"per_block_ms": 1e3 * secs / len(blocks),
                              "after_first_ms": 1e3 * (marks[-1] - marks[0]) / (len(marks) - 1)})
        stage_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            stages[kernel]()
            stage_ms.append(1e3 * (time.perf_counter() - t0))
        log("comparison_path", kernel=kernel, blocks=len(blocks), depth=2, **runs,
            stage_items=len(items), stage_ms=float(np.median(stage_ms)))


def add_timers(v) -> bool:
    """Give a validator of a package without phase timers
    ``BlockValidator.timings`` and ``_t`` (seconds per phase key, summed
    under a lock), by wrapping the instance's methods where this tree's
    validator reads its clock: ``decode`` and ``_parse`` → host_parse,
    ``verify_launch`` → sig_prepare_launch, ``_device_preprocess`` →
    device_pre, ``_launch_device`` less its ``_stage2.run`` → state_fill,
    ``_stage2.run`` → stage2_dispatch, the ``fetch2`` that it returns →
    device_wait, ``_finish_device`` less that wait → postprocess.  The
    host redo (``_validate_host``) stays untimed: the wire path does not
    take it.  A wrapper's time excludes that of the wrappers it calls
    (per thread).  → False, touching nothing, when the validator's class
    has timers of its own."""
    if hasattr(type(v), "_t"):
        return False
    lock, local = threading.Lock(), threading.local()
    v.timings = None

    def add(key, dt):
        if v.timings is not None:
            with lock:
                v.timings[key] = v.timings.get(key, 0.0) + dt

    def _t(key, t0):
        if v.timings is None:
            return t0
        t1 = time.perf_counter()
        add(key, t1 - t0)
        return t1

    def timed(fn, key, result=lambda out: out):
        def call(*a, **kw):
            outer = getattr(local, "inner", None)
            local.inner = 0.0
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                add(key, dt - local.inner)
                local.inner = None if outer is None else outer + dt
            return result(out)
        return call

    v._t = _t
    for name, key in (("decode", "host_parse"), ("_parse", "host_parse"),
                      ("verify_launch", "sig_prepare_launch"),
                      ("_device_preprocess", "device_pre"), ("_launch_device", "state_fill"),
                      ("_finish_device", "postprocess")):
        setattr(v, name, timed(getattr(v, name), key))
    v._stage2.run = timed(v._stage2.run, "stage2_dispatch",
                          lambda fetch2: timed(fetch2, "device_wait"))
    return True


def _import_from(tree: Path, tag: str):
    """``chip_smoke.py`` of this tree, with ``fabric_tpu_torch`` imported
    from ``tree`` (the process must not have imported it yet) → (the
    module, the package's directory)."""
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import fabric_tpu_torch

    pkg = Path(fabric_tpu_torch.__file__).resolve().parent
    if pkg.parent != tree.resolve():
        raise RuntimeError(f"{tag}: imported fabric_tpu_torch from {pkg}, not from {tree}")
    return cs, pkg


def _build(kernel_names) -> float:
    from fabric_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build(kernel_names)
    if importlib.util.find_spec("fabric_tpu_torch.native") is not None:
        from fabric_tpu_torch import native
        native.build()
    return time.perf_counter() - t0


def sidecar_run(tree: Path, tag: str, n_blocks: int) -> None:
    """One run of ``chip_smoke.py``'s sidecar tenants with
    ``fabric_tpu_torch`` imported from ``tree``: a ``sidecar`` line."""
    cs, pkg = _import_from(tree, tag)
    from fabric_tpu_torch import carry, kernels
    from fabric_tpu_torch.sidecar import SidecarServer
    from fabric_tpu_torch.sidecar.validator import SidecarValidator

    build_s = _build(("p256_verify", "stage2"))
    net = cs.Net(cs.SEED)
    tenants = []
    for name, weight in cs.SIDECAR_TENANTS:
        blocks, expected, seed_rows = cs.build_blocks(net, n_blocks, unsafe=False)
        state, prov, _ = carry.from_reference(seed_rows, cs.NAMESPACES, [])
        tenants.append((name, weight, blocks, expected, state, prov))
    srv = SidecarServer("127.0.0.1", 0, coalesce=4, queue_blocks=8).start_background()
    out, errors, timings = {}, [], {}
    try:
        validators = {name: SidecarValidator(prov, state, device="cuda", tenant=name,
                                             sidecar_weight=weight,
                                             sidecar_endpoint=f"127.0.0.1:{srv.port}")
                      for name, weight, _, _, state, prov in tenants}
        patched = any([add_timers(v) for v in validators.values()])

        def drive(name, blocks):
            try:
                timings[name] = {}
                out[name] = cs.run_validator(blocks, validators[name], depth=2,
                                             timings=timings[name])
            except BaseException as e:  # re-raised below, on the main thread
                errors.append(e)

        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=drive, args=(name, blocks))
                   for name, _, blocks, _, _, _ in tenants]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = srv.stats()
        for v in validators.values():
            v.close()
    finally:
        srv.stop_background()
    if errors:
        raise errors[0]
    for name, _, _, expected, _, _ in tenants:
        if [r.tx_filter for r in out[name][0]] != expected:
            raise AssertionError(f"sidecar tenant {name}, {tag}: filters differ from "
                                 "construction")
    n_tx = {name: sum(len(b.txs) for b in blocks) for name, _, blocks, _, _, _ in tenants}
    n_all = len(tenants) * n_blocks
    phase = {}
    for t in timings.values():
        for key, sec in t.items():
            phase[key] = phase.get(key, 0.0) + 1e3 * sec / n_all
    log("sidecar", tree=tag, package=str(pkg), timers_added=patched, build_s=build_s,
        blocks_per_tenant=n_blocks, seconds=wall, tx_per_s_all=sum(n_tx.values()) / wall,
        tx_per_s={n: n_tx[n] / out[n][1] for n in out}, dispatches=st["dispatches"],
        coalesce_requests=st["coalesce"]["requests"], p256_verify_launches=kernels.launches[
            "p256_verify"], phase_ms_per_block=dict(sorted(phase.items())))


def config5_run(tree: Path, tag: str, corpus: Path) -> None:
    """One run of the config 5 blocks in ``corpus`` (pickled bytes) with
    ``fabric_tpu_torch`` imported from ``tree``: a ``config5_path`` line."""
    cs, pkg = _import_from(tree, tag)
    from fabric_tpu_torch.crypto import idemix
    from fabric_tpu_torch.protos import messages as m

    build_s = _build(("p256_verify", "stage2"))
    data = pickle.loads(corpus.read_bytes())
    genesis = m.Block.parse(data["genesis"])
    wire = [m.Block.parse(b) for b in data["blocks"]]
    dev = torch.device("cuda")
    v = cs.channel_validator(dev, cs.CONFIG5_CHANNEL, genesis, data["rows"], cs.CONFIG5_NS)
    patched = add_timers(v)
    proofs = {"n": 0, "seconds": 0.0}
    orig = idemix.IdemixMSP.verify

    def verify(self, *a):
        t1 = time.perf_counter()
        try:
            return orig(self, *a)
        finally:
            proofs["seconds"] += time.perf_counter() - t1
            proofs["n"] += 1

    idemix.IdemixMSP.verify = verify
    first_t, rest_t = {}, {}
    res, first_s, _, _, _ = cs.run_channel(v, wire[:1], dev, first_t)
    rest, secs, _, pipe, _ = cs.run_channel(v, wire[1:], dev, rest_t)
    if [list(r.tx_filter) for r in res + rest] != data["expected"]:
        raise AssertionError(f"config5 path, {tag}: filters differ from construction")
    k = len(wire) - 1
    log("config5_path", tree=tag, package=str(pkg), timers_added=patched, build_s=build_s,
        blocks=len(wire), first_block_ms=1e3 * first_s, per_block_ms=1e3 * secs / k,
        tx_per_s=sum(len(b.data.data) for b in wire[1:]) / secs,
        phase_ms_per_block={key: 1e3 * t / k for key, t in sorted(rest_t.items())},
        idemix_verifies=proofs["n"],
        idemix_verify_ms_per_presentation=1e3 * proofs["seconds"] / max(proofs["n"], 1),
        stale_reprocessed=pipe.stale_prefetches)


def ledger_run(tree: Path, tag: str, corpus: Path) -> None:
    """One catch-up run of the ledger chain in ``corpus`` (pickled
    bytes) with ``fabric_tpu_torch`` imported from ``tree``: a
    ``ledger_path`` line."""
    import shutil

    cs, pkg = _import_from(tree, tag)
    from fabric_tpu_torch.crypto import msp
    from fabric_tpu_torch.peer.replay import replay_into

    build_s = _build(("p256_verify", "stage2"))
    data = pickle.loads(corpus.read_bytes())
    built = {**data, "msp": msp.MSPManager({mid: msp.MSP(mid, root_certs=[pem], node_ous=True)
                                            for mid, pem in data["roots"]})}
    dev = torch.device("cuda")
    root = tempfile.mkdtemp(prefix="fabtorch-ledger-")
    try:
        src = cs._seeded_ledger(os.path.join(root, "source"), data["rows"], async_commit=True)
        res = cs._commit_blocks(cs._ledger_validator(dev, src, built), src, data["raw"])
        if [list(r.tx_filter) for r in res] != data["expected"]:
            raise AssertionError(f"ledger path, {tag}: filters differ from construction")
        want = cs._ledger_view(src)
        dst = cs._seeded_ledger(os.path.join(root, "replay"), data["rows"], async_commit=True)
        v = cs._ledger_validator(dev, dst, built)
        patched = add_timers(v)
        v.timings = {}
        torch.cuda.synchronize()
        stats = replay_into(dst, v, src.blocks, depth=2)
        torch.cuda.synchronize()
        cs._same_ledger(f"turn {tag}", cs._ledger_view(dst), want)
        n, first_s = stats["blocks"], stats["first_commit_s"]
        phase = {**v.timings, **dst.commit_seconds}
        log("ledger_path", tree=tag, package=str(pkg), timers_added=patched, build_s=build_s,
            blocks=n, first_block_ms=1e3 * first_s,
            per_block_ms=1e3 * (stats["seconds"] - first_s) / (n - 1),
            tx_per_s=data["n_tx"] / stats["seconds"],
            phase_ms_per_block={k: 1e3 * t / n for k, t in sorted(phase.items())},
            fsyncs=dst.blocks.stats()["fsyncs"])
        dst.close()
        src.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def wire_path_run(tree: Path, tag: str, n_blocks: int, modes=("single",)) -> None:
    """Runs of a path with ``fabric_tpu_torch`` imported from ``tree``
    (the process must not have imported it yet), one line a mode, in the
    order given: ``single`` (wire blocks, ``submit`` a block, the default
    knobs), ``coalesced`` (wire blocks, ``submit_many`` with
    ``coalesce_blocks=4`` over ``BlockValidator(host_stage_workers=-1)``:
    the first block, then the others in groups of 4), ``decoded`` (the
    main path's ``DecodedBlock``s, ``submit`` a block, a ``main_path``
    line)."""
    cs, pkg = _import_from(tree, tag)
    from fabric_tpu_torch import carry, kernels
    from fabric_tpu_torch.peer import frontend
    from fabric_tpu_torch.peer.validator import BlockValidator
    from fabric_tpu_torch.protos import messages as m

    build_s = _build(("p256_verify", "stage2", "p256_sign"))
    made = {}

    def inputs(decoded: bool):
        """(blocks, expected filters, seed rows, namespaces, msp, front
        end ms a block), made once a kind."""
        if decoded not in made:
            if decoded:
                blocks, expected, seed_rows = cs.build_blocks(cs.Net(cs.SEED), 1 + n_blocks,
                                                              unsafe=False)
                made[True] = (blocks, expected, seed_rows, cs.NAMESPACES, None, None)
            else:
                wn = cs.WireNet(cs.SEED + 9)
                blocks, expected, seed_rows, _ = cs.build_wire_blocks(wn, 1 + n_blocks)
                wire = [m.Block.parse(b.serialize()) for b in blocks]
                decode_ms = []
                for blk in wire[1:]:
                    t1 = time.perf_counter()
                    frontend.decode_block(blk, wn.msp)
                    decode_ms.append(1e3 * (time.perf_counter() - t1))
                made[False] = (wire, expected, seed_rows, cs.WIRE_NAMESPACES, wn.msp,
                               float(np.mean(decode_ms)))
        return made[decoded]

    for mode in modes:
        wire, expected, seed_rows, namespaces, msp, decode_ms = inputs(mode == "decoded")
        state, prov, _ = carry.from_reference(seed_rows, namespaces, [])
        kw, coalesce = ({"host_stage_workers": -1}, cs.COALESCE) if mode == "coalesced" \
            else ({}, 0)
        v = BlockValidator(prov, state, device=torch.device("cuda"), msp=msp, **kw)
        patched = add_timers(v)
        first_t, rest_t = {}, {}
        before = kernels.launches["p256_verify"]
        res, first_s, _ = cs.run_validator(wire[:1], v, depth=2, timings=first_t,
                                           coalesce=coalesce)
        rest, secs, _ = cs.run_validator(wire[1:], v, depth=2, timings=rest_t,
                                         coalesce=coalesce)
        if [r.tx_filter for r in res + rest] != expected:
            raise AssertionError(f"{mode} path, {tag}: filters differ from construction")
        pool = getattr(v, "host_pool", None)
        log("main_path" if mode == "decoded" else "wire_path", tree=tag, mode=mode,
            package=str(pkg), timers_added=patched, build_s=build_s, blocks=len(wire), first_block_ms=1e3 * first_s,
            after_first_blocks=n_blocks, per_block_ms=1e3 * secs / n_blocks,
            phase_ms_per_block={k: 1e3 * t / n_blocks for k, t in sorted(rest_t.items())},
            first_block_phase_ms={k: 1e3 * t for k, t in sorted(first_t.items())},
            decode_ms_per_block=decode_ms,
            p256_verify_launches=kernels.launches["p256_verify"] - before,
            pool_workers=pool.workers if pool is not None else 0,
            front_end_envelopes=[getattr(r.pend.block, "n_front_end", None) for r in rest])
        if pool is not None:
            v.close()


_TURNS = {  # mode → (the run's phase name, the numbers its turns report)
    "single": ("wire_path", ("per_block_ms",)),
    "decoded": ("main_path", ("per_block_ms",)),
    "sidecar": ("sidecar", ("tx_per_s_all", "dispatches")),
    "config5": ("config5_path", ("per_block_ms", "tx_per_s",
                                 "idemix_verify_ms_per_presentation")),
    "ledger": ("ledger_path", ("per_block_ms", "first_block_ms", "tx_per_s")),
}


def phase_turns(parent_tree: Path, n_blocks: int, mode: str) -> None:
    """One path's runs (``wire_path_run`` for ``single``, the wire path,
    and ``decoded``, the main path; ``sidecar_run``; ``config5_run``) in
    turns parent, tree, tree, parent, each in a process of its own; then
    each tree's numbers by turn and its ``device_pre`` ms a block."""
    name, keys = _TURNS[mode]
    extra, tmp = [], None
    if mode == "config5":  # the blocks are built once, here
        sys.path.insert(0, str(ROOT))
        import chip_smoke as cs

        t0 = time.perf_counter()
        built = cs.build_config5()
        tmp = tempfile.NamedTemporaryFile(suffix=".pickle", delete=False)
        tmp.write(pickle.dumps({"genesis": built["genesis"].serialize(),
                                "blocks": [b.serialize() for b in built["blocks"]],
                                "rows": built["rows"],
                                "expected": [[int(c) for c in e] for e in built["expected"]]}))
        tmp.close()
        extra = ["--corpus", tmp.name]
        log("config5_build", seconds=time.perf_counter() - t0, blocks=len(built["blocks"]))
    if mode == "ledger":  # the chain is built once, here
        sys.path.insert(0, str(ROOT))
        import chip_smoke as cs

        t0 = time.perf_counter()
        built = cs.build_ledger()
        tmp = tempfile.NamedTemporaryFile(suffix=".pickle", delete=False)
        tmp.write(pickle.dumps({"raw": built["raw"], "rows": built["rows"],
                                "roots": built["roots"], "n_tx": built["n_tx"],
                                "expected": [[int(c) for c in e] for e in built["expected"]]}))
        tmp.close()
        extra = ["--corpus", tmp.name]
        log("ledger_build", seconds=time.perf_counter() - t0, blocks=len(built["raw"]))
    runs: dict = {"parent": [], "tree": []}
    try:
        for tag in ("parent", "tree", "tree", "parent"):
            tree = parent_tree.resolve() if tag == "parent" else ROOT
            out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--wire-tree",
                                  str(tree), "--wire-tag", tag, "--wire-modes", mode,
                                  "--path-blocks", str(n_blocks), *extra],
                                 cwd=ROOT, capture_output=True, text=True)
            sys.stderr.write(out.stderr[-4000:])
            if out.returncode:
                raise RuntimeError(f"{name}, {tag}: exit {out.returncode}")
            line = out.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs[tag].append(json.loads(line))
    finally:
        if tmp is not None:
            Path(tmp.name).unlink()
    log(f"{name}_turns", order=["parent", "tree", "tree", "parent"], **{
        tag: {**{k: [r[k] for r in rs] for k in keys},
              f"median_{keys[0]}": float(np.median([r[keys[0]] for r in rs])),
              "device_pre_ms_per_block": [r["phase_ms_per_block"].get("device_pre")
                                          for r in rs]}
        for tag, rs in runs.items()})


def phase_coalesced_path(parent_tree: Path, n_blocks: int) -> None:
    """The parent's and this tree's single-block and coalesced wire
    paths (``wire_path_run``), in turns parent, tree, tree, parent, each
    turn a process of its own (a turn's two modes in one process, their
    order reversed in a package's second turn); then each variant's wall
    ms a block."""
    turns = (("parent", ("single", "coalesced")), ("tree", ("single", "coalesced")),
             ("tree", ("coalesced", "single")), ("parent", ("coalesced", "single")))
    runs: dict = {}
    for tag, modes in turns:
        tree = parent_tree.resolve() if tag == "parent" else ROOT
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--wire-tree",
                              str(tree), "--wire-tag", tag, "--wire-modes", ",".join(modes),
                              "--path-blocks", str(n_blocks)],
                             cwd=ROOT, capture_output=True, text=True)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode:
            raise RuntimeError(f"coalesced path, {tag}: exit {out.returncode}")
        lines = [ln for ln in out.stdout.strip().splitlines() if '"wire_path"' in ln]
        for line in lines:
            print(line, flush=True)
            rec = json.loads(line)
            runs.setdefault(f"{tag}_{rec.get('mode', 'single')}", []).append(
                rec["per_block_ms"])
    log("coalesced_path_turns",
        order=[f"{tag}:{'+'.join(modes)}" for tag, modes in turns],
        **{k: {"per_block_ms": ms, "median_per_block_ms": float(np.median(ms))}
           for k, ms in runs.items()})


def main() -> int:
    if not torch.cuda.is_available():
        print("launch_steps: needs a CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", type=Path, default=None,
                    help="an older csrc directory whose kernels run beside this tree's")
    ap.add_argument("--parent-tree", type=Path, default=None,
                    help="an older checkout whose package runs the wire path beside this one")
    ap.add_argument("--phase", default="all",
                    choices=("all", "team_sizes", "sign_shapes", "stage2", "scatter", "small",
                             "comparison", "comparison_path", "main_path", "wire_path",
                             "coalesced_path", "sidecar", "config5_path", "ledger_path",
                             "sha256"))
    ap.add_argument("--team-lanes", default="3072,6144,12288")
    ap.add_argument("--sign-lanes", default="16,32,64,128,256,512,1024,4096")
    ap.add_argument("--comparison-lanes", default="16,4096,12288")
    ap.add_argument("--path-blocks", type=int, default=12)
    ap.add_argument("--wire-tree", type=Path, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--wire-tag", default="tree", help=argparse.SUPPRESS)
    ap.add_argument("--wire-modes", default="single", help=argparse.SUPPRESS)
    ap.add_argument("--corpus", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.wire_tree is not None:  # one run of a turn of a path phase
        if args.wire_modes == "sidecar":
            sidecar_run(args.wire_tree, args.wire_tag, args.path_blocks)
        elif args.wire_modes == "config5":
            config5_run(args.wire_tree, args.wire_tag, args.corpus)
        elif args.wire_modes == "ledger":
            ledger_run(args.wire_tree, args.wire_tag, args.corpus)
        else:
            wire_path_run(args.wire_tree, args.wire_tag, args.path_blocks,
                          args.wire_modes.split(","))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log("device", nvidia_smi=smi, torch=torch.__version__)
    if args.phase in ("main_path", "wire_path", "coalesced_path", "sidecar", "config5_path",
                      "ledger_path"):
        if args.parent_tree is None:
            ap.error(f"--phase {args.phase} needs --parent-tree")
        if args.phase == "coalesced_path":
            phase_coalesced_path(args.parent_tree, args.path_blocks)
        else:
            phase_turns(args.parent_tree, args.path_blocks, {
                "main_path": "decoded", "wire_path": "single", "sidecar": "sidecar",
                "config5_path": "config5", "ledger_path": "ledger"}[args.phase])
        return 0
    sys.path.insert(0, str(ROOT))
    from fabric_tpu_torch import kernels

    kernels.build(("sha256",) if args.phase == "sha256" else
                  ("resident", "stage2", "p256_verify", "p256_sign", "p256_v1", "p256_v2"))
    dev = torch.device("cuda")
    run = lambda phase: args.phase in ("all", phase)
    if run("team_sizes"):
        phase_team_sizes(dev, [int(x) for x in args.team_lanes.split(",")])
    if run("sign_shapes"):
        phase_sign_shapes(dev, [int(x) for x in args.sign_lanes.split(",")], args.parent_csrc)
    if run("stage2"):
        phase_stage2(dev, args.parent_csrc)
    if run("scatter"):
        parent = None
        if args.parent_csrc:
            parent = _build_libs({"parent": (args.parent_csrc / "resident.cu", [],
                                             "fab_table_scatter")})["parent"]
        phase_scatter(dev, parent)
    if run("small"):
        phase_small_kernels(dev, args.parent_csrc)
    if run("sha256"):
        phase_sha256(dev, args.parent_csrc)
    if run("comparison"):
        phase_comparison(dev, [int(x) for x in args.comparison_lanes.split(",")],
                         args.parent_csrc)
    if run("comparison_path") and args.parent_csrc is not None:
        phase_comparison_path(dev, args.parent_csrc, args.path_blocks)
    if run("main_path") and args.parent_tree is not None:
        phase_turns(args.parent_tree, args.path_blocks, "decoded")
    if run("wire_path") and args.parent_tree is not None:
        phase_turns(args.parent_tree, args.path_blocks, "single")
    if run("coalesced_path") and args.parent_tree is not None:
        phase_coalesced_path(args.parent_tree, args.path_blocks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
