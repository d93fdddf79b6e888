"""Fused block stage 2: endorsement-policy reduction + MVCC on the
verify batch's device-resident output (counterpart:
``fabric_tpu/peer/device_block.py``).

Per block the signature bits never leave the device: the creator gather,
the policy reduction of every policy group (counts of principal
matches against leaf ranks, the n-of gate walk, the consumption-safety
bit, a min-fold into each transaction), pre_ok = structural & creator &
policy, the MVCC conflict relations and validity fixpoint, and one
packed int8 vector comes back:

    [0:T] valid | [T:2T] conflict | [2T:3T] phantom | [3T:4T] creator_ok
    | [4T:5T] policy_ok | [5T:5T+n_sig] sig_valid | per group [Eb] safe

Operands keep the reference's packing: ``launch_vec [T, 3]`` int32
(creator_idx | structural | ver_ok; creator sentinels -1 → False,
-2 → True), one ``[Eb, S*P + S + 1]`` int32 frame per group
(match | endo_idx | tx_of) and ``static_packed [T, R + W + 2Q]``.
The validator lays a block's frames one after another in one buffer,
copied to the device once (``frames``).  The reference compiles one
program per set of policy plans; here the gate trees go to the kernel
as data: ``policy_table`` packs the group table and the plans
(``plan_vector``) into one int32 tensor, built once per set of plans
and shapes, so nothing is built per plan.  ``stage2`` is the wrapper:
CPU tensors run ``stage2_ref``, CUDA tensors launch ``stage2_policy``
once for every group together and ``stage2_mvcc`` (two launches) from
``kernels/csrc/stage2.cu``; the policy kernel names each failing
entry's transaction and the fixpoint folds those into the policy set,
so no policy vector is filled or min-folded in device memory.

With device-resident state (``state/residency.py``) the ver_ok column is
not filled on the host: ``resident_ver_ok`` computes it on the device
from the resident version table and the block's unique-key pack
(``u_pack [Ub, 4]``: slot | present | vb | vt, slot -1 = host lane) and
writes it into the launch vector before stage 2 reads it — the
reference's ``resident_dims`` variant of ``build_stage2``.  CPU tensors
run ``resident_ver_ok_ref``, CUDA tensors launch ``resident_verok``
(``kernels/csrc/resident.cu``).  It runs under the residency manager's
lock on the manager's stream, before the block's own admissions can
reuse a slot it reads (``state.build_launch_pack``).

Telemetry (the reference's :212-355): each ``run`` opens a ``stage2``
record on the launch ledger (``observe/ledger.py``), its cache verdict
the policy-table cache's (and, on the card, the first launch of the
stage-2 kernels in the process), completes the verify handle's record
enqueue-only (the fused path never fetches it), pins the operands and
the output on the ledger's ``launch_frames`` and ``outputs`` owners,
and brackets the fetch's copy to the host.  The two launches run inside
the ``fabtpu.stage2_dispatch`` annotation; ``device_stage2_dispatch_seconds``
and ``device_stage2_programs`` (the cache's size) go to the registry.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from fabric_tpu_torch import kernels
from fabric_tpu_torch.observe import device_annotation
from fabric_tpu_torch.observe import ledger as _ledger
from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.ops import mvcc as mvcc_ops

MAX_PRINCIPALS = 32   # the kernel's per-policy principal columns (32-bit masks)
MAX_SLOTS = 64        # the kernel's leaves + gates per policy
CTA_COLS = 8          # a CTA's row of the policy table


def plan_vector(plan: pol.BatchPlan) -> list[int]:
    """The gate tree as int32 data: L | G | leaf-column mask | 0 |
    leaf_principal[L] | leaf_rank[L] | gate_n[G] | gate_off[G+1] | children."""
    L, G = plan.n_leaves, len(plan.gates)
    if len(plan.principals) > MAX_PRINCIPALS or L + G > MAX_SLOTS:
        raise ValueError(
            f"policy has {len(plan.principals)} principals and {L + G} leaves+gates; "
            f"the stage-2 kernel takes at most {MAX_PRINCIPALS} and {MAX_SLOTS}")
    mask = 0
    for c in set(plan.leaf_principal):
        mask |= 1 << c
    if mask >= 1 << 31:
        mask -= 1 << 32  # int32 bit pattern
    offs, children = [0], []
    for _, ch in plan.gates:
        children += list(ch)
        offs.append(len(children))
    vec = ([L, G, mask, 0] + list(plan.leaf_principal) + list(plan.leaf_rank)
           + [n for n, _ in plan.gates] + offs + children)
    if len(vec) > kernels.POLICY_PLAN_WORDS:
        raise ValueError(f"policy plan of {len(vec)} words; the stage-2 kernel stages at most "
                         f"{kernels.POLICY_PLAN_WORDS}")
    return vec


@dataclass(frozen=True)
class PolicyTable:
    """One launch of ``stage2_policy`` over a set of groups: ``meta``
    (int32: a row of ``CTA_COLS`` a CTA — the frame offset of its first
    row, its entries, S, P, its plan's offset and words, its first
    entry, 0 — then the plans), its CTAs, the shared bytes of a CTA's
    staged rows and the groups' entries in all."""

    meta: torch.Tensor
    n_cta: int
    smem: int
    n_entries: int


def policy_meta(shapes) -> tuple[np.ndarray, int, int, int]:
    """``shapes``: [(plan, Eb, S)] in frame order → (meta, n_cta, smem
    bytes, entries) of ``PolicyTable``.  A CTA takes up to
    ``POLICY_ENTRIES`` consecutive entries of one group, as many as fit
    its ``POLICY_ROW_BYTES`` of staged rows."""
    plans = [plan_vector(plan) for plan, _, _ in shapes]
    ctas = []  # [frame offset, entries, S, P, group, first entry]
    frame_off = ent_off = smem = 0
    for g, (plan, Eb, S) in enumerate(shapes):
        P = len(plan.principals)
        rw = S * P + S + 1
        epc = min(kernels.POLICY_ENTRIES, kernels.POLICY_ROW_BYTES // (4 * rw))
        if epc == 0:
            raise ValueError(f"a policy group row of {rw} words exceeds the stage-2 kernel's "
                             f"{kernels.POLICY_ROW_BYTES} bytes of staged rows")
        for e0 in range(0, Eb, epc):
            n = min(epc, Eb - e0)
            ctas.append((frame_off + e0 * rw, n, S, P, g, ent_off + e0))
            smem = max(smem, 4 * rw * n)
        frame_off += Eb * rw
        ent_off += Eb
    if frame_off >= 1 << 31:
        raise ValueError("the block's policy frames exceed 2^31 words")
    plan_off = [CTA_COLS * len(ctas)]
    for v in plans:
        plan_off.append(plan_off[-1] + len(v))
    rows = [(fo, n, S, P, plan_off[g], len(plans[g]), e, 0) for fo, n, S, P, g, e in ctas]
    meta = np.array([x for r in rows for x in r] + [x for v in plans for x in v], np.int32)
    return meta, len(ctas), smem, ent_off


def policy_table(shapes, dev) -> PolicyTable:
    """``policy_meta`` with its table on ``dev``."""
    meta, n_cta, smem, n = policy_meta(shapes)
    return PolicyTable(torch.from_numpy(meta).to(dev), n_cta, smem, n)


def group_frames(groups) -> torch.Tensor:
    """The groups' frames one after another, as one int32 tensor (a copy:
    the validator builds them in one buffer and passes it to ``stage2``)."""
    gps = [g[1].reshape(-1) for g in groups]
    if not gps:
        return torch.empty(0, dtype=torch.int32)
    return torch.cat(gps)


def _sig_gather(sig_valid: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """sig_valid[idx] where 0 <= idx < n_sig, else False."""
    n = sig_valid.shape[0]
    inr = (idx >= 0) & (idx < n)
    if n == 0:
        return torch.zeros_like(inr)
    return sig_valid[idx.clamp(0, n - 1)] & inr


def creator_ok_ref(sig_valid: torch.Tensor, creator_idx: torch.Tensor) -> torch.Tensor:
    """The creator gather: sig_valid[idx], sentinel -2 → True, -1 → False."""
    idx = creator_idx.long()
    return torch.where(idx == -2, True, _sig_gather(sig_valid, idx))


def policy_reduce_ref(sig_valid, gp, S: int, P: int, plan: pol.BatchPlan):
    """Plain ``stage2_policy`` for one group → (ok [Eb], safe [Eb]) bool
    (the reference's ``_policy_reduce``)."""
    Eb = gp.shape[0]
    match = (gp[:, :S * P] != 0).reshape(Eb, S, P)
    ev = _sig_gather(sig_valid, gp[:, S * P:S * P + S].long())
    M = match & ev[:, :, None]
    counts = M.sum(dim=1)
    cols = sorted(set(plan.leaf_principal))
    safe = (M[:, :, cols].sum(dim=2) <= 1).all(dim=1)
    dev = gp.device
    leaf_p = torch.tensor(plan.leaf_principal, dtype=torch.long, device=dev)
    ranks = torch.tensor(plan.leaf_rank, dtype=torch.long, device=dev)
    vals = list((ranks[None, :] < counts[:, leaf_p]).T)
    for n, children in plan.gates:
        acc = torch.zeros(Eb, dtype=torch.long, device=dev)
        for c in children:
            acc = acc + vals[c].long()
        vals.append(acc >= n)
    return vals[-1], safe


def stage2_ref(sig_valid, launch_vec, groups, static_p, dims) -> torch.Tensor:
    """Plain version of the fused stage 2 → packed int8 (module docstring).
    ``groups``: [(plan, gp [Eb, S*P+S+1] int32, Eb, S)]."""
    T = launch_vec.shape[0]
    creator_ok = creator_ok_ref(sig_valid, launch_vec[:, 0])
    policy_ok = torch.ones(T + 1, dtype=torch.int32, device=launch_vec.device)
    safes = []
    for plan, gp, _, S in groups:
        ok, safe = policy_reduce_ref(sig_valid, gp, S, len(plan.principals), plan)
        tx_of = gp[:, -1].long()
        live = (tx_of >= 0) & (tx_of < T)
        policy_ok.scatter_reduce_(0, torch.where(live, tx_of, T),
                                  torch.where(live, ok, True).to(torch.int32), reduce="amin")
        safes.append(safe)
    policy_ok = policy_ok[:T] != 0
    pre_ok = (launch_vec[:, 1] != 0) & creator_ok & policy_ok
    R, W, Q = dims
    valid, conflict, phantom = mvcc_ops.mvcc_validate_hostver_ref(
        static_p[:, :R], launch_vec[:, 2] != 0, static_p[:, R:R + W],
        static_p[:, R + W:R + W + Q], static_p[:, R + W + Q:], pre_ok)
    parts = [valid, conflict, phantom, creator_ok, policy_ok, sig_valid, *safes]
    return torch.cat([p.to(torch.int8) for p in parts])


def resident_ver_ok_ref(static_p, table, u_pack, read_pv, R: int) -> torch.Tensor:
    """Plain ``resident_verok`` → [T] bool: the reference's
    ``_resident_ver_ok``, gather for gather.  Read key ids index
    ``u_pack``; slot >= 0 gathers the table row, slot < 0 takes the
    pack's host lane; ids past the pack read an absent row and slots
    past the table clamp to its last row, as jax's gathers do."""
    Ub, cap = u_pack.shape[0], table.shape[0]
    slot = u_pack[:, 0].long()
    trow = table[torch.where(slot >= 0, slot, 0).clamp(max=cap - 1)]
    urow = torch.where((slot < 0)[:, None], u_pack[:, 1:4], trow)
    up = torch.cat([urow[:, 0] != 0, urow.new_zeros(1, dtype=torch.bool)])
    uv = torch.cat([urow[:, 1:3], urow.new_zeros((1, 2))])
    rk = static_p[:, :R].long()
    idx = torch.where(rk >= 0, rk, Ub).clamp(max=Ub)
    cp, cv = up[idx], uv[idx]
    rp = read_pv[:, :, 0] != 0
    ver_eq = (read_pv[:, :, 1:3] == cv).all(dim=-1)
    okr = torch.where(rp & cp, ver_eq, rp == cp)
    return (okr | (rk < 0)).all(dim=-1)


def resident_ver_ok(static_p, table, u_pack, read_pv, R: int, launch_vec) -> None:
    """The committed-version check against the resident table, written
    into column 2 of ``launch_vec`` (int32 [T, 3]).  CPU tensors run
    ``resident_ver_ok_ref``; CUDA tensors launch ``resident_verok``."""
    if table.device.type == "cpu":
        launch_vec[:, 2] = resident_ver_ok_ref(static_p, table, u_pack, read_pv, R).to(
            launch_vec.dtype)
        return
    kernels.resident_verok(static_p, R, table, u_pack, read_pv, launch_vec)


def stage2(sig_valid, launch_vec, groups, static_p, dims, table=None,
           frames=None) -> torch.Tensor:
    """The fused stage 2 → packed int8.  CUDA only: ``table``, the
    groups' ``PolicyTable`` (built here when None); ``frames``, their
    frames in one int32 tensor (``group_frames`` when None)."""
    if sig_valid.device.type == "cpu":
        return stage2_ref(sig_valid, launch_vec, groups, static_p, dims)
    dev = sig_valid.device
    T, n_sig = launch_vec.shape[0], sig_valid.shape[0]
    if table is None:
        table = policy_table([(g[0], g[2], g[3]) for g in groups], dev)
    if frames is None:
        frames = group_frames(groups).to(dev)
    out = torch.empty(5 * T + n_sig + table.n_entries, dtype=torch.int8, device=dev)
    fail_tx = torch.empty(table.n_entries, dtype=torch.int32, device=dev)
    if table.n_cta:
        kernels.stage2_policy(sig_valid, frames, table.meta, table.n_cta, table.smem, T,
                              out[5 * T + n_sig:], fail_tx)
    R, W, Q = dims
    kernels.stage2_mvcc(static_p, R, W, Q, launch_vec, sig_valid, fail_tx, out)
    return out


class DeviceBlockPipeline:
    """Runs the fused stage 2 of one block on the verify handle's
    device and returns a fetch for the unpacked result.  Policy tables
    are built once per set of plans and shapes and device (the cache
    holds the key alone on the CPU, where no table is built)."""

    MAX_TABLES = 256

    def __init__(self):
        # ((id(plan), Eb, S) a group, device) → (plans, PolicyTable or
        # None); the plans are held, so their ids stay theirs
        self._tables: dict = {}
        from fabric_tpu_torch.ops_metrics import global_registry

        reg = global_registry()
        self._dispatch_hist = reg.histogram(
            "device_stage2_dispatch_seconds",
            "host-side fused stage-2 dispatch time (s)",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, float("inf")),
        )
        self._cache_gauge = reg.gauge(
            "device_stage2_programs", "compiled stage-2 program cache size"
        )

    @staticmethod
    def _table_key(groups, dev):
        return (tuple((id(g[0]), g[2], g[3]) for g in groups), dev)

    def _policy_table(self, groups, dev) -> PolicyTable | None:
        key = self._table_key(groups, dev)
        hit = self._tables.get(key)
        if hit is None:
            if len(self._tables) >= self.MAX_TABLES:
                self._tables.clear()
            table = (policy_table([(g[0], g[2], g[3]) for g in groups], dev)
                     if dev.type == "cuda" else None)
            hit = self._tables[key] = ([g[0] for g in groups], table)
            self._cache_gauge.set(len(self._tables))
        return hit[1]

    def run(self, handle, launch_vec: torch.Tensor, groups, static_packed, static_dims,
            t_bucket: int, frames=None):
        """handle: ``ops.p256v3.VerifyHandle``; launch_vec [T, 3] int32
        tensor on the handle's device (its ver_ok column filled on the
        host or by ``resident_ver_ok``); groups [(plan, gp tensor, Eb,
        S)]; frames: their frames in one int32 tensor (``stage2``);
        static_packed [T, R+W+2Q] int32 tensor.  → zero-arg fetch of a
        dict of numpy arrays (valid, conflict, phantom, creator_ok,
        policy_ok, sig_valid, safe: [per-group arrays])."""
        sv = handle.device_out
        dev = sv.device
        compiled = self._table_key(groups, dev) not in self._tables
        if dev.type == "cuda":
            compiled = compiled or kernels.first_launch("stage2_mvcc")
        rec = _ledger.launch("stage2", compiled=compiled, lanes=t_bucket,
                             h2d_bytes=launch_vec.nbytes)
        # the fused path never fetches the verify handle: its record
        # completes enqueue-only, and this record's sync owns the chain
        vrec = getattr(handle, "rec", None)
        if vrec is not None:
            vrec.complete()
        t0 = time.perf_counter()
        table = self._policy_table(groups, dev)
        if rec is not None:
            ops = [sv, launch_vec, static_packed]
            ops += [frames] if frames is not None else [g[1] for g in groups]
            if table is not None:
                ops.append(table.meta)
            rec.pin_hbm("launch_frames", sum(int(t.nbytes) for t in ops))
        with device_annotation("fabtpu.stage2_dispatch"):
            packed = stage2(sv, launch_vec, groups, static_packed, static_dims, table, frames)
        if rec is not None:
            rec.dispatched()
            rec.pin_hbm("outputs", int(packed.nbytes))
        self._dispatch_hist.observe(time.perf_counter() - t0)
        n_sig = int(sv.shape[0])
        e_sizes = [g[2] for g in groups]

        def fetch():
            if rec is not None:
                rec.sync_begin()
            flat = packed.to("cpu").numpy()
            if rec is not None:
                rec.sync_end(d2h_bytes=flat.nbytes)
            flat = flat.astype(bool)
            T = t_bucket
            out = {
                "valid": flat[0:T], "conflict": flat[T:2 * T],
                "phantom": flat[2 * T:3 * T], "creator_ok": flat[3 * T:4 * T],
                "policy_ok": flat[4 * T:5 * T], "sig_valid": flat[5 * T:5 * T + n_sig],
            }
            off = 5 * T + n_sig
            out["safe"] = []
            for eb in e_sizes:
                out["safe"].append(flat[off:off + eb])
                off += eb
            return out

        return fetch
