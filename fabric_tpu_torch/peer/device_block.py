"""Fused block stage 2: endorsement-policy reduction + MVCC on the
verify batch's device-resident output (counterpart:
``fabric_tpu/peer/device_block.py``).

Per block the signature bits never leave the device: the creator gather,
one policy reduction per policy group (counts of principal matches
against leaf ranks, the n-of gate walk, the consumption-safety bit,
a min-fold into each transaction), pre_ok = structural & creator &
policy, the MVCC conflict relations and validity fixpoint, and one
packed int8 vector comes back:

    [0:T] valid | [T:2T] conflict | [2T:3T] phantom | [3T:4T] creator_ok
    | [4T:5T] policy_ok | [5T:5T+n_sig] sig_valid | per group [Eb] safe

Operands keep the reference's packing: ``launch_vec [T, 3]`` int32
(creator_idx | structural | ver_ok; creator sentinels -1 → False,
-2 → True), one ``[Eb, S*P + S + 1]`` int32 frame per group
(match | endo_idx | tx_of) and ``static_packed [T, R + W + 2Q]``.
The reference compiles one program per set of policy plans; here the
gate tree goes to the kernel as data (``plan_vector``), so nothing is
built per plan.  ``stage2`` is the wrapper: CPU tensors run
``stage2_ref``, CUDA tensors launch ``stage2_policy`` once per group and
``stage2_mvcc`` (two launches) from ``kernels/csrc/stage2.cu``.

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
"""

from __future__ import annotations

import torch

from fabric_tpu_torch import kernels
from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.ops import mvcc as mvcc_ops

MAX_PRINCIPALS = 32   # the kernel's per-policy principal columns
MAX_SLOTS = 64        # the kernel's leaves + gates per policy


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
    return ([L, G, mask, 0] + list(plan.leaf_principal) + list(plan.leaf_rank)
            + [n for n, _ in plan.gates] + offs + children)


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


def stage2(sig_valid, launch_vec, groups, static_p, dims, plan_tensors=None) -> torch.Tensor:
    """The fused stage 2 → packed int8.  ``plan_tensors`` (CUDA only):
    one ``plan_vector`` int32 tensor per group, built here when None."""
    if sig_valid.device.type == "cpu":
        return stage2_ref(sig_valid, launch_vec, groups, static_p, dims)
    dev = sig_valid.device
    T, n_sig = launch_vec.shape[0], sig_valid.shape[0]
    if plan_tensors is None:
        plan_tensors = [torch.tensor(plan_vector(g[0]), dtype=torch.int32, device=dev)
                        for g in groups]
    out = torch.empty(5 * T + n_sig + sum(g[2] for g in groups), dtype=torch.int8,
                      device=dev)
    policy_ok = torch.ones(T + 1, dtype=torch.int32, device=dev)
    off = 5 * T + n_sig
    for (plan, gp, Eb, S), pt in zip(groups, plan_tensors):
        kernels.stage2_policy(sig_valid, gp, S, len(plan.principals), pt, policy_ok,
                              out[off:off + Eb])
        off += Eb
    R, W, Q = dims
    kernels.stage2_mvcc(static_p, R, W, Q, launch_vec, sig_valid, policy_ok, out)
    return out


class DeviceBlockPipeline:
    """Runs the fused stage 2 of one block on the verify handle's
    device and returns a fetch for the unpacked result.  Plan tensors
    are built once per plan and device."""

    def __init__(self):
        self._plans: dict = {}  # (id(plan), device) → (plan, tensor)

    def _plan_tensor(self, plan, dev):
        key = (id(plan), dev)
        hit = self._plans.get(key)
        if hit is None or hit[0] is not plan:
            hit = self._plans[key] = (
                plan, torch.tensor(plan_vector(plan), dtype=torch.int32, device=dev))
        return hit[1]

    def run(self, handle, launch_vec: torch.Tensor, groups, static_packed, static_dims,
            t_bucket: int):
        """handle: ``ops.p256v3.VerifyHandle``; launch_vec [T, 3] int32
        tensor on the handle's device (its ver_ok column filled on the
        host or by ``resident_ver_ok``); groups [(plan, gp tensor, Eb,
        S)]; static_packed [T, R+W+2Q] int32 tensor.  → zero-arg fetch
        of a dict of numpy arrays (valid, conflict, phantom, creator_ok,
        policy_ok, sig_valid, safe: [per-group arrays])."""
        sv = handle.device_out
        dev = sv.device
        pts = None
        if dev.type == "cuda":
            pts = [self._plan_tensor(g[0], dev) for g in groups]
        packed = stage2(sv, launch_vec, groups, static_packed, static_dims, pts)
        n_sig = int(sv.shape[0])
        e_sizes = [g[2] for g in groups]

        def fetch():
            flat = packed.to("cpu").numpy().astype(bool)
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
