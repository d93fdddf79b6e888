"""Signature-policy engine (counterpart: ``fabric_tpu/crypto/policy.py``,
a copy trimmed to the batch forms the commit path uses).

The reference compiles a SignaturePolicyEnvelope into a tree of
closures evaluated per transaction with short-circuiting and signature
*consumption* (each endorsement satisfies at most one SignedBy leaf) —
common/cauthdsl/cauthdsl.go:24-110 — plus the text DSL
``AND('Org1.member', ...)`` (common/policydsl).

``compile_plan`` flattens the tree into a batch plan: a list of
principals (leaf columns) and a post-order gate array — data, not code,
so the stage-2 policy kernel (``peer/device_block.py``) takes the gate
tree as arrays.  Two evaluators:

* ``evaluate`` — the exact sequential interpreter with the reference's
  greedy consumption (the oracle, and the host redo for rows where one
  signature satisfies two distinct leaf principals);
* the count-based batch forms on ``BatchPlan`` — exact whenever
  ``consumption_safe_batch`` holds for the row.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


# ---------------------------------------------------------------------------
# Principals (subset mirroring msp.MSPPrincipal: ROLE / OU / IDENTITY)

ROLE_MEMBER = "member"
ROLE_ADMIN = "admin"
ROLE_CLIENT = "client"
ROLE_PEER = "peer"
ROLE_ORDERER = "orderer"
_ROLES = {ROLE_MEMBER, ROLE_ADMIN, ROLE_CLIENT, ROLE_PEER, ROLE_ORDERER}


@dataclass(frozen=True)
class Principal:
    """msp_id + role principal (msp/mspimpl.go:425 SatisfiesPrincipal)."""

    msp_id: str
    role: str = ROLE_MEMBER

    def matched_by(self, identity) -> bool:
        """identity: any object with .msp_id, .role ('admin'/'client'/
        'peer'/...), and .is_valid (cert-chain validity)."""
        if identity.msp_id != self.msp_id or not getattr(identity, "is_valid", True):
            return False
        if self.role == ROLE_MEMBER:
            return True
        return getattr(identity, "role", None) == self.role


# ---------------------------------------------------------------------------
# Policy AST


@dataclass(frozen=True)
class SignedBy:
    principal: Principal


@dataclass(frozen=True)
class NOutOf:
    n: int
    rules: tuple

    def __post_init__(self):
        if not (0 <= self.n <= len(self.rules)):
            raise ValueError(f"NOutOf({self.n}) over {len(self.rules)} rules")


def And(*rules):
    return NOutOf(len(rules), tuple(rules))


def Or(*rules):
    return NOutOf(1, tuple(rules))


# ---------------------------------------------------------------------------
# Text DSL: AND('Org1.member', OR('Org2.admin', 'Org3.peer')),
# OutOf(2, 'A.member', 'B.member', 'C.member')  (common/policydsl grammar)

_PRINCIPAL_RE = re.compile(r"^([A-Za-z0-9._-]+)\.(\w+)$")


def from_dsl(text: str):
    """Parse the policydsl grammar into the AST."""
    text = text.strip()
    tokens = re.findall(r"[A-Za-z]+\(|\)|,|'[^']*'|\"[^\"]*\"|\d+", text)
    pos = 0

    def parse():
        nonlocal pos
        tok = tokens[pos]
        if tok.endswith("("):
            op = tok[:-1].upper()
            pos += 1
            args = []
            while tokens[pos] != ")":
                if tokens[pos] == ",":
                    pos += 1
                    continue
                args.append(parse())
            pos += 1  # consume ')'
            if op == "AND":
                return And(*args)
            if op == "OR":
                return Or(*args)
            if op == "OUTOF":
                n = args[0]
                if not isinstance(n, int):
                    raise ValueError("OutOf needs integer first arg")
                return NOutOf(n, tuple(args[1:]))
            raise ValueError(f"unknown op {op}")
        if tok.isdigit():
            pos += 1
            return int(tok)
        if tok[0] in "'\"":
            pos += 1
            m = _PRINCIPAL_RE.match(tok[1:-1])
            if not m:
                raise ValueError(f"bad principal {tok}")
            msp_id, role = m.groups()
            if role not in _ROLES:
                raise ValueError(f"bad role {role}")
            return SignedBy(Principal(msp_id, role))
        raise ValueError(f"unexpected token {tok}")

    rule = parse()
    if pos != len(tokens) or isinstance(rule, int):
        raise ValueError(f"trailing tokens in policy: {text}")
    return rule


# ---------------------------------------------------------------------------
# Batch plan: flattened post-order gate program


@dataclass
class BatchPlan:
    """Flattened policy for array evaluation.

    principals: leaf columns, deduplicated.
    leaf_principal: for each leaf node, its column in ``principals``.
    gates: post-order list of (n, child_slots) where child_slots index
        into the value vector: slots [0, n_leaves) are leaves, then one
        slot per gate in order.  The last gate is the root.
    A tree that is a bare SignedBy gets a single 1-of-1 gate.
    """

    principals: list = field(default_factory=list)
    leaf_principal: list = field(default_factory=list)
    leaf_rank: list = field(default_factory=list)
    gates: list = field(default_factory=list)

    @property
    def n_leaves(self) -> int:
        return len(self.leaf_principal)

    def leaf_sat_batch(self, m3):
        """[T, S, P] bool → [T, n_leaves] bool — the single source of
        truth for count-based leaf semantics (the stage-2 kernel in
        peer/device_block mirrors THIS)."""
        import numpy as np

        m3 = np.asarray(m3, bool)
        T = m3.shape[0]
        if self.n_leaves == 0:
            return np.zeros((T, 0), bool)
        counts = m3.sum(axis=1)  # [T, P] distinct sigs per column
        cols = np.asarray(self.leaf_principal, int)
        ranks = np.asarray(self.leaf_rank, int)
        return ranks[None, :] < counts[:, cols]

    def evaluate_counts_batch(self, m3):
        """[T, S, P] → [T] bool, vectorized gate walk."""
        import numpy as np

        m3 = np.asarray(m3, bool)
        T = m3.shape[0]
        leaf = self.leaf_sat_batch(m3)
        vals = [leaf[:, i] for i in range(self.n_leaves)]
        for n, children in self.gates:
            acc = np.zeros(T, int)
            for c in children:
                acc += vals[c].astype(int)
            vals.append(acc >= n)
        return vals[-1]

    def consumption_safe_batch(self, m3):
        """[T, S, P] → [T] bool."""
        import numpy as np

        m3 = np.asarray(m3, bool)
        if m3.size == 0:
            return np.ones(m3.shape[0], bool)
        cols = np.asarray(sorted(set(self.leaf_principal)), int)
        return (m3[:, :, cols].sum(axis=2) <= 1).all(axis=1)


def compile_plan(rule) -> BatchPlan:
    """Flatten the AST into a BatchPlan (contrast cauthdsl's closure
    compiler: the output is data, not code)."""
    plan = BatchPlan()
    pindex: dict = {}

    def leaf_col(principal: Principal) -> int:
        if principal not in pindex:
            pindex[principal] = len(plan.principals)
            plan.principals.append(principal)
        return pindex[principal]

    col_uses: dict = {}

    # first pass: count leaves to lay out slots
    def walk(node):
        if isinstance(node, SignedBy):
            slot = plan.n_leaves
            col = leaf_col(node.principal)
            plan.leaf_principal.append(col)
            # rank of this leaf among leaves of the same column, in
            # evaluation (DFS, left-to-right) order — consumption's
            # per-column signature budget index
            plan.leaf_rank.append(col_uses.get(col, 0))
            col_uses[col] = col_uses.get(col, 0) + 1
            return ("leaf", slot)
        if isinstance(node, NOutOf):
            children = [walk(r) for r in node.rules]
            return ("gate", node.n, children)
        raise TypeError(f"bad policy node {node!r}")

    tree = walk(rule)
    n_leaves = plan.n_leaves

    def emit(node) -> int:
        if node[0] == "leaf":
            return node[1]
        _, n, children = node
        slots = [emit(c) for c in children]
        plan.gates.append((n, slots))
        return n_leaves + len(plan.gates) - 1

    root = emit(tree)
    if not plan.gates or root != n_leaves + len(plan.gates) - 1:
        # bare SignedBy root: wrap in a 1-of-1 gate
        plan.gates.append((1, [root]))
    return plan


# ---------------------------------------------------------------------------
# Exact interpreter (the reference's consumption semantics)


def evaluate(rule, match, plan: "BatchPlan | None" = None) -> bool:
    """Evaluate with greedy signature consumption.

    match: [S, P_all] bool where columns follow ``compile_plan(rule)
    .principals`` — use ``match_matrix`` to build it.  ``plan``: that
    compiled plan, when the caller holds it (the host path evaluates one
    policy per transaction, and compiling it each time cost more than
    the evaluation).  Mirrors
    cauthdsl.go:39-110: SignedBy consumes the first unused matching
    signature; NOutOf evaluates ALL children left-to-right (no
    short-circuit — every satisfied child consumes its signature) and
    compares the count against n.
    """
    import numpy as np

    if plan is None:
        plan = compile_plan(rule)
    pindex = {p: i for i, p in enumerate(plan.principals)}
    m = np.asarray(match)
    S = m.shape[0] if m.size else 0
    used = [False] * S

    def ev(node) -> bool:
        if isinstance(node, SignedBy):
            col = pindex[node.principal]
            for s in range(S):
                if not used[s] and m[s, col]:
                    used[s] = True
                    return True
            return False
        count = 0
        for r in node.rules:
            if ev(r):
                count += 1
        return count >= node.n

    root = rule if isinstance(rule, NOutOf) else NOutOf(1, (rule,))
    return ev(root)


def match_matrix(identities, principals) -> "np.ndarray":
    """[S, P] bool: identity s satisfies principal p (host-side MSP
    SatisfiesPrincipal batch)."""
    import numpy as np

    return np.array(
        [[p.matched_by(ident) for p in principals] for ident in identities],
        dtype=bool,
    ).reshape(len(identities), len(principals))
