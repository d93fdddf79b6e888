"""Channel configuration: the bundle, the named-policy tree and config
updates (counterpart: ``fabric_tpu/channelconfig.py``).

A channel's configuration is a versioned tree of groups, values and
policies (``protos.messages.ConfigGroup``); ``/Channel/Application/
Writers`` names the policy ``Writers`` of the group ``Application``.
An inner policy may be IMPLICIT_META: ANY, ALL or MAJORITY of a
sub-policy over the child groups.  A config update is authorized as
the reference's is (common/configtx/update.go): every read-set element
exists at its version, a root version bump needs the root's
``mod_policy``, every write-set element whose version is bumped (or
that is new) needs its ``mod_policy`` (a group's resolved from the
group itself, a value's or policy's from its group, walking up to the
root), an element at its current version must be unchanged, and a
bumped group's write set is its exact membership (deletions).

Config-update signatures are checked on the host, one by one, with
``crypto/ec_ref.py`` (``crypto.msp.verify_signature``), where the
reference checks them with ``cryptography``: config transactions are a
few a channel's lifetime, so the pure-Python verify costs nothing that
matters and keeps the port free of that package.  An idemix admin's
signature is its presentation proof (``crypto/idemix.py``), as in the
reference.  The bundle's MSP manager reads X.509 and idemix (type-1)
``MSPConfig``s; an update that replaces an idemix org's config with a
newer epoch record rotates the manager like any MSP change.

Deliberate differences from the reference: maps are serialized in
``deterministic=True`` order (the reference's ``SerializeToString()``
takes upb's hash order), so ``Bundle.hash`` and the
``validate_config_tx`` comparison of the authorized config with the
envelope's are over sorted bytes; ``application_policy_ast`` flattens
an implicit-meta policy over the child groups in name order.

``apply_committed_config`` is the counterpart of the peer's commit hook
(``fabric_tpu/peer/node.py:559-590``): a ``commit_fn`` calls it for a
committed block, and each VALID config transaction rotates the
processor's bundle and the validator's MSP manager.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.crypto.msp import (
    MSPManager, policy_from_proto, policy_to_proto, verify_signature,
)
from fabric_tpu_torch.peer.txcodes import TxValidationCode as C
from fabric_tpu_torch.protos import messages as m

# capability strings (common/capabilities/application.go)
CAP_V2_0 = "V2_0"


# ---------------------------------------------------------------------------
# Policy tree


@dataclass(frozen=True)
class ImplicitMeta:
    """ANY / ALL / MAJORITY (``messages.IMPLICIT_*``) of ``sub_policy``
    over the child groups."""

    rule: int
    sub_policy: str


def policy_from_config(cp: m.ConfigPolicy):
    """ConfigPolicy → signature-policy AST or ImplicitMeta."""
    p = cp.policy or m.Policy()
    if p.type == m.POLICY_SIGNATURE:
        return policy_from_proto(m.SignaturePolicyEnvelope.parse(p.value))
    if p.type == m.POLICY_IMPLICIT_META:
        im = m.ImplicitMetaPolicy.parse(p.value)
        return ImplicitMeta(rule=im.rule, sub_policy=im.sub_policy)
    raise ValueError(f"unsupported policy type {p.type}")


def config_policy(ast_or_meta, mod_policy: str = "Admins") -> m.ConfigPolicy:
    if isinstance(ast_or_meta, ImplicitMeta):
        policy = m.Policy(type=m.POLICY_IMPLICIT_META, value=m.ImplicitMetaPolicy(
            sub_policy=ast_or_meta.sub_policy, rule=ast_or_meta.rule).serialize())
    else:
        policy = m.Policy(type=m.POLICY_SIGNATURE,
                          value=policy_to_proto(ast_or_meta).serialize())
    return m.ConfigPolicy(mod_policy=mod_policy, policy=policy)


def _need(rule: int, n: int) -> int:
    return {m.IMPLICIT_ANY: 1, m.IMPLICIT_ALL: n, m.IMPLICIT_MAJORITY: n // 2 + 1}[rule]


@dataclass
class SignedData:
    """One signature over a config update: (identity, message, DER
    signature)."""

    identity: bytes
    data: bytes
    signature: bytes


class PolicyManager:
    """The named-policy tree over the config groups
    (common/policies/policy.go:132)."""

    def __init__(self, root_group: m.ConfigGroup, msp_manager: MSPManager):
        self.root = root_group
        self.msp = msp_manager

    def _group(self, path: list):
        g = self.root
        for seg in path:
            if seg not in g.groups:
                return None
            g = g.groups[seg]
        return g

    def get(self, path: str):
        """'/Channel/Group/.../Name' ('/Channel' optional) →
        (policy AST | ImplicitMeta, the group holding it) or None."""
        segs = [s for s in path.split("/") if s]
        if segs and segs[0] == "Channel":
            segs = segs[1:]
        if not segs:
            return None
        *grp_path, name = segs
        g = self._group(grp_path)
        if g is None or name not in g.policies:
            return None
        return policy_from_config(g.policies[name]), g

    def evaluate(self, path: str, signed: list) -> bool:
        got = self.get(path)
        if got is None:
            return False
        return self._eval(*got, signed)

    def _eval(self, rule, group: m.ConfigGroup, signed: list) -> bool:
        if isinstance(rule, ImplicitMeta):
            sub = rule.sub_policy
            children = [(policy_from_config(cg.policies[sub]), cg)
                        for cg in group.groups.values() if sub in cg.policies]
            if not children:
                return False
            got = sum(1 for r, g in children if self._eval(r, g, signed))
            return got >= _need(rule.rule, len(children))
        # a signature policy: each identity once, verified, then the
        # consuming evaluation (policy.go:360)
        seen: set = set()
        idents, valid = [], []
        for sd in signed:
            if sd.identity in seen:
                continue
            seen.add(sd.identity)
            try:
                ident = self.msp.deserialize_identity(sd.identity)
            except ValueError:
                continue
            idents.append(ident)
            valid.append(ident.is_valid and verify_signature(ident, sd.data, sd.signature))
        plan = pol.compile_plan(rule)
        mat = pol.match_matrix(idents, plan.principals)
        if idents:
            mat = mat & np.asarray(valid, bool)[:, None]
        return pol.evaluate(rule, mat)


# ---------------------------------------------------------------------------
# Bundle


class Bundle:
    """One channel's configuration: its policy manager, MSP manager and
    capabilities (channelconfig.Bundle)."""

    def __init__(self, channel_id: str, config: m.Config):
        self.channel_id = channel_id
        self.config = config
        root = config.channel_group or m.ConfigGroup()
        self.msp_manager = self._build_msps(root)
        self.policy_manager = PolicyManager(root, self.msp_manager)

    @property
    def sequence(self) -> int:
        return self.config.sequence

    @staticmethod
    def _build_msps(root: m.ConfigGroup) -> MSPManager:
        mgr = MSPManager()

        def walk(g: m.ConfigGroup):
            if "MSP" in g.values:
                mgr.add_config(m.MSPConfig.parse(g.values["MSP"].value))
            for child in g.groups.values():
                walk(child)

        walk(root)
        return mgr

    @staticmethod
    def _capabilities(group) -> set:
        if group is None or "Capabilities" not in group.values:
            return set()
        return set(m.Capabilities.parse(group.values["Capabilities"].value).capabilities)

    def channel_capabilities(self) -> set:
        return self._capabilities(self.config.channel_group)

    def application_capabilities(self) -> set:
        return self._capabilities(self._app())

    def _app(self):
        root = self.config.channel_group
        return None if root is None else root.groups.get("Application")

    def application_orgs(self) -> list:
        app = self._app()
        return sorted(app.groups) if app is not None else []

    def orderer_value(self, name: str, msg_type):
        root = self.config.channel_group
        ordg = None if root is None else root.groups.get("Orderer")
        if ordg is None or name not in ordg.values:
            return None
        return msg_type.parse(ordg.values[name].value)

    def application_policy(self, name: str):
        got = self.policy_manager.get(f"/Channel/Application/{name}")
        return got[0] if got else None

    def application_policy_ast(self, name: str):
        """The application policy as a signature-policy AST: an
        implicit-meta node becomes NOutOf over the child groups'
        sub-policies (exact while org principal sets are disjoint)."""
        got = self.policy_manager.get(f"/Channel/Application/{name}")
        return None if got is None else self._flatten(*got)

    def _flatten(self, rule, group: m.ConfigGroup):
        if not isinstance(rule, ImplicitMeta):
            return rule
        children = [(policy_from_config(group.groups[n].policies[rule.sub_policy]),
                     group.groups[n]) for n in sorted(group.groups)
                    if rule.sub_policy in group.groups[n].policies]
        if not children:
            return None
        subs = tuple(self._flatten(r, g) for r, g in children)
        if any(s is None for s in subs):
            return None
        return pol.NOutOf(_need(rule.rule, len(children)), subs)

    def hash(self) -> bytes:
        return hashlib.sha256(self.config.serialize()).digest()


def _config_envelope(env_bytes: bytes) -> m.ConfigEnvelope:
    env = m.Envelope.parse(env_bytes)
    return m.ConfigEnvelope.parse(m.Payload.parse(env.payload).data)


def bundle_from_genesis(channel_id: str, genesis_block: m.Block) -> Bundle:
    """The channel config of a genesis (or config) block's first
    envelope → Bundle."""
    cfg_env = _config_envelope(genesis_block.data.data[0])
    return Bundle(channel_id, cfg_env.config or m.Config())


# ---------------------------------------------------------------------------
# Config updates


class ConfigUpdateError(Exception):
    pass


def _walk_elements(group: m.ConfigGroup, path: str = ""):
    """(path, kind, name, element) for every group, value and policy."""
    for name, g in group.groups.items():
        yield (path, "group", name, g)
        yield from _walk_elements(g, f"{path}/{name}")
    for name, v in group.values.items():
        yield (path, "value", name, v)
    for name, p in group.policies.items():
        yield (path, "policy", name, p)


def _find(group: m.ConfigGroup, path: str, kind: str, name: str):
    g = group
    for seg in [s for s in path.split("/") if s]:
        if seg not in g.groups:
            return None
        g = g.groups[seg]
    return {"group": g.groups, "value": g.values, "policy": g.policies}[kind].get(name)


def authorize_update(bundle: Bundle, update_env: m.ConfigUpdateEnvelope) -> m.Config:
    """Authorize a config update against ``bundle`` → the new Config;
    raises ConfigUpdateError (see the module docstring)."""
    update = m.ConfigUpdate.parse(update_env.config_update)
    if update.channel_id and update.channel_id != bundle.channel_id:
        raise ConfigUpdateError(
            f"update for channel {update.channel_id!r} applied to {bundle.channel_id!r}")
    current = bundle.config.channel_group or m.ConfigGroup()
    read_set = update.read_set or m.ConfigGroup()
    write_set = update.write_set or m.ConfigGroup()

    for path, kind, name, elem in _walk_elements(read_set):
        cur = _find(current, path, kind, name)
        if cur is None or cur.version != elem.version:
            raise ConfigUpdateError(f"read-set version mismatch at {path}/{name} ({kind})")

    signed = [SignedData(identity=m.SignatureHeader.parse(cs.signature_header).creator,
                         data=cs.signature_header + update_env.config_update,
                         signature=cs.signature)
              for cs in update_env.signatures]

    # the channel group itself: a bump needs the root's mod_policy, and
    # is what authorizes root-level deletions
    if write_set.version not in (current.version, current.version + 1):
        raise ConfigUpdateError(
            f"root group version jump: {current.version} → {write_set.version}")
    if write_set.version == current.version + 1:
        mp = current.mod_policy or "Admins"
        if not _eval_mod_policy(bundle, "", mp, signed):
            raise ConfigUpdateError(f"mod_policy {mp!r} not satisfied for the channel group")

    for path, kind, name, elem in _walk_elements(write_set):
        cur = _find(current, path, kind, name)
        if cur is not None and elem.version == cur.version:
            if kind != "group" and elem.serialize() != cur.serialize():
                raise ConfigUpdateError(f"write-set modifies {path}/{name} without version bump")
            continue
        if cur is not None and elem.version != cur.version + 1:
            raise ConfigUpdateError(
                f"write-set version jump at {path}/{name}: {cur.version} → {elem.version}")
        if cur is None and elem.version != 0:
            raise ConfigUpdateError(f"new element {path}/{name} must start at version 0")
        mod_policy = (cur.mod_policy if cur is not None else "") \
            or _ancestor_mod_policy(current, path)
        base = f"{path}/{name}" if kind == "group" and cur is not None else path
        if not _eval_mod_policy(bundle, base, mod_policy, signed):
            raise ConfigUpdateError(f"mod_policy {mod_policy!r} not satisfied for {path}/{name}")

    new_config = bundle.config.copy()
    new_config.sequence = bundle.config.sequence + 1
    root = new_config.channel_group
    if root is None:
        root = new_config.channel_group = m.ConfigGroup()
    root_bumped = write_set.version > current.version
    root.version = write_set.version
    _apply_write_set(root, write_set, version_bumped=root_bumped)
    return new_config


def _ancestor_mod_policy(current: m.ConfigGroup, path: str) -> str:
    g, mp = current, current.mod_policy
    for seg in [s for s in path.split("/") if s]:
        if seg not in g.groups:
            break
        g = g.groups[seg]
        mp = g.mod_policy or mp
    return mp or "Admins"


def _eval_mod_policy(bundle: Bundle, path: str, mod_policy: str, signed: list) -> bool:
    """Resolve ``mod_policy`` relative to the group ``path``, walking up
    to the root, and evaluate it."""
    if mod_policy.startswith("/"):
        return bundle.policy_manager.evaluate(mod_policy, signed)
    segs = [s for s in path.split("/") if s]
    for i in range(len(segs), -1, -1):
        p = "/" + "/".join(segs[:i] + [mod_policy])
        if bundle.policy_manager.get(p) is not None:
            return bundle.policy_manager.evaluate(p, signed)
    return False


def _apply_write_set(target: m.ConfigGroup, write: m.ConfigGroup,
                     version_bumped: bool = False) -> None:
    """Merge a write set into the group tree: a bumped group's write
    set is its exact membership; an unbumped one only overlays what it
    names."""
    if version_bumped:
        for coll, wcoll in ((target.groups, write.groups), (target.values, write.values),
                            (target.policies, write.policies)):
            for name in [n for n in coll if n not in wcoll]:
                del coll[name]
    for name, g in write.groups.items():
        tgt = target.groups.get(name)
        if tgt is None:
            target.groups[name] = g.copy()
            continue
        bumped = g.version > tgt.version
        tgt.version = g.version
        if g.mod_policy:
            tgt.mod_policy = g.mod_policy
        _apply_write_set(tgt, g, version_bumped=bumped)
    for name, v in write.values.items():
        target.values[name] = v.copy()
    for name, p in write.policies.items():
        target.policies[name] = p.copy()


# ---------------------------------------------------------------------------
# Config transactions on the commit path (v20/validator.go:397-419)


class ConfigTxProcessor:
    """Holds one channel's live bundle: ``validate_config_tx`` judges a
    CONFIG envelope for the validator, ``apply`` installs a committed
    one."""

    def __init__(self, bundle: Bundle):
        self.bundle = bundle
        self.listeners: list = []

    def validate_config_tx(self, ptx, cfg_env: m.ConfigEnvelope) -> int:
        """VALID when the envelope's last update authorizes exactly the
        envelope's config, else INVALID_OTHER_REASON."""
        try:
            proposed = self._authorized_config(cfg_env)
        except NotImplementedError:
            raise
        except Exception:
            return int(C.INVALID_OTHER_REASON)
        if proposed.serialize() != (cfg_env.config or m.Config()).serialize():
            return int(C.INVALID_OTHER_REASON)
        return int(C.VALID)

    def _authorized_config(self, cfg_env: m.ConfigEnvelope) -> m.Config:
        if cfg_env.last_update is None:
            raise ConfigUpdateError("config envelope missing last_update")
        payload = m.Payload.parse(cfg_env.last_update.payload)
        return authorize_update(self.bundle, m.ConfigUpdateEnvelope.parse(payload.data))

    def apply(self, cfg_env: m.ConfigEnvelope) -> Bundle:
        new = Bundle(self.bundle.channel_id, cfg_env.config or m.Config())
        self.bundle = new
        for fn in self.listeners:
            fn(new)
        return new


def apply_committed_config(res, validator) -> None:
    """After ``res`` (a pipeline ``CommittedBlock``) committed: each
    VALID config transaction of it is applied to the validator's
    ``config_processor`` and the validator's MSP manager rotates onto
    the new bundle's, so later blocks validate against the new
    membership (the reference's node.py:559-590)."""
    proc = validator.config_processor
    if proc is None:
        return
    for ptx in res.pend.txs:
        if not ptx.is_config or res.tx_filter[ptx.idx] != int(C.VALID):
            continue
        try:
            cfg_env = m.ConfigEnvelope.parse(ptx.config_data)
        except ValueError:
            continue  # VALID yet malformed: genesis noise, as the reference skips it
        validator.msp = proc.apply(cfg_env).msp_manager
