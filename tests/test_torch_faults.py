"""The port's fault plan (``fabric_tpu_torch/faults/plan.py``) against the
JAX package's, and the ledger under the ``crash`` kind, on the CPU.

Plan parity: for every kind and for ``p``/``n``/``after``, the same spec
and seed fire at the same arrivals in both packages, with the same
stats; malformed specs raise in both; ``shield()`` suppresses firing in
both; ``afire`` awaits a latency fault without blocking the loop; the
environment arms a child process and seeds ``configure``.  Crash: a
child process that commits blocks into the port's ``KVLedger`` (serially,
or through ``CommitPipeline(depth=2)`` with a per-commit sync or pure
group commit) and is armed by ``FABTPU_FAULTS`` with
``ledger.fsync.{before,after}:crash:after=1`` dies with code 86; the
reopened ledger is at a consistent height, links its chain, replays its
state, keeps accepting blocks, and its state digest and commit hash
equal those of a ledger that committed the same blocks without a fault
(the reference's ``tests/test_faults.py:741-935``)."""

import asyncio
import os
import subprocess
import sys
import textwrap
import time

import pytest

from fabric_tpu import faults as jfaults
from fabric_tpu_torch import faults
from fabric_tpu_torch import protoutil as pu
from fabric_tpu_torch.ledger.kvledger import KVLedger
from fabric_tpu_torch.ledger.statedb import MemVersionedDB
from torch_fault_toys import toy_batch, toy_blocks, toy_txid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_plan():
    """Every test starts and ends with no armed plan in either package."""
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


# ---------------------------------------------------------------------------
# Plan parity


def _outcomes(mod, spec, seed, points, monkeypatch, rounds=40):
    """Fire every point ``rounds`` times → (what fired [(round, point,
    exception or sleep)], stats, fired count, points)."""
    seen = []
    monkeypatch.setattr(time, "sleep", lambda s: seen.append(("sleep", s)))
    plan = mod.FaultPlan(spec, seed=seed)
    for i in range(rounds):
        for point in points:
            try:
                plan.fire(point)
            except Exception as e:  # each kind's exception is compared
                seen.append((i, point, type(e).__name__, str(e)))
    return seen, plan.stats(), plan.fired(), plan.points


_SPECS = [
    "a:raise",
    "a:raise:n=3",
    "a:raise:after=5",
    "a:raise:after=4:n=2",
    "a:disconnect:n=2:after=1;a:truncate:after=3",
    "a:latency:ms=2:after=1:n=5;b:raise:after=7",
]


@pytest.mark.parametrize("spec", _SPECS + [
    "a:raise:p=0.3",
    "a:disconnect:p=0.5:n=4",
    "a:truncate:after=2:p=0.7",
    "a:latency:ms=1:p=0.4;b:raise:p=0.6",
    "a:raise:p=0.5;a:disconnect:p=0.5;b:truncate:n=1:after=9",
    "validator.verify_launch:raise:p=0.35;validator.stage2:raise:n=1:after=3;"
    "hostpool.task:raise:n=1:after=6;pipeline.prefetch:disconnect:n=1:after=6;"
    "pipeline.commit:raise:n=1:after=2",
])
def test_seeded_plan_fires_at_the_same_arrivals(spec, monkeypatch):
    points = sorted({p.split(":")[0] for p in spec.split(";")} | {"unarmed"})
    port = _outcomes(faults, spec, 20260803, points, monkeypatch)
    ref = _outcomes(jfaults, spec, 20260803, points, monkeypatch)
    assert port == ref
    assert port[2] > 0


@pytest.mark.parametrize("spec", _SPECS)
def test_unseeded_plan_fires_at_the_same_arrivals(spec, monkeypatch):
    """Without ``p`` a rule draws nothing: an unseeded plan is as
    deterministic as a seeded one."""
    points = sorted({p.split(":")[0] for p in spec.split(";")})
    assert (_outcomes(faults, spec, None, points, monkeypatch)
            == _outcomes(jfaults, spec, None, points, monkeypatch))


@pytest.mark.parametrize("bad", ["point-only", "p:unknownkind", "p:raise:p=2", "p:raise:p=-1",
                                 "p:raise:bogus=1", "p:latency", "p:latency:ms=0",
                                 "p:raise:n=x", "p:crash:after=y"])
def test_malformed_specs_raise_in_both(bad):
    with pytest.raises(faults.FaultSpecError):
        faults.FaultPlan(bad)
    with pytest.raises(jfaults.FaultSpecError):
        jfaults.FaultPlan(bad)


def test_kinds_raise_what_the_reference_raises():
    for mod in (faults, jfaults):
        p = mod.FaultPlan("a:disconnect;b:truncate;c:raise")
        with pytest.raises(ConnectionResetError, match="disconnect"):
            p.fire("a")
        with pytest.raises(ConnectionResetError, match="truncated"):
            p.fire("b")
        with pytest.raises(mod.InjectedFault) as ei:
            p.fire("c")
        assert ei.value.point == "c" and isinstance(ei.value, RuntimeError)


def test_latency_sleeps_ms(monkeypatch):
    for mod in (faults, jfaults):
        slept = []
        monkeypatch.setattr(time, "sleep", lambda s: slept.append(s))
        p = mod.FaultPlan("x:latency:ms=30:n=2")
        for _ in range(4):
            p.fire("x")
        assert slept == [0.03, 0.03]


@pytest.mark.parametrize("which", ["port", "ref"])
def test_shield_suppresses_firing(which):
    mod = faults if which == "port" else jfaults
    p = mod.configure("x:raise")
    with pytest.raises(mod.InjectedFault):
        mod.fire("x")
    with mod.shield():
        mod.fire("x")  # a recovery path: no trigger, no arrival counted
        with mod.shield():
            mod.fire("x")
        mod.fire("x")
    with pytest.raises(mod.InjectedFault):
        mod.fire("x")  # released
    assert p.stats()["x"][0] == {"kind": "raise", "arrivals": 2, "fired": 2}


def test_global_configure_install_reset():
    assert faults.plan() is None
    faults.fire("anything")  # no plan: a no-op
    p = faults.configure("x:raise:n=1")
    assert faults.plan() is p
    with pytest.raises(faults.InjectedFault):
        faults.fire("x")
    faults.fire("x")
    faults.reset()
    assert faults.plan() is None
    mine = faults.FaultPlan("y:raise")
    faults.install(mine)
    with pytest.raises(faults.InjectedFault):
        faults.fire("y")
    assert mine.fired("y") == 1
    assert faults.configure("") is None and faults.plan() is None


def test_configure_seeds_from_the_environment(monkeypatch):
    for mod in (faults, jfaults):
        monkeypatch.setenv(mod.ENV_SEED, "41")
        assert mod.configure("x:raise:p=0.5").seed == 41
        monkeypatch.delenv(mod.ENV_SEED)
        assert mod.configure("x:raise").seed is None
        assert mod.configure("x:raise", seed=9).seed == 9
        mod.reset()


@pytest.mark.parametrize("which", ["port", "ref"])
def test_afire_latency_keeps_the_loop_live(which):
    mod = faults if which == "port" else jfaults
    mod.configure("d.read:latency:ms=60:n=1;d.cut:disconnect;d.err:raise")
    ticks = []

    async def ticker():
        for _ in range(8):
            ticks.append(1)
            await asyncio.sleep(0.005)

    async def scenario():
        t = asyncio.ensure_future(ticker())
        await mod.afire("d.read")  # 60 ms, the loop stays live
        with pytest.raises(ConnectionResetError):
            await mod.afire("d.cut")
        with pytest.raises(mod.InjectedFault):
            await mod.afire("d.err")
        with mod.shield():
            await mod.afire("d.err")
        await t

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(asyncio.wait_for(scenario(), 10))
    finally:
        loop.close()
    assert len(ticks) == 8  # the ticker ran during the injected latency
    assert mod.plan().fired("d.read") == 1


def test_crash_hooks_run_in_order_and_contained(tmp_path):
    """A crash fault runs each hook (a failing one does not save the
    process) and exits with 86; a removed hook does not run."""
    out = tmp_path / "hooks.txt"
    script = textwrap.dedent(f"""\
        import sys
        sys.path.insert(0, {REPO!r})
        from fabric_tpu_torch import faults
        def good(point):
            open({str(out)!r}, "a").write("good " + point + "\\n")
        def bad(point):
            raise RuntimeError("a broken hook")
        def gone(point):
            open({str(out)!r}, "a").write("gone\\n")
        faults.on_crash(bad)
        faults.on_crash(good)
        faults.on_crash(good)
        faults.on_crash(gone)
        faults.remove_crash_hook(gone)
        faults.remove_crash_hook(gone)
        faults.configure("die.here:crash:after=1")
        faults.fire("die.here")
        print("SURVIVED ONE")
        faults.fire("die.here")
        print("SURVIVED TWO")
    """)
    path = tmp_path / "hooks.py"
    path.write_text(script)
    res = subprocess.run([sys.executable, str(path)], capture_output=True, text=True,
                         timeout=60, env=_child_env(None))
    assert res.returncode == faults.CRASH_EXIT == 86, (res.stdout, res.stderr)
    assert "SURVIVED ONE" in res.stdout and "SURVIVED TWO" not in res.stdout
    assert out.read_text() == "good die.here\n"


def _child_env(spec, seed=None):
    env = dict(os.environ)
    env.pop(faults.ENV_SPEC, None)
    env.pop(faults.ENV_SEED, None)
    if spec:
        env[faults.ENV_SPEC] = spec
    if seed is not None:
        env[faults.ENV_SEED] = str(seed)
    return env


def test_environment_arms_a_child_process(tmp_path):
    script = textwrap.dedent(f"""\
        import sys
        sys.path.insert(0, {REPO!r})
        from fabric_tpu_torch import faults
        p = faults.plan()
        print("SEED", p.seed if p is not None else "none")
        for i in range(3):
            try:
                faults.fire("child.point")
                print("NOFIRE", i)
            except faults.InjectedFault:
                print("FIRED", i)
    """)
    path = tmp_path / "child.py"
    path.write_text(script)
    res = subprocess.run([sys.executable, str(path)], capture_output=True, text=True,
                         timeout=60, env=_child_env("child.point:raise:after=1:n=1", seed=7))
    assert res.returncode == 0, res.stderr
    assert res.stdout.split("\n")[:4] == ["SEED 7", "NOFIRE 0", "FIRED 1", "NOFIRE 2"]
    res = subprocess.run([sys.executable, str(path)], capture_output=True, text=True,
                         timeout=60, env=_child_env(None))
    assert res.stdout.startswith("SEED none\nNOFIRE 0"), res.stdout


# ---------------------------------------------------------------------------
# The ledger under ``crash``

_CHILD = """\
import sys
sys.path.insert(0, {repo!r})
from fabric_tpu_torch.ledger.kvledger import KVLedger
from fabric_tpu_torch.ledger.statedb import MemVersionedDB
from fabric_tpu_torch.peer.pipeline import CommitPipeline
sys.path.insert(0, {tests!r})
from torch_fault_toys import ToyValidator, toy_batch, toy_blocks, toy_txid

lg = KVLedger(sys.argv[1], state_db=MemVersionedDB(), enable_history=False)
lg.blocks.group_commit = 4
n, depth, mode = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
blocks = toy_blocks(n)
if depth == 0:
    for blk in blocks:
        lg.commit_block(blk, bytes([0]), toy_batch(blk), [], None, [(toy_txid(blk), 0)])
else:
    def commit_fn(res):
        lg.commit_block(res.block, res.tx_filter, res.batch, res.history, None,
                        [(t["id"], i) for i, t in enumerate(res.pend.raw)])
        if mode == "honor":  # every commit durable before the next
            lg.blocks.sync()
    with CommitPipeline(ToyValidator(), commit_fn, depth=depth) as pipe:
        for blk in blocks:
            pipe.submit(blk)
print("HEIGHT", lg.height)
lg.close()
"""


def _run_child(tmp_path, n_blocks, depth, mode, spec):
    script = tmp_path / "crash_child.py"
    script.write_text(_CHILD.format(repo=REPO, tests=os.path.join(REPO, "tests")))
    ledger_dir = str(tmp_path / "ledger")
    res = subprocess.run([sys.executable, str(script), ledger_dir, str(n_blocks), str(depth),
                          mode], env=_child_env(spec), capture_output=True, text=True,
                         timeout=120)
    return ledger_dir, res


def _clean_ledger(d, height):
    """The same blocks committed with no fault, up to ``height``."""
    lg = KVLedger(d, state_db=MemVersionedDB(), enable_history=False)
    for blk in toy_blocks(height):
        lg.commit_block(blk, bytes([0]), toy_batch(blk), [], None, [(toy_txid(blk), 0)])
    return lg


def _reopen_and_verify(tmp_path, ledger_dir, expect_height, indexed_txids=None):
    """Reopen: the height, a linked chain, the tx-id index up to
    ``indexed_txids`` (blocks re-indexed from the files parse their
    envelopes, and a toy JSON payload has no tx id), the state replayed
    by ``recover``, digest and commit hash equal to a clean ledger's at
    that height, and one more block accepted."""
    lg = KVLedger(ledger_dir, state_db=MemVersionedDB(), enable_history=False)
    clean = _clean_ledger(str(tmp_path / "clean"), expect_height)
    try:
        assert lg.height == expect_height
        prev = b""
        for n in range(lg.height):
            blk = lg.blocks.get_block(n)
            assert blk is not None and blk.header.previous_hash == prev
            if n < (expect_height if indexed_txids is None else indexed_txids):
                assert lg.blocks.tx_exists(f"tx{n}")
            prev = pu.block_header_hash(blk.header)
        assert lg.blocks.get_block(lg.height) is None
        assert lg.recover(lambda blk: (bytes([0]), toy_batch(blk), [])) == expect_height
        assert lg.state_digest() == clean.state_digest()
        assert lg.commit_hash == clean.commit_hash is not None
        nxt = toy_blocks(expect_height + 1)[-1]
        lg.commit_block(nxt, bytes([0]), toy_batch(nxt), [], None, [(f"tx{expect_height}", 0)])
        assert lg.height == expect_height + 1 and lg.blocks.tx_exists(f"tx{expect_height}")
    finally:
        lg.close()
        clean.close()


@pytest.mark.parametrize("hook", ["before", "after"])
def test_kill_mid_fsync_replays_to_consistent_height(tmp_path, hook):
    """Serial commits, group commit 4: the second fsync (block 7's)
    kills the child; block 7's record is on disk but unindexed, so the
    reopened ledger indexes it from the files: height 8."""
    d, res = _run_child(tmp_path, 12, 0, "windowed", f"ledger.fsync.{hook}:crash:after=1")
    assert res.returncode == 86, (res.stdout, res.stderr)
    assert "HEIGHT" not in res.stdout
    _reopen_and_verify(tmp_path, d, expect_height=8, indexed_txids=7)


def test_torn_tail_after_crash_truncates_and_recovers(tmp_path):
    """A crash, then the unsynced tail torn mid-record: reopen truncates
    to the last whole record (height 7)."""
    d, res = _run_child(tmp_path, 12, 0, "windowed", "ledger.fsync.before:crash:after=1")
    assert res.returncode == 86, (res.stdout, res.stderr)
    seg = os.path.join(d, "chains", "blocks_000000.bin")
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) - 7)
    _reopen_and_verify(tmp_path, d, expect_height=7)


@pytest.mark.parametrize("hook", ["before", "after"])
def test_pipelined_group_commit_crash_replays(tmp_path, hook):
    """``CommitPipeline(depth=2)`` with pure group commit: the kill at
    the second group fsync reopens at height 8, as serially."""
    d, res = _run_child(tmp_path, 12, 2, "windowed", f"ledger.fsync.{hook}:crash:after=1")
    assert res.returncode == 86, (res.stdout, res.stderr)
    _reopen_and_verify(tmp_path, d, expect_height=8, indexed_txids=7)


def test_pipelined_per_block_sync_keeps_each_commit_durable(tmp_path):
    """Depth 2 with a sync after every commit: the crash at the second
    sync leaves blocks 0 and 1."""
    d, res = _run_child(tmp_path, 12, 2, "honor", "ledger.fsync.before:crash:after=1")
    assert res.returncode == 86, (res.stdout, res.stderr)
    _reopen_and_verify(tmp_path, d, expect_height=2)


@pytest.mark.parametrize("depth", [0, 2])
def test_no_fault_child_is_clean(tmp_path, depth):
    d, res = _run_child(tmp_path, 12, depth, "windowed", "")
    assert res.returncode == 0, (res.stdout, res.stderr)
    assert "HEIGHT 12" in res.stdout
    _reopen_and_verify(tmp_path, d, expect_height=12)
