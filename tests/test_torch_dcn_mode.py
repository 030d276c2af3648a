"""``dcn_mode`` without a world: the mode grammar, the env knobs, the
staleness carry (:class:`DcnRound`), the half-block split, the
bounded-staleness certificate and the batches' stale refusal, each held
against the JAX package's on the same inputs (tests/test_dcn_pr20.py's
units), and the mesh helpers off a mesh."""

import numpy as np
import pytest
import torch

from gossip_glomers_tpu.harness import checkers as jchk
from gossip_glomers_tpu.tpu_sim import engine as je
from gossip_glomers_tpu_torch.harness.checkers import check_staleness_bound
from gossip_glomers_tpu_torch.parallel import mesh as pmesh
from gossip_glomers_tpu_torch.tpu_sim import engine, scenario
from gossip_glomers_tpu_torch.tpu_sim.engine import (
    DCN_SYNC, DcnMode, DcnRound, dcn_mode_from_env, resolve_dcn_mode)

MODES = ("sync", "pipelined", "stale:3", "pipelined+stale:2", "stale:0",
         "sync+pipelined", "stale:1+pipelined")
BAD = ("fast", "stale:x", "stale:-1", "pipelined+", "")


@pytest.mark.parametrize("setting", MODES)
def test_mode_grammar_equals_the_reference(setting):
    got, want = resolve_dcn_mode(setting), je.resolve_dcn_mode(setting)
    assert (got.pipeline, got.stale_k) == (want.pipeline, want.stale_k)
    assert got.label() == want.label()
    # the label round-trips through the grammar (what runner_kw records)
    assert resolve_dcn_mode(got.label()) == got


@pytest.mark.parametrize("setting", BAD)
def test_bad_modes_refuse_as_the_reference(setting):
    with pytest.raises(ValueError) as got:
        resolve_dcn_mode(setting)
    with pytest.raises(ValueError) as want:
        je.resolve_dcn_mode(setting)
    assert str(got.value) == str(want.value)


def test_mode_objects_and_types():
    assert DCN_SYNC.label() == "sync"
    assert resolve_dcn_mode(DcnMode(pipeline=True)) == DcnMode(True, 0)
    with pytest.raises(ValueError, match=">= 0"):
        resolve_dcn_mode(DcnMode(stale_k=-1))
    with pytest.raises(ValueError, match="DcnMode"):
        resolve_dcn_mode(3)


ENVS = ({}, {"GG_DCN_PIPELINE": "1"}, {"GG_DCN_STALE_K": "3"},
        {"GG_DCN_PIPELINE": "1", "GG_DCN_STALE_K": "2"},
        {"GG_DCN_PIPELINE": "yes"}, {"GG_DCN_PIPELINE": "2"},
        {"GG_DCN_STALE_K": "-1"}, {"GG_DCN_STALE_K": "x"})


@pytest.mark.parametrize("env", ENVS)
def test_env_knobs_equal_the_reference(monkeypatch, env):
    monkeypatch.delenv("GG_DCN_PIPELINE", raising=False)
    monkeypatch.delenv("GG_DCN_STALE_K", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        want = je.dcn_mode_from_env()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            dcn_mode_from_env()
        assert str(got.value) == str(e)
        # a None setting defers to the env, loudly too
        with pytest.raises(ValueError, match="GG_DCN"):
            resolve_dcn_mode(None)
        return
    got = dcn_mode_from_env()
    assert (got.pipeline, got.stale_k) == (want.pipeline, want.stale_k)
    assert resolve_dcn_mode(None) == got


@pytest.mark.parametrize("shape", [(8,), (7,), (3, 5), (2, 2, 2)])
def test_half_blocks_join_back(shape):
    x = torch.arange(int(np.prod(shape)), dtype=torch.int32).reshape(shape)
    (a, b), join = engine._dcn_chunks(x)
    want = je._dcn_chunks(np.arange(int(np.prod(shape)), dtype=np.int32
                                    ).reshape(shape))[0]
    assert (a.numel(), b.numel()) == (want[0].size, want[1].size)
    assert torch.equal(join([a, b]), x)


def test_scalars_decline_the_split():
    assert engine._dcn_chunks(torch.tensor(3)) is None
    assert engine._dcn_chunks(torch.zeros(1, dtype=torch.int32)) is None
    assert engine._dcn_pipelineable(torch.zeros(2, dtype=torch.bool))
    assert engine._dcn_pipelineable(torch.zeros(2, dtype=torch.int64))
    assert not engine._dcn_pipelineable(torch.zeros(2))


def test_dcn_round_carry_contracts():
    with pytest.raises(ValueError, match="age"):
        DcnRound("stale:2")
    ctx = DcnRound("stale:2", age=0, carry=())
    with pytest.raises(ValueError, match="carry exhausted"):
        ctx._take(torch.zeros(4, dtype=torch.int32))
    ctx2 = DcnRound("stale:2", age=0,
                    carry=(torch.zeros(4, dtype=torch.int32),))
    with pytest.raises(ValueError, match="carry mismatch"):
        ctx2.carry_out()
    # a carry of unknown layout (None) learns it from the first takes:
    # zeros shaped like each operand, in take order
    learn = DcnRound("stale:3", age=1, carry=None)
    assert not learn.refresh
    slot = learn._take(torch.ones((2, 3), dtype=torch.int64))
    assert torch.equal(slot, torch.zeros((2, 3), dtype=torch.int64))
    learn._put(slot + 1)
    assert [tuple(s.shape) for s in learn.carry_out()] == [(2, 3)]
    assert DcnRound("stale:3", age=3).refresh
    assert DcnRound("sync").refresh


STALENESS = (
    dict(stale_k=4, sync_converged_round=5, stale_converged_round=7,
         lost_writes=[]),
    dict(stale_k=1, sync_converged_round=5, stale_converged_round=7,
         lost_writes=[]),
    dict(stale_k=4, sync_converged_round=5, stale_converged_round=None,
         lost_writes=[]),
    dict(stale_k=4, sync_converged_round=5, stale_converged_round=6,
         lost_writes=[{"lost_sum": 3}]),
    dict(stale_k=4, sync_converged_round=None, stale_converged_round=9,
         lost_writes=[]),
    dict(stale_k=4, sync_converged_round=5, stale_converged_round=6,
         lost_writes=[], recovery=(False, {"why": "x"})),
    dict(stale_k=0, sync_converged_round=3, stale_converged_round=3,
         lost_writes=[], recovery=(True, {})))


@pytest.mark.parametrize("kw", STALENESS)
def test_staleness_bound_equals_the_reference(kw):
    assert check_staleness_bound(**kw) == jchk.check_staleness_bound(**kw)


def test_staleness_bound_falsifiable():
    ok, d = check_staleness_bound(stale_k=1, sync_converged_round=5,
                                  stale_converged_round=7, lost_writes=[])
    assert not ok and d["bound_round"] == 6 and d["violating_round"] == 7
    with pytest.raises(ValueError, match=">= 0"):
        check_staleness_bound(stale_k=-1, sync_converged_round=1,
                              stale_converged_round=1, lost_writes=[])


def test_batches_refuse_a_stale_mode(monkeypatch):
    with pytest.raises(ValueError, match="scenario batch"):
        scenario._refuse_stale_dcn("a scenario batch",
                                   {"dcn_mode": "stale:2"})
    scenario._refuse_stale_dcn("a scenario batch",
                               {"dcn_mode": "pipelined"})
    monkeypatch.setenv("GG_DCN_STALE_K", "2")
    with pytest.raises(ValueError, match="GG_DCN_STALE_K"):
        scenario._refuse_stale_dcn("a serving batch")


def test_off_a_mesh():
    assert engine.node_shards(None) == 1 and engine.node_index(None) == 0
    assert engine.word_shards(None) == 1 and engine.word_index(None) == 0
    assert engine.node_axes(None) == "nodes"
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        engine.node_shards(object())
    # off a mesh the collectives are the identity whatever the mode, as
    # in the reference, and the mode-aware sum is too
    c = engine.collectives(4, device="cpu", dcn=DcnMode(pipeline=True))
    x = torch.arange(4)
    assert torch.equal(c.reduce_sum(x), x) and c.axis_name is None
    assert torch.equal(engine.dcn_psum(None, "pipelined")(x), x)
    with pytest.raises(ValueError, match="refuses"):
        engine.dcn_psum(None, "stale:2")
    assert pmesh.pick_mesh_2d(hosts=2) is None
    assert pmesh.pick_mesh(axis_name="words") is None
    with pytest.raises(ValueError, match="'nodes' or 'words'"):
        pmesh.pick_mesh(axis_name="hosts")
    with pytest.raises(ValueError, match="initialized process group"):
        pmesh.make_mesh((2, 2), ("nodes", "words"))
    with pytest.raises(ValueError, match="one process is one shard"):
        pmesh.force_virtual_devices(8)


def test_mesh_subgroups_are_row_major():
    dims = {"hosts": 2, "nodes": 3}
    assert pmesh._subgroups(dims, ("nodes",)) == [[0, 1, 2], [3, 4, 5]]
    assert pmesh._subgroups(dims, ("hosts",)) == [[0, 3], [1, 4], [2, 5]]
    assert pmesh._subgroups(dims, ("hosts", "nodes")) == [list(range(6))]
    assert pmesh._axis_sets(("hosts", "nodes")) == [
        ("hosts",), ("nodes",), ("hosts", "nodes")]
    assert pmesh._axis_sets(("nodes", "words")) == [
        ("nodes",), ("words",), ("nodes", "words")]
