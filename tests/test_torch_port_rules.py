"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
it never drops quietly to the CPU, and its kernel wrappers import (and
run their plain versions) on a machine without a CUDA toolkit."""

import ast
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from gossip_glomers_tpu_torch.parallel.topology import (to_padded_neighbors,
                                                        tree)
from gossip_glomers_tpu_torch.tpu_sim import (broadcast, faults, kafka,
                                              kernels, structured)
from gossip_glomers_tpu_torch.tpu_sim import timing

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "gossip_glomers_tpu"}
PORT_FILES = sorted((ROOT / "gossip_glomers_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    # exact top-level names: gossip_glomers_tpu_torch itself is allowed
    assert not _top_level_imports(path) & FORBIDDEN


HOST_COPIES = [(structured, "fault_dir_senders"), (structured, "fault_masks"),
               (structured, "nemesis_dir_pairs"),
               (structured, "_same_groups"), (faults, "crash_down_rows")]


@pytest.mark.parametrize("module,name", HOST_COPIES,
                         ids=[name for _, name in HOST_COPIES])
def test_host_only_copies_are_the_ports_own(module, name):
    # the host numpy contracts of the structured fault bundles are the
    # port's own copies (defined in its modules, not imported), equal to
    # the reference's on a ragged tree and a ragged grid
    from gossip_glomers_tpu.tpu_sim import faults as jf
    from gossip_glomers_tpu.tpu_sim import structured as jst

    fn = getattr(module, name)
    assert fn.__module__ == module.__name__
    want_mod = {structured: jst, faults: jf}[module]
    for topo, n in (("tree", 85), ("grid", 60)):
        src, dst, _ = jst.nemesis_dir_pairs(topo, n)
        groups = np.random.default_rng(n).integers(0, 2, (2, n))
        if name == "crash_down_rows":
            kw = dict(n_nodes=n, crash=((1, 3, (0, 7, n - 1)),))
            got = fn(faults.NemesisSpec(**kw), src)
            want = jf.crash_down_rows(jf.NemesisSpec(**kw), src)
        else:
            args = {"fault_dir_senders": (topo, n),
                    "fault_masks": (topo, n, groups),
                    "nemesis_dir_pairs": (topo, n),
                    "_same_groups": (groups, src, dst, n)}[name]
            got, want = fn(*args), getattr(want_mod, name)(*args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(g, w)


HARNESS_COPIES = ["TimelineBuilder", "check_txn_serializable",
                  "write_json_atomic", "validate_timeline",
                  "check_recovery_batch", "check_slo"]


@pytest.mark.parametrize("name", HARNESS_COPIES)
def test_harness_host_copies_are_the_ports_own(name, tmp_path):
    # the flight recorder's serializer and the txn checker are the port's
    # own copies (defined in its modules, not imported), equal to the
    # reference's on the same inputs
    from gossip_glomers_tpu.harness import checkers as jc
    from gossip_glomers_tpu.harness import observe as jo
    from gossip_glomers_tpu_torch.harness import checkers as pc
    from gossip_glomers_tpu_torch.harness import observe as po

    checker = name.startswith("check_")
    port_mod = pc if checker else po
    ref_mod = jc if checker else jo
    fn = getattr(port_mod, name)
    assert fn.__module__ == port_mod.__name__
    if name == "check_recovery_batch":
        kw = dict(clear_rounds=np.array([4, 4, 6, 2]),
                  converged_rounds=np.array([6, -1, 20, 2]),
                  max_recovery_rounds=8, lost_writes=[[], [], [7], [1, 2]],
                  msgs_at_clear=np.array([100, 100, 90, 5]),
                  msgs_at_converged=np.array([120, 100, 140, 5]))
        assert fn(**kw) == jc.check_recovery_batch(**kw)
        with pytest.raises(ValueError, match="batch shape mismatch"):
            fn(**dict(kw, lost_writes=[[]]))
    elif name == "check_slo":
        row = {"cell": 2, "coords": [0, 1, 1], "completed": 3,
               "conserved": False, "lat_p50": 1.0, "lat_p99": 7.0,
               "lat_max": 9, "sustained_per_round": 0.2,
               "converged_round": None, "recovery_rounds": 12}
        for kw in ({}, {"p99_max_rounds": 5, "max_rounds": 8,
                        "min_sustained": 0.5, "max_recovery_rounds": 4},
                   {"min_completed": 4, "coords": (3,)}):
            assert fn(row, **kw) == jc.check_slo(row, **kw)
    elif name == "TimelineBuilder":
        got, want = fn("x"), jo.TimelineBuilder("x")
        for b in (got, want):
            b.slice("r", "round 0", 0, 1000)
            b.flow("v0", "node 0", 500, "node 1", 1500, args={"value": 0})
            b.counter("telemetry", "msgs", 0, 3)
        assert got.to_dict() == want.to_dict()
    elif name == "check_txn_serializable":
        hist = [{"id": i, "node": i, "slot": 0, "status": "committed",
                 "issue_round": 0, "commit_round": c,
                 "ops": [{"kind": k, "key": 0, "ver": v, "val": val}]}
                for i, (c, k, v, val) in enumerate(
                    ((1, "w", 1, 5), (2, "r", 1, 5), (3, "w", 1, 6),
                     (0, "r", 0, 0)))]
        for final in (None, {0: (6, 1)}, {0: (0, 0)}):
            assert fn(hist, final=final) == \
                jc.check_txn_serializable(hist, final=final)
    elif name == "write_json_atomic":
        payload = {"b": [1, 2], "a": {"c": None}}
        p = fn(str(tmp_path / "p" / "x.json"), payload)
        q = jo.write_json_atomic(str(tmp_path / "q" / "x.json"), payload)
        assert open(p).read() == open(q).read()
    else:
        tb = jo.TimelineBuilder("t")
        tb.flow("v", "a", 5.0, "a", 1.0)
        for f in (fn, ref_mod.validate_timeline):
            with pytest.raises(ValueError, match="causality"):
                f(tb.to_dict())


@pytest.mark.parametrize("n", [1, 2, 5, 33])
def test_full_topology_is_the_ports_own(n):
    # the complete graph the broadcast resize campaigns run on: the
    # port's own copy (defined in its module), equal to the reference's
    from gossip_glomers_tpu.parallel import topology as jtop
    from gossip_glomers_tpu_torch.parallel import topology as ptop

    assert ptop.full.__module__ == ptop.__name__
    assert ptop.full(n) == jtop.full(n)
    np.testing.assert_array_equal(to_padded_neighbors(ptop.full(n)),
                                  jtop.to_padded_neighbors(jtop.full(n)))


def test_import_scan_compares_exact_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import gossip_glomers_tpu_torch.tpu_sim\n"
                 "from jax import numpy\n"
                 "from gossip_glomers_tpu.tpu_sim import timing\n")
    assert _top_level_imports(f) & FORBIDDEN == FORBIDDEN


def test_no_silent_cpu_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nbrs = to_padded_neighbors(tree(8))
    with pytest.raises(RuntimeError, match="CUDA"):
        broadcast.BroadcastSim(nbrs, n_values=4,
                               exchange=structured.make_exchange("tree", 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        timing.structured_sim("tree", 8, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        broadcast.BroadcastSim(nbrs, n_values=4)        # the gather path


def test_unported_modes_raise():
    nbrs = to_padded_neighbors(tree(8))
    ex = structured.make_exchange("tree", 8)
    # the node-major gather path (exchange=None) constructs, under a
    # fault plan and slab blocking too; on the structured path a
    # partition schedule needs its faulted= bundle and a fault plan its
    # nemesis= bundle, as in the reference
    assert not broadcast.BroadcastSim(nbrs, n_values=4,
                                      device="cpu").words_major
    spec = faults.NemesisSpec(n_nodes=8, crash=((1, 3, (2,)),),
                              loss_rate=0.1)
    plan = spec.compile(device="cpu")
    for kw in ({"fault_plan": plan}, {"union_block": 4},
               {"fault_plan": plan, "union_block": 4, "srv_ledger": False}):
        sim = broadcast.BroadcastSim(nbrs, n_values=4, device="cpu", **kw)
        assert not sim.words_major
        assert sim._ub == (4 if "srv_ledger" in kw else None)
    group = np.zeros((1, 8), np.int8)
    parts = broadcast.Partitions.from_numpy(np.array([1]), np.array([3]),
                                            group)
    with pytest.raises(ValueError, match="faulted=structured.make_faulted"):
        broadcast.BroadcastSim(nbrs, n_values=4, exchange=ex, device="cpu",
                               parts=parts)
    with pytest.raises(ValueError, match="nemesis=structured.make_nemesis"):
        broadcast.BroadcastSim(nbrs, n_values=4, exchange=ex, device="cpu",
                               fault_plan=plan)
    for kw in ({"parts": parts,
                "faulted": structured.make_faulted("tree", 8, group)},
               {"fault_plan": plan, "nemesis": structured.make_nemesis(
                   "tree", 8, spec, device="cpu")}):
        assert broadcast.BroadcastSim(nbrs, n_values=4, exchange=ex,
                                      device="cpu", **kw).words_major
    for mode in ("mesh", "dcn_mode", "sharded_exchange",
                 "sharded_sync_diff"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            broadcast.BroadcastSim(nbrs, n_values=4, exchange=ex,
                                   device="cpu", **{mode: object()})
    # the delay modes run: per-edge delays on the gather path, the delay
    # bundles on the structured path
    assert broadcast.BroadcastSim(
        nbrs, n_values=4, device="cpu",
        delays=np.full(nbrs.shape, 2, np.int32)).ring == 2
    for kw in ({"delayed": structured.make_delayed("tree", 8, (1, 3))},
               {"edge_delayed": structured.make_edge_delayed(
                   "tree", 8, np.full((2, 8), 2, np.int32))}):
        assert broadcast.BroadcastSim(nbrs, n_values=4, exchange=ex,
                                      device="cpu", **kw).words_major
    # the reference's own refusal: slab blocking is the gather path's
    with pytest.raises(ValueError, match="gather-free"):
        broadcast.BroadcastSim(nbrs, n_values=4, exchange=ex, device="cpu",
                               union_block=object())
    # an explicit None is the reference's default and is accepted
    broadcast.BroadcastSim(nbrs, n_values=4, exchange=ex, device="cpu",
                           mesh=None)
    with pytest.raises(TypeError):
        broadcast.BroadcastSim(nbrs, n_values=4, exchange=ex, device="cpu",
                               no_such_mode=None)
    sim = broadcast.BroadcastSim(nbrs, n_values=4, exchange=ex,
                                 device="cpu", srv_ledger=False)
    state, _ = sim.stage(broadcast.make_inject(8, 4))
    with pytest.raises(ValueError, match="ledger is off"):
        sim.server_msgs(state)
    # txn-rw-register runs on one device; its meshes (item 10) and audit
    # (item 14) raise, as does a replay on a mesh (item 10); the scenario
    # batches run, and raise on a mesh (item 10) and for their program
    # audit (item 14); so do the frontier, the fuzzer and the membership
    # layer
    from gossip_glomers_tpu_torch.harness import frontier, fuzz, observe
    from gossip_glomers_tpu_torch.harness import txn as htxn
    from gossip_glomers_tpu_torch.tpu_sim import membership, scenario, txn

    tsim = txn.TxnSim(8, 4, device="cpu")
    sbatch = scenario.ScenarioBatch(workload="counter", scenarios=(
        faults.NemesisSpec(n_nodes=4),))
    cells = (scenario.ServingCell(traffic=scenario.traffic.TrafficSpec(
        n_nodes=4, n_clients=4, ops_per_client=1, until=2)),)
    for fn, item in (
            (lambda: txn.TxnSim(8, 4, device="cpu", mesh=object()), 10),
            (lambda: txn.TxnSim(8, 4, device="cpu", dcn_mode="sync"), 10),
            (txn.ops_specs, 10), (lambda: tsim._state_spec, 10),
            (lambda: scenario.run_scenario_batch(sbatch, mesh=object(),
                                                 device="cpu"), 10),
            (lambda: scenario.dispatch_serving_batch(
                scenario.ServingBatch(workload="counter", cells=cells),
                mesh=object(), device="cpu"), 10),
            (lambda: htxn.run_txn_frontier([0.5], [], mesh=object(),
                                           device="cpu"), 10),
            (scenario.audit_contracts, 14),
            (lambda: scenario._audit_program("counter", sbatch, None), 14),
            (lambda: tsim.audit_run_program, 14), (txn.audit_contracts, 14),
            (lambda: frontier.run_frontier("counter", cells, mesh=object(),
                                           device="cpu"), 10),
            (lambda: fuzz.fuzz_run("counter", 1, mesh=object(),
                                   device="cpu"), 10),
            (membership.audit_contracts, 14),
            (lambda: observe.replay_bundle({}, mesh=object()), 10)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            fn()
    assert tsim.run(tsim.init_state(), 3).t == 3
    state = tsim.init_state()
    assert txn._build_batch_round(tsim)(state).t == 1
    assert bool(txn._batch_converged(state)) == bool(
        (state.cur >= state.arrived).all())
    assert htxn.run_txn_frontier([0.5], [faults.NemesisSpec(n_nodes=4)],
                                 until=4, device="cpu")["n_cells"] == 1
    # the frontier's report check and the resize intake gate run
    with pytest.raises(ValueError, match="frontier schema"):
        observe.validate_frontier({})
    assert frontier.run_frontier("counter", cells, device="cpu",
                                 max_recovery_rounds=4)["n_cells"] == 1


def test_kafka_unported_parts_raise_with_their_items():
    # meshes and dcn_mode (item 10) and the audit (item 14); the traffic
    # driver, its telemetry ring, the observed driver with its provenance
    # record and the scenario batch hooks are ported
    for kw in ({"mesh": object()}, {"dcn_mode": "sync"}):
        with pytest.raises(NotImplementedError, match="item 10"):
            kafka.KafkaSim(4, 2, 8, device="cpu", **kw)
    sim = kafka.KafkaSim(4, 2, 8, device="cpu")
    for name, item in (("audit_observed_program", 14),
                       ("audit_traffic_program", 14)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            getattr(sim, name)
    for name in ("run_traffic", "traffic_state", "telemetry_state",
                 "run_observed", "provenance_state"):
        assert callable(getattr(sim, name))
    with pytest.raises(AttributeError):
        sim.no_such_method
    for fn, item in ((kafka.audit_contracts, 14),):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            fn()
    # the scenario batches' hooks run: one commit-free round in place
    st, _ = kafka._build_batch_round(sim)(
        sim.init_state(), torch.full((4, sim.max_sends), -1,
                                     dtype=torch.int32),
        torch.zeros((4, sim.max_sends), dtype=torch.int32))
    assert st.t == 1 and bool(kafka._batch_converged(st))


def test_kafka_runs_on_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        kafka.KafkaSim(4, 2, 8)
    assert kafka.KafkaSim(4, 2, 8, device="cpu").init_state().present \
        .device.type == "cpu"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_device_ms_counts_only_the_named_kernel():
    # a sync_diff_pc call launches a zero fill, the kernel, a cast and a
    # mask: its device time is the kernel's span alone, not the mean of
    # the four
    smoke = _chip_smoke()
    spans = [
        {"name": "void at::native::vectorized_elementwise_kernel<4, "
                 "at::native::FillFunctor<int>>(int, ...)", "us": 2.0},
        {"name": "void (anonymous namespace)::sync_diff_pc_kernel<false, 8>"
                 "((anonymous namespace)::Args, (anonymous namespace)::Plan)",
         "us": 70.0},
        {"name": "void at::native::unrolled_elementwise_kernel<copy>", "us": 3.0},
        {"name": "void at::native::vectorized_elementwise_kernel<"
                 "BitwiseAndFunctor>", "us": 1.0}]
    assert smoke.kernel_ms(spans, "sync_diff_pc_kernel") == pytest.approx(
        0.070, abs=1e-12)
    assert smoke.kernel_ms(spans * 3, "sync_diff_pc_kernel") == \
        pytest.approx(0.070, abs=1e-12)
    # whole names: col_popcount_kernel is not col_popcount_nm_kernel
    pcs = [{"name": "(anonymous namespace)::col_popcount_nm_kernel(...)",
            "us": 4.0},
           {"name": "(anonymous namespace)::col_popcount_kernel(...)",
            "us": 9.0}]
    assert smoke.kernel_ms(pcs, "col_popcount_kernel") == pytest.approx(
        0.009, abs=1e-12)
    with pytest.raises(AssertionError, match="no device span"):
        smoke.kernel_ms(spans, "gather_or_kernel")
    # every kernel the smoke times names its own __global__, and the
    # profile check's pattern knows it
    for name, (source, _, glob) in smoke.KERNELS.items():
        assert name in kernels.LAUNCHES
        assert glob in (ROOT / "gossip_glomers_tpu_torch" / "csrc"
                        / source).read_text()
        assert smoke.PORT_KERNEL.search(f"void {glob}<true>(int)")
    assert set(smoke.KERNELS) == set(kernels.LAUNCHES)


def test_wrappers_import_and_run_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", "")
    mod = importlib.reload(kernels)
    assert mod._lib_handles == {}           # nothing built at import
    x = torch.from_numpy(np.arange(12, dtype=np.int32).reshape(3, 4))
    assert torch.equal(mod.col_popcount(x), mod.col_popcount_plain(x))
    # a CUDA call would build first; without a toolkit that raises
    monkeypatch.setattr(mod, "_find_nvcc", lambda: None)
    monkeypatch.setattr(mod, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        mod.build()
