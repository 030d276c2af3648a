"""txn-rw-register nemesis campaigns on PyTorch: the port of
gossip_glomers_tpu/harness/txn.py — drive :mod:`..tpu_sim.txn`'s
wound-or-die rounds under a seeded crash / loss
:class:`..tpu_sim.faults.NemesisSpec`, then certify recovery (bounded
convergence, no lost acknowledged commit: :func:`.checkers.check_recovery`)
and serializability (:func:`.checkers.check_txn_serializable`, the host
cycle check over the recorded read / write version graph).

The faulted phase runs in place to the clear round, the recovery round by
round (one host read of the convergence flag a round); a failed campaign
writes its flight bundle (:mod:`.observe`), which
:func:`.observe.replay_bundle` replays from its JSON alone, diffing the
per-transaction stamps for the first-divergence round.  The stamps ride
in the state (``issue_round``, ``commit_round``), so every run records
them.  Runs go on ``device`` (CUDA unless given).  ``run_txn_frontier``
certifies a (rate x nemesis) grid over scenario batches.  Not ported yet,
and raising: ``mesh=`` (ROADMAP.md Queue A item 10).
"""

from __future__ import annotations

import torch

from ..tpu_sim import txn as TX
from ..tpu_sim.engine import resolve_device
from ..tpu_sim.faults import NemesisSpec
from .checkers import check_recovery, check_txn_serializable


def txn_provenance_arrays(state: "TX.TxnState") -> dict:
    """The per-transaction causal record as plain int lists: the flight
    bundle's stamp payload, both fields round-valued."""
    return {
        "issue_round": state.issue_round.cpu().numpy().tolist(),
        "commit_round": state.commit_round.cpu().numpy().tolist(),
    }


def run_txn_nemesis(spec: NemesisSpec, *, n_keys: int = 8,
                    txns_per_node: int = 4, ops_per_txn: int = 2,
                    rate: float = 0.5, until: int | None = None,
                    workload_seed: int = 0,
                    max_recovery_rounds: int = 48,
                    kv_amnesia: bool = False,
                    mesh=None, telemetry=None, observe_dir=None,
                    device: str | torch.device | None = None) -> dict:
    """Transactions under the nemesis (the reference's arguments and
    result): every node's client offers ``txns_per_node`` multi-key
    transactions on the seeded arrival schedule; convergence is every
    offered transaction committed, checked once arrivals close at
    ``tspec.until`` and the faults clear.  The verdict ANDs
    ``check_recovery`` and ``check_txn_serializable`` over the history
    with the final registers as its anchor; ``kv_amnesia=True`` must fail
    it with named lost updates.  ``telemetry`` must be falsy: this
    workload records per-transaction stamps, not a telemetry series.
    ``observe_dir``: where a failed campaign writes its flight bundle."""
    from . import observe

    if telemetry:
        raise ValueError("txn workload records per-transaction "
                         "stamps, not telemetry series")
    dev = resolve_device(device)
    n = spec.n_nodes
    sim = TX.TxnSim(
        n, n_keys, txns_per_node=txns_per_node,
        ops_per_txn=ops_per_txn, rate=rate, until=until, mesh=mesh,
        workload_seed=workload_seed, fault_plan=spec.compile(device=dev),
        kv_amnesia=kv_amnesia, device=dev)
    # convergence means something only once both the fault horizon and
    # the arrival horizon have passed
    clear = max(spec.clear_round, int(sim.tspec.until))
    state = sim.init_state()
    if clear > 0:
        state = sim.run_fused(state, clear)
    msgs_at_clear = int(state.msgs)

    def converged(s) -> bool:
        return bool((s.cur >= s.arrived).all())

    converged_round = clear if converged(state) else None
    while converged_round is None \
            and state.t < clear + max_recovery_rounds:
        state = sim.run_fused(state, 1)
        if converged(state):
            converged_round = state.t

    history = TX.history_of(state, sim.ops)
    final = TX.final_registers(state, sim.layout)
    ok_ser, ser_det = check_txn_serializable(history, final=final)
    lost = [p for p in ser_det["problems"]
            if p["kind"] in ("lost-update", "lost-acked-commit")]
    open_txns = [h["id"] for h in history if h["status"] == "open"]
    ok, details = check_recovery(
        clear_round=clear, converged_round=converged_round,
        max_recovery_rounds=max_recovery_rounds, lost_writes=lost,
        msgs_at_clear=msgs_at_clear, msgs_at_converged=int(state.msgs))
    ok = ok and ok_ser
    prov = txn_provenance_arrays(state)
    details.update(
        workload="txn", n_nodes=n, n_keys=n_keys,
        n_txns=len(history),
        n_committed=ser_det["n_committed"],
        open_txns=open_txns[:10],
        serializable=ok_ser, serializability=ser_det,
        final_registers={str(k): list(v) for k, v in final.items()},
        msgs_total=int(state.msgs), spec=spec.to_meta(),
        provenance={"arrays": prov,
                    "check": {"ok": ok_ser,
                              "by_kind": ser_det["by_kind"]}})
    runner_kw = dict(n_keys=n_keys, txns_per_node=txns_per_node,
                     ops_per_txn=ops_per_txn, rate=rate, until=until,
                     workload_seed=workload_seed,
                     max_recovery_rounds=max_recovery_rounds,
                     kv_amnesia=kv_amnesia)
    if not ok and observe_dir is not None:
        bundle_path = observe.write_flight_bundle(
            observe_dir, kind="nemesis", workload="txn",
            nemesis=spec.to_meta(), runner_kw=runner_kw,
            provenance=prov,
            failure={"converged_round": converged_round,
                     "n_lost_writes": len(lost),
                     "by_kind": ser_det["by_kind"]})
        details["flight_bundle"] = bundle_path
    return {"ok": ok, **details}


def run_txn_frontier(rates, specs, *, n_keys: int = 8,
                     txns_per_node: int = 4, ops_per_txn: int = 2,
                     until: int = 16, max_recovery_rounds: int = 48,
                     mesh=None, slo: dict | None = None,
                     device: str | torch.device | None = None) -> dict:
    """The txn serving-frontier grid (the reference's arguments and
    result): (offered rate x nemesis) cells, each rate's nemesis column
    one scenario batch (:func:`..tpu_sim.scenario.run_txn_batch`).  A
    cell's row carries the recovery verdict and the transaction SLO
    surface of the recorded stamps: commit-latency percentiles
    (``commit_round - issue_round + 1`` over committed transactions, in
    rounds) and committed throughput (transactions a round to
    convergence).  ``slo``: optional ``{"p99_max_rounds",
    "max_recovery_rounds"}`` bounds ANDed into each cell's ``slo_ok``.
    ``mesh=`` raises (ROADMAP.md Queue A item 10)."""
    import numpy as np

    from ..tpu_sim import scenario as SC

    if mesh is not None:
        raise NotImplementedError("run_txn_frontier(mesh=...) is not "
                                  "ported to PyTorch yet (ROADMAP.md "
                                  "Queue A item 10)")
    rows = []
    ok_all = True
    for rate in rates:
        batch = SC.ScenarioBatch(
            workload="txn",
            scenarios=tuple(SC.Scenario(spec=sp, workload_seed=sp.seed)
                            for sp in specs),
            runner_kw=dict(n_keys=n_keys, txns_per_node=txns_per_node,
                           ops_per_txn=ops_per_txn, rate=float(rate),
                           until=until),
            max_recovery_rounds=max_recovery_rounds)
        res = SC.run_txn_batch(batch, device=device)
        final = res["final"]
        for i, row in enumerate(res["scenarios"]):
            ir = final.issue_round[i].cpu().numpy()
            cr = final.commit_round[i].cpu().numpy()
            done = cr >= 0
            lat = (cr - ir)[done] + 1
            cell = dict(rate=float(rate), spec=i, ok=bool(row["ok"]),
                        converged_round=row["converged_round"],
                        recovery_rounds=row["recovery_rounds"],
                        n_committed=int(done.sum()),
                        msgs_total=row["msgs_total"])
            if lat.size:
                cell["lat_p50"] = float(np.percentile(lat, 50))
                cell["lat_p99"] = float(np.percentile(lat, 99))
                cell["lat_max"] = int(lat.max())
                conv = row["converged_round"]
                if conv:
                    cell["committed_per_round"] = round(
                        float(done.sum()) / conv, 4)
            if slo is not None:
                s_ok = cell["ok"]
                if "p99_max_rounds" in slo and lat.size:
                    s_ok = s_ok and (cell["lat_p99"]
                                     <= slo["p99_max_rounds"])
                if "max_recovery_rounds" in slo \
                        and row["recovery_rounds"] is not None:
                    s_ok = s_ok and (row["recovery_rounds"]
                                     <= slo["max_recovery_rounds"])
                cell["slo_ok"] = bool(s_ok)
                ok_all = ok_all and s_ok
            else:
                ok_all = ok_all and cell["ok"]
            rows.append(cell)
    return {"ok": bool(ok_all), "workload": "txn",
            "n_cells": len(rows), "rates": [float(r) for r in rates],
            "n_specs": len(specs), "slo": slo, "cells": rows}
