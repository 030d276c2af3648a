#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (gossip_glomers_tpu_torch) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and the CUDA toolkit (``nvcc``); it builds the port's kernels
from ``gossip_glomers_tpu_torch/csrc/`` into ``build/`` (one ``nvcc`` per
source, all started together) and drives the main path, the broadcast
flood at 1,048,576 nodes, on every topology the port runs, then the
g-counter, unique ids, echo, Kafka, serving, the nemesis campaigns,
txn-rw-register, the flight recorder, the scenario batches, checkpoints,
elastic resizing, the serving frontier and the fuzzer (checkpoints,
bundles and repros under ``build/chip_smoke/``):

1. ``build``: nvcc build of the kernels, with its seconds.
2. ``kernel_check``: each kernel against its plain PyTorch version on the
   card, bit for bit (tolerance 0: bitsets and counts), at small shapes
   and at the main path's shapes — the shift kernels in every mode
   (circulant, ring, line, grid with a ragged last row), also at rows one
   node short of, at, one over and two and a bit times their tile, and
   on views that start 4 bytes into their allocation; the gather
   kernels (``gather_or``, the fused ``gather_flood_round``,
   ``sync_diff_pc``) with and without an edge mask over -1-padded
   tables, at their block edges, at degrees 1, 3 and 8, with more and
   fewer payload rows than nodes and on 4-byte-offset views of every
   operand; the fault kernels (``fault_coins``, ``faulted_gather_round``)
   with every loss/dup stream combination, with and without a partition
   mask, on whole tables and on slabs of rows off the block grid, on
   4-byte-offset views, at the same edges and at (2^20, 1) and (2^20,
   128); the masked structured exchanges (``tree_masked_exchange``,
   ``shift_masked_exchange`` in every shift mode) under all-live,
   none-live and random packed rows, on 4-byte-offset views, at the small
   shapes, the shift kernels' tile edges, (1, 2^20) and (128, 2^20); the
   words-major coins (``wm_fault_coins``, every stream and the ledger
   mode) on every structured topology's id descriptors (the tree at
   branchings 1, 2, 3, 4 and 32 in both contracts, a ragged grid, ring,
   line, circulant) at every n of those shapes and at 4 x 1,027, and
   in the block form a mesh rank launches (each rank's block of 2 and 4
   shards, ``col0``, the global ``n_ids``) against the whole row's
   coins cut to the block; ``tree_exchange`` also
   at n % 4 in {0, 1, 2, 3}, k = 4 and 3, W = 1 and 128, on 4-byte-offset
   views; the ring kernels (``tree_ring_exchange``,
   ``shift_ring_exchange``) on random 3-slot rings and rows, over every
   table shape the delay modes build (the tree's, every shift mode's as
   two delay classes and up to 24 rows, rows dropped), at the small
   shapes, n % 4 in {0, 1, 2, 3} (the tree's four nodes a thread and a
   node a thread), the main shapes and 4-byte-offset views; the counter
   round's kernels (``counter_select``, ``counter_apply``) at 1, 31,
   2^20 + 3 and 2^24 nodes in every layout (cas packed and wide,
   allreduce), with and without the gate byte, on poll and other
   rounds, with and without the stale coin, on 4-byte-offset views and
   in place; the Kafka round's kernels (``kafka_merge``,
   ``kafka_nem_deliver``, ``kafka_commit_select``,
   ``kafka_commit_apply``) in every mode (:func:`check_kafka`) at odd
   shapes and the Kafka phases' shapes; ``and_fold`` against
   ``and_rows`` at every serving phase's shape and ragged ones, both
   forms, on 4-byte-offset views, over probe bitsets in which a skipped
   block, head or tail changes the result (:func:`fold_probes`);
   ``prov_attribute`` in every attribution mode (:data:`PROV_MODES`) on
   ragged values and padded directions (:data:`PROV_SHAPES`); the txn
   round's ``txn_claim`` and ``txn_commit`` at 1, 31, 65,537 and 131,072
   nodes, 1, 2, 4 and 8 ops a transaction and 1 to 2^18 keys, all, none
   or some nodes active, issue stamps small and past the int32 wrap with
   planted colliding priorities (:func:`check_txn`); the batched
   ``fault_coins`` and ``faulted_gather_round`` (:func:`check_batched_faults`:
   S in {1, 3, 128} scenarios of N in {1, 24, 1,024} rows, W in {1, 2,
   64}, blocks straddling scenarios, 4-byte-offset views; S = 1 equal to
   the one-scenario kernels); the mesh's ``tree_halo_pack`` and
   ``tree_halo_round`` (both forms, with and without the back column and
   a live row: :func:`check_halo_kernels`, B at k, 12k and 255k-257k, W 1
   and 3, k 2 and 4, and the shard shapes) — and each one's
   median
   time at the main path's shapes (the
   masked exchanges at both, on the tree's 2 rows and the circulant's 8,
   the masked shift kernel also at smaller tile caps; the coins on the
   tree nemesis's 2 delivery rows and the accounted circulant's 8 ledger
   rows at round 5; the ring kernels on the delay phases' edge-delayed
   tables at round 5, beside the composition of masked exchanges they
   replace; the counter kernels at config3c's 2^24, cas and wide, and
   config3b's 2^20, allreduce under its gate), with its bound and the share of it reached
   (``bound_share`` = bound / device time).  Bounds count each input
   read once and each output written once over 3.35 TB/s, and the
   integer operations the function needs at 64 lanes a clock an SM (the
   coins': :func:`coin_ops`, from the coins the call draws).
3. ``w1_tree``: the 4-ary tree with 32 values (W = 1 word per node), the
   fixed-trip flood to ``discover_rounds`` timed with CUDA events, then
   the accounted while-converge run with the server ledger on; both held
   against the port's plain CPU path at the same size.
4. ``w128_tree``: 4,096 values (W = 128), the fixed-trip flood timed the
   same way; its unwrapped closed-form ledger ``msgs64``; a CPU
   cross-check of the same path at 65,536 nodes.
5. ``w1_circulant``: the degree-8 circulant expander
   (``expander_strides(2^20, 8, seed=0)``) with 32 values, timed and
   accounted as ``w1_tree``; held against the CPU path and against the
   node-major gather path on ``circulant(n, strides)`` on the card.
6. ``w128_circulant``: the same expander at 4,096 values, timed, with
   ``msgs64`` and a CPU cross-check at 65,536 nodes.
7. ``w1_random_regular``: ``random_regular(2^20, 8, seed=0)`` through the
   node-major gather, 32 values: rounds from a host-stepped run, the
   fixed-trip runner timed, then an accounted run (server ledger on,
   sync waves every 4 rounds) held against the CPU path.
8. ``w1_random_regular_partitioned``: the same graph under one half/half
   partition window over rounds [2, 24), sync waves every 16 rounds, the
   server ledger on, run to convergence and held against the CPU path.
9. ``w1_random_regular_nemesis``: the same graph under the full
   Maelstrom nemesis (benchmarks/fault_sweep.py's: a crash window over
   rounds [2, 12) of every 97th node, loss 0.1 and dup 0.05 until round
   13, seed 0), sync waves every 4 rounds, server ledger off, through the
   faulted gather round: run to convergence host-stepped (not before the
   faults clear), then the fixed-trip runner timed; held against the CPU
   path bit for bit.
10. ``w1_random_regular_nemesis_accounted``: crash + loss (no dup, so
    the server ledger is on) under the partitioned phase's window, sync
    waves every 16 rounds, run to convergence and held against the CPU
    path, ``srv_msgs`` included.
11. ``w1_circulant_partitioned``: benchmarks/run_all.py's ``config4c``
    on the structured path: the circulant expander under the partitioned
    phase's window and groups, sync waves every 16 rounds, through the
    masked shift exchange; run to convergence, the fixed trip timed, then
    the accounted run (server ledger on), held against the CPU path and
    the card's gather path on ``circulant(n, strides)`` under the same
    ``Partitions``.
12. ``w1_tree_nemesis``: the 4-ary tree under
    benchmarks/fault_sweep.py's structured plan (every 97th node down over
    rounds [2, 16), loss 0.1 and dup 0.05 until round 17, seed 5), sync
    waves every 8 rounds, server ledger off, through the masked tree
    exchange and the words-major coins; run to convergence host-stepped
    (not before the faults clear), then the fixed trip timed, with its
    kernel launches a round; held against the CPU path and the card's
    gather path on ``to_padded_neighbors(tree(n))`` under the same plan.
13. ``w1_circulant_nemesis_accounted``: a loss-only plan (loss 0.1 until
    13, seed 0) composed with ``config4c``'s window on the structured
    circulant, sync waves every 16 rounds, server ledger on; held against
    the CPU path and the card's gather path, ``srv_msgs`` included (the
    CPU path runs in a background process, :class:`BackgroundTwin`, and
    the line comes at the end, :func:`finish_pending`).
14. ``w1_circulant_delayed``: benchmarks/run_all.py's ``config4d``
    itself: the circulant expander, 32 values, per-edge delays of 1 or 3
    rounds (``default_rng(11)``, p = 0.7 / 0.3), three ways — the gather
    ring over ``gather_delays_from_rows``, per-direction classes
    (``make_delayed``, the generator's next draw) and per-edge delays on
    the structured path (``make_edge_delayed``, 16 ring-table rows) —
    each host-stepped, its fixed trip timed; the edge-delayed run equals
    the gather ring, also accounted (server ledger on, sync waves every
    16 rounds); every way held against the CPU path.
15. ``w1_circulant_edge_delayed_partitioned``: the same delays under
    ``config4c``'s window and groups, sync waves every 16 rounds, through
    ``make_edge_delayed_faulted``; equal to the gather ring under the
    same ``Partitions``, ``srv_msgs`` included.
16. ``w1_tree_edge_delayed``: the 4-ary tree with per-edge delays of the
    same law, equal to the gather ring on ``to_padded_neighbors(tree(n))``.
17. ``w1_tree_nemesis_delayed``: ``w1_tree_nemesis``'s plan with
    ``dir_delays = (1, 3)``, equal to the gather ring with
    ``gather_delays_for`` under the same plan.
18. ``small_floods``: grid (65,536 nodes), ring and line (4,099 nodes)
    run to convergence with the server ledger on, each held against the
    CPU path (coverage, not timing).
19. ``counter_1m_partitioned``: benchmarks/run_all.py's ``config3b``
    (``_counter_bench`` at 2^20 nodes: allreduce, half the nodes off the
    KV for rounds [0, 8) of 16); ``ok``: the KV and every read equal the
    sum of the deltas.
20. ``counter_16m_cas_wide``: ``config3c`` (2^24 nodes, cas, the wide
    winner layout, 16 rounds); ``ok``: the KV equals the drained deltas
    and 16 nodes drained; ``run_fused`` equals ``run``.
21. ``counter_nemesis_device_kv``: benchmarks/fault_sweep.py's large-N
    counter plan at 2^17 nodes over the device KV: allreduce with the
    fault gate in ``union_block`` slabs and ``kv_amnesia``, to
    convergence, then cas with seq-kv stale reads for 32 rounds; ``ok``:
    the KV plus what is pending plus the deltas lost in amnesia rows is
    the acknowledged sum, the store holds the KV, allreduce converges.
21a. ``mesh_collectives``, ``mesh_tree_1m``, ``mesh_topologies``: the
    broadcast simulator on a 1-D mesh of 4 ranks, one process each, all
    on the one card, a gloo group whose payloads cross ranks through
    host memory (``transport`` "gloo, host-staged"; one world runs every
    mesh phase's rank side, :func:`mesh_rank_work`, after the counter
    phases, whose one-process runs the mesh_counter phase reads).  The collectives
    and the halo primitives each equal their twin on the stitched input,
    and a 1-rank NCCL world (in the smoke's own process) runs
    ``structured_sim("tree", 2^16, 32, mesh=)`` equal to the no-mesh run
    (NCCL's point-to-point path across ranks needs two cards and is not
    run).  ``mesh_tree_1m``: the main
    path at full width, the 2^20-node 4-ary tree, 32 values, 2^18 nodes a
    rank: the flood twin's fixed trip (``tree_halo_pack`` and
    ``tree_halo_round``'s fused form a round; wall, ms a round, launches
    and collective calls a round), ``run_fused`` and the accounted run
    (server ledger, sync every 16), each equal to the one-process card
    run, the accounted run also to the CPU twin; the halo kernels' own
    times at (1, 2^18) and (128, 2^16) come from the kernel check.
    ``mesh_topologies``: grid, ring, line, circulant and tree k = 2,
    ``w1_circulant_partitioned``'s window on 2^16 nodes (the masked halo
    exchange) and the gather path on ``random_regular(2^16, 8)`` (the
    all-gather widen), each equal to its one-process run.  Not a
    multi-card figure.  Their launches are the ranks' own counts of the
    mesh runs (``launches_by_path``'s ``mesh``), never the parent's
    comparison runs.
21b. ``mesh_tree_1m_nemesis``, ``mesh_delays``, ``mesh_gather_nemesis``,
    ``mesh_counter``: the faulted, delayed and counter paths on the same
    4-rank world, each configuration one an earlier phase ran in one
    process on the card and held against that run (rounds, ``msgs``,
    ``srv_msgs``, the received set; the counter's kv, msgs, pending and
    cached reads), each run's fixed trip timed (ms a round) with its
    collective calls and launches a round a rank.
    ``mesh_tree_1m_nemesis``: ``w1_tree_nemesis``'s plan on the 2^20-node
    tree over the nemesis bundle's halo closures (``wm_fault_coins`` on
    each rank's block of columns, ``tree_halo_pack`` /
    ``tree_halo_round`` under the coin rows), with ``dir_delays`` (1, 3),
    and ``w1_circulant_nemesis_accounted``'s loss-only plan under config
    4c's window with the server ledger on; no all-gather a round.
    ``mesh_delays``: config 4d's delays on the 2^20 circulant through
    ``make_delayed``, ``make_edge_delayed`` and, under config 4c's window,
    ``make_edge_delayed_faulted`` (their halo closures), and the gather
    ring (``delays=``, the node-sharded ring's slots all-gathered) on
    ``random_regular(2^16, 8, 0)``.  ``mesh_gather_nemesis``:
    ``w1_random_regular_nemesis``'s plan through the faulted gather round
    over the all-gathered payload and dup rows, materialized and in slabs
    of 2^16 rows; beside the reference's census (2 all-gathers, 1
    all-reduce a round).  ``mesh_counter``: ``counter_1m_partitioned``'s,
    ``counter_16m_cas_wide``'s and both of
    ``counter_nemesis_device_kv``'s configurations (the read pass's
    partial form, then the all-reduces); all-reduces only; each timed
    warm (its first run's wall kept apart) with rank 0's profile of
    one more run.  Not a multi-card figure.
21c. ``mesh_kafka``: Kafka, ids and echo on the same 4-rank world, each
    configuration first run in one process on the card (its state's
    digests by rank block and whole, :data:`KAFKA_ONE`), then twice from
    a fresh state on the ranks (the first cold; the second timed: ms a
    round, collective calls a round by kind, each rank's launches), every
    rank's digests of its block equal to the one-process run's:
    ``kafka_node_sweep``'s 131,072-node union row (K 8,192, C 64, 2 + 2
    rounds; no all-gather), ``kafka_nemesis_4k``'s campaign (12 staged
    rounds with commits, resync every 4, then the one-process run's quiet
    rounds to convergence) pulled in slabs of 512 (the ring; no
    all-gather), pulled materialized (one metadata all-gather a round),
    pushed in slabs, and pulled over the device KV with ``kv_amnesia``,
    and ``kafka_faulted_1k``'s 4,096-node point through the matmul oracle
    (one all-gather a round; its one-process run equal to the CPU twin);
    ``ids_echo``'s ids and echo at 2^20 (no collective); and a 1-rank
    NCCL world's slab campaign (all-reduces only) equal to the no-mesh
    run.  The kernel check holds the four Kafka kernels' block forms
    against their plain versions and, combined over 2 and 4 blocks, the
    whole problem's, and times them at this phase's shapes.  Not a
    multi-card figure.
21d. ``mesh_txn_serving``: txn and open-loop serving on the same 4-rank
    world (its line comes after ``txn_nemesis_64k``, whose one-process
    card runs it is held against): ``txn_64k`` at full width
    (``TxnSim(mesh=)``, the ops staged once in the parent and shipped to
    the ranks in the world's spawn arguments), stepped to convergence and
    then as a timed fixed trip, every rank's digests of its block equal
    to ``txn_64k``'s one-process card state, all-reduces only (three a
    round); ``run_txn_nemesis(mesh=)`` at 4,096 nodes and 1,024 keys
    under :func:`counter_nemesis_spec`'s plan at that size (certified),
    and with ``kv_amnesia`` and the owner of key 0 crashed over [3, 6)
    (failing, naming lost updates), both result dicts equal to the
    one-process card runs'; ``run_serving(mesh=)`` at
    ``serving_counter_64k``'s rate 0.3, ``serving_kafka_64k``'s 0.3 and
    ``serving_broadcast_64k``'s 0.1 with telemetry on, each row's
    completions, ledger, latencies, lost writes and telemetry series
    equal to the serving phases' one-process card rows and replays, no
    all-gather; and a 1-rank NCCL world's ``txn_64k`` trip (all-reduces
    only) equal to the no-mesh run.  The kernel check holds the txn
    kernels' block forms against their plain versions and, combined over
    2 and 4 blocks, the whole problem's; ``txn_64k`` times them on a
    rank's block of its captured round.  Not a multi-card figure.
22. ``ids_echo``: ``UniqueIdsSim`` at 2^20 nodes, 32 ids a node, 4
    rounds, every id distinct; ``EchoSim`` at (2^20, 4), ``msgs == 2
    valid``.
23. ``kafka_device_ops``: the Kafka round's device functions that stay
    PyTorch ops (the allocation, the log write, the union row's
    scatter, the poll batch, the matmul oracle), timed.
24. ``kafka_10k``: benchmarks/run_all.py ``config5_kafka_10k`` (8 nodes,
    10,000 keys, 64 sends a node for 64 rounds), its 4,096-query poll
    batch and a device-KV run, each equal to the CPU path.
25. ``kafka_node_sweep``: ``config5b_kafka_node_sweep``, 8 to 1,024
    nodes at 10,000 keys and the extension rows to 262,144 nodes where
    1.5 x the presence fits the card; full replication checked in node
    chunks; rows up to 256 nodes equal the CPU path.
26. ``kafka_faulted_1k``: benchmarks/fault_sweep.py's faulted points at
    1,024 and 4,096 nodes: the materialized and blocked faulted unions
    (and the matmul oracle at 1,024) equal field by field.
27. ``kafka_nemesis_4k``: fault_sweep.py's large-N faulted Kafka row
    (4,096 nodes, commits, the resync every 4 rounds) run to
    convergence: pull and push through the port's
    ``harness.nemesis.run_kafka_nemesis`` with provenance on, each
    result equal to the CPU runner's; pull over the device KV through
    the runner's ``kafka_campaign`` and ``kafka_lost_writes``, equal to
    its CPU path and to the pull campaign (the three CPU runs in a
    background process; the line comes at the end).
28. ``nemesis_tree_1m_provenance``: the main path's 4-ary tree at 2^20
    nodes under fault_sweep.py --structured's plan through
    ``run_broadcast_nemesis`` on the gather path (D = 5, 16 values, cut
    from 32 for the time limit, sync every 8), telemetry and provenance on, then off: both verdicts, the
    provenance certificate, the first-delivery edges within the
    ledger, rounds / ``msgs`` / received equal; both walls, and the
    campaign's rounds as two fixed trips (observation off and on);
    ``prov_attribute`` held against its plain version on two captured
    rounds of the campaign (a faulted flood round and a sync wave) and
    timed there, its bound from what those inputs need.
29. ``nemesis_counter_128k_provenance``: fault_sweep.py:590-601's
    counter row (2^17 nodes, allreduce, the fault gate in 16,384-node
    slabs) through ``run_counter_nemesis`` with telemetry and provenance
    on, then off; the verdict and certificate pass, the campaigns agree.
30. ``kafka_sweep_point_provenance``: telemetry_overhead.py:200-232's
    point (1,024 nodes, 10,000 keys, 16 sends, ``union_block=256``,
    crash and loss, 2 rounds): ``run_observed(prov=)`` equals
    ``run_rounds``, both walls, the record certified.
31. ``serving_broadcast_64k``, ``serving_counter_64k``,
    ``serving_kafka_64k``: benchmarks/serving_curve.py's 65,536-node
    points on one card (:123-128, :142-148, :157-162): the words-major
    tree (W = 768) at rates 0.1 and 0.5, the allreduce counter and Kafka
    (64 keys) at 0.1 and 0.3, 512 clients, each rate a certified
    ``harness.serving.run_serving`` row (latency p50 / p99 / max in
    rounds, issued, deferred, completed, rounds, wall ms a round,
    completed ops a second, lost acknowledged writes); the driven phase
    timed and profiled (device idle share, launches and spans a round,
    ``no_host_sync``; its one trip must launch the phase's kernels) and,
    off the launch counts, ``and_fold``'s device ms on its state; then
    the runs replayed with the telemetry ring and held against the
    port's CPU path at the same spec (tracker, state and ring; the
    broadcast at rate 0.1 only, its CPU twin's W = 768 rounds run in a
    background process while the later phases run, and its record
    printed once the twin is held, after the last phase).  ``ok``: every
    row ``ok`` with no lost write, and the twin equal.
32. ``serving_overlay_1k``: the three fault overlays of
    serving_curve.py :169-200 (crash of every fifth node over rounds
    [16, 32), loss 0.1 until 36, 1,024 nodes, 256 clients at rate 0.2:
    the structured grid, Kafka with the resync, the allreduce counter)
    and ``counter_small_1dev``'s cas queueing curve (:132-140); each
    equal to the CPU path, the overlays' verdicts the CPU runner's.
33. ``serving_tree_1m``: the main path under load, the 2^20-node 4-ary
    tree words-major, 512 clients x 16 ops (W = 256), rate 0.25, 8
    driven rounds (32, then 16, before the time limit's cuts), held
    against the card's node-major gather path on
    ``to_padded_neighbors(tree(n))`` at the same spec.
34. ``txn_64k``: the JAX package's txn/fused-donated contract
    (gossip_glomers_tpu/tpu_sim/txn.py:535-540: 1,024 nodes, 256 keys, T
    8, O 2, rate 0.5, until 24) at 65,536 nodes and 16,384 keys, its
    arrivals cut to rounds [0, 6) for the time limit, stepped
    until every offered transaction commits, equal to the port's CPU path
    after every round, certified by ``check_txn_serializable``; the
    rounds as a fixed trip timed (CUDA events, profiler, the plain
    round beside), no host sync; both kernels checked and timed on round
    4's captured inputs, ``txn_claim`` beside ``scatter_reduce_(amin)``.
35. ``txn_nemesis_64k``: ``harness.txn.run_txn_nemesis`` at the same size
    under fault_sweep.py's large-N plan (:func:`counter_nemesis_spec`):
    certified; with ``kv_amnesia`` and the owner of key 0 crashed it fails
    naming lost updates and writes its flight bundle, which
    ``observe.replay_bundle`` replays on the card to the same verdict with
    ``first_divergence_round`` None; both campaigns equal their rounds on
    the CPU path (run in a background process; the line comes at the
    end).
36. ``flight_bundles``: a failing small campaign of each runner
    (broadcast gather with provenance and structured, counter, Kafka,
    serving) writes its bundle on the card; each replays on the card
    faithfully and on the CPU to the same verdict, series and stamps;
    ``run_timeline`` and ``run_manifest`` validate; ``GG_PROFILE_DIR``
    leaves a ``torch.profiler`` trace.
37. ``scenario_broadcast_fuzz``: fault_sweep.py:644-687's campaign,
    1,152 broadcast scenarios of a 24-node grid (48 values, sync every
    4, horizon 8, 32 recovery rounds) as 9 folded batches of 128
    (``tpu_sim/scenario.py``) drawn by ``harness/fuzz.py``'s
    ``sample_scenarios`` (seed 1), delays 1-2 on odd batches: each batch's
    walls, rounds, launches a round and scenarios a second, the trip
    run under ``no_host_sync``; two trips' device idle share; batch 0
    one scenario at a time through ``run_broadcast_nemesis`` (ms a
    scenario both ways), 8 scenarios held bit for bit (rows, telemetry,
    received) and the whole batch against the CPU path; the batched
    kernels checked and timed on its round-5 inputs.
38. ``scenario_broadcast_256x1024``: 256 scenarios of a 1,024-node grid,
    2,048 values (W = 64), horizon 16, 96 recovery rounds, delays on:
    262,144 folded rows; the wall, ms a round, idle share, each batched
    kernel's device ms and bound on its round-5 inputs, the torch freeze
    and convergence ops' device ms; 4 scenarios held against their
    sequential runs on the card.
39. ``scenario_counter_fuzz``, ``scenario_kafka_fuzz``: fault_sweep.py
    :699-706's breadth batches (64 scenarios at 16 nodes, horizon 8,
    ``sample_scenarios``), each scenario on its own sim (the looped
    batches): the wall, trips,
    host syncs and launches a trip, equal to the CPU path.
40. ``scenario_txn``: 64 txn campaigns at 64 nodes (the runner_kw
    defaults), every verdict serializable, equal to the CPU path.
41. ``serving_batch_frontier``: frontier_cartography.py:55-71's grid, 256
    broadcast serving cells at 8 nodes (16 rates x 8 fault levels x 2
    topologies, MRR 12, drain 4) as one serving batch: every row equal
    to the cell's ``run_serving`` on the card on the cartography's parity
    keys, 32 cells equal to the CPU path.
42. ``checkpoint_tree_1m``: the main path's 2^20-node tree under
    ``w1_tree_nemesis``'s plan and ``w1_tree_nemesis_delayed``'s
    (``dir_delays = (1, 3)``): checkpointed at round 8 inside the crash
    window, restored on the card with the plan rebuilt from the file's
    spec, finished equal to the uninterrupted run; the file's arrays in
    the reference's names and dtypes; save / restore ms, file bytes.
43. ``resize_broadcast_full``: ``run_resize_campaign`` on ``full``, grow
    1,024 -> 1,536 and shrink 1,536 -> 1,024 at round 6 with a crash
    window across the boundary, 65,536 KV keys re-homed: certified, twin
    bit-exact; the 64 <-> 96 forms equal on the card and the CPU.
44. ``resize_counter_1m``: the allreduce counter grown 2^20 -> 2^21 and
    shrunk back, crash windows across each boundary, 2^20 KV keys
    re-homed: certified, twin bit-exact; the resize path's device
    functions (the moved-key mask, the register carry, the member census,
    the state's pad and cut, the resizing intake gate) timed.
45. ``resize_kafka_4k``: Kafka grown 4,096 -> 6,144 and shrunk back
    (1,024 keys, S 2, resync every 4): certified, allocations continue.
46. ``frontier_grid_256``: ``run_frontier`` over the 256-cell grid with
    signatures, validated, every row equal to ``serving_batch_frontier``'s;
    two SLO-failing cells' bundles replayed on the card and the CPU.
47. ``fuzz_campaigns``: fault_sweep.py:684-706's ``fuzz_run`` campaigns
    (1,152 broadcast with the planted failure and two shrinks, counter,
    Kafka, counter with the membership axis) and frontier_cartography.py
    :144-195's shape-bucket and adaptive runs: the planted seed shrinks
    and its bundle replays on the card and the CPU.
48. ``mesh_provenance_batches``: provenance and the batches on the same
    4-rank world (its line comes after ``fuzz_campaigns``; the earlier
    phases keep the one-process card runs it is held against,
    :data:`MESH_PROV_ONE`): ``nemesis_tree_1m_provenance``'s campaign on
    2^20 nodes (result and stamp digests equal; rank 0 certifies the
    gathered record and shares the verdict), its rounds as plain and
    stamped fixed trips (each rank's received block equal, the record
    adding no collective, ``prov_attribute`` once a round a rank);
    ``nemesis_counter_128k_provenance``'s campaign (and a trip: one
    all-reduce more a round); ``kafka_sweep_point_provenance``'s point
    (each rank's block and the record equal, at most two all-reduces
    more); ``scenario_broadcast_256x1024``'s one-hop batch, 64 scenarios
    a rank (rows equal, the folded launches a round as one process makes
    at 256 scenarios, no collective in the trip, one gather at collect);
    the three looped batches, ``frontier_grid_256``'s ``run_frontier``
    (64 cells a rank), ``fuzz_campaigns``' first broadcast batch with its
    planted shrink on the mesh (its bundle written once into a shared
    directory), ``replay_bundle(mesh=)`` of a bundle a one-process card
    campaign wrote before the world, and ``run_txn_frontier(mesh=)``,
    each equal to its one-process card run.  The kernel check holds
    ``prov_attribute`` on a rank's rows (fewer rows than sources) against
    its plain version and, over 2 and 4 blocks combined, the whole
    problem; ``nemesis_tree_1m_provenance`` times it on a rank's rows of
    its captured round.  Not a multi-card figure.

The Kafka phases run their staged rounds under torch's sync debug mode
(no host sync) and report rounds, wall ms, ms a round, device busy ms,
idle share and launches a round.

The counter phases are timed as fixed trips of ``run`` (CUDA events),
with their device busy time, idle share and port launches a round, and
each equals the port's CPU path in ``pending``, ``cached``, ``kv``,
``t``, ``msgs`` and the KV rows.

Device times (``device_ms``, ``device_busy_ms``) come from
torch.profiler and count only when it saw every port kernel launch of
the profiled run; after three incomplete profiles they are null (not
measured), and stderr says what each profile missed.  A kernel's
``device_ms`` averages only the spans of its own ``__global__``
(``kernel_ms``): a wrapper may launch helpers beside it (sync_diff_pc's
zero fill and casts).

Each phase prints one JSON line (with ``elapsed_s``, the host seconds
since the smoke started), after a ``card`` line (the card's name,
power limit, SM clock and the integer rate it gives); the kernels'
timing adds a ``ring_plan`` line at each main shape (the shift ring
plan's tile, stages, stage bytes and windows, and its L2-delivery
floor: windows x slot bytes at L2_BYTES_PER_S, a constant of an earlier
probe, not a measurement of this run).  Kernel launch
counts are zeroed just before each main-path phase and read just after.
Then come the card's name and power limit (``nvidia-smi``), one
``{"kernels": [...]}`` line
(``launches`` every launch of the main-path phases, ``launches_timed_trips``
those of one trip of each timed path alone, :data:`TRIP_LAUNCHES`; the
shift kernels' launches also split by path: the 1M-node floods at
W = 128 and at W = 1, and the small floods; ``gather_or`` launches on
the delay phases' gather ring) and last
``{"ok": true, "device": {...}}``.  Any failure raises: the script
then exits non-zero and prints no result.  Without a CUDA card it exits
with status 2.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

N_NODES = 1 << 20
BRANCHING = 4
DEGREE = 8
W1_VALUES = 32
W128_VALUES = 4096
CHECK_NODES = 1 << 16        # the W = 128 CPU cross-check size
CHECK_SHAPES = [(w, n) for w in (1, 8, 32, 128)
                for n in (1, 5, 4097, (1 << 16) + 3)]
MAIN_SHAPES = [(1, N_NODES), (W128_VALUES // 32, N_NODES)]
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
# 32-bit integer add, multiply-add, shift, compare and logical operations
# a clock on one SM of compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput); main() sets OPS_PER_S to
# this x the SMs x the SM clock read from nvidia-smi (clocks.max.sm)
INT_LANES_PER_CLOCK = 64
OPS_PER_S: float | None = None
CSRC = "gossip_glomers_tpu_torch/csrc/"
JAX_PKG = "gossip_glomers_tpu/tpu_sim/"
# per kernel: (source, what it replaces — the fused 4-ary tree inbox Pallas
# kernel, never lowered by Mosaic, or the XLA code of the reference — and
# the name of its __global__, which the profiler reports)
KERNELS = {
    "tree_exchange": ("tree_flood.cu", "benchmarks/pallas_tree_probe.py:74",
                      "tree_exchange_kernel"),
    "tree_masked_exchange": ("tree_flood.cu", JAX_PKG + "structured.py:662",
                             "tree_masked_exchange_kernel"),
    "tree_flood_round": ("tree_flood.cu",
                         "benchmarks/pallas_tree_probe.py:74",
                         "tree_flood_round_kernel"),
    "col_popcount": ("tree_flood.cu", JAX_PKG + "broadcast.py:305",
                     "col_popcount_kernel"),
    "col_popcount_nm": ("gather_flood.cu", JAX_PKG + "broadcast.py:464",
                        "col_popcount_nm_kernel"),
    "shift_exchange": ("shift_flood.cu", JAX_PKG + "structured.py:170",
                       "shift_tiles_kernel"),
    "shift_flood_round": ("shift_flood.cu", JAX_PKG + "broadcast.py:288",
                          "shift_tiles_kernel"),
    "shift_masked_exchange": ("shift_flood.cu", JAX_PKG + "structured.py:688",
                              "shift_tiles_kernel"),
    "gather_or": ("gather_flood.cu", JAX_PKG + "broadcast.py:185",
                  "gather_or_kernel"),
    "sync_diff_pc": ("gather_flood.cu", JAX_PKG + "broadcast.py:247",
                     "sync_diff_pc_kernel"),
    "gather_flood_round": ("gather_flood.cu", JAX_PKG + "broadcast.py:579",
                           "gather_flood_round_kernel"),
    "fault_coins": ("fault_flood.cu", JAX_PKG + "broadcast.py:162",
                    "fault_coins_kernel"),
    "faulted_gather_round": ("fault_flood.cu", JAX_PKG + "broadcast.py:557",
                             "faulted_gather_round_kernel"),
    "wm_fault_coins": ("fault_flood.cu", JAX_PKG + "faults.py:690",
                       "wm_fault_coins_kernel"),
    "tree_ring_exchange": ("tree_flood.cu",
                           "benchmarks/pallas_tree_probe.py:74",
                           "tree_ring_exchange_kernel"),
    "shift_ring_exchange": ("shift_flood.cu", JAX_PKG + "structured.py:1038",
                            "shift_tiles_kernel"),
    "counter_select": ("counter_round.cu", JAX_PKG + "counter.py:397",
                       "counter_select_kernel"),
    "counter_apply": ("counter_round.cu", JAX_PKG + "counter.py:483",
                      "counter_apply_kernel"),
    "kafka_merge": ("kafka_round.cu", JAX_PKG + "kafka.py:516",
                    "kafka_merge_kernel"),
    "kafka_nem_deliver": ("kafka_round.cu", JAX_PKG + "kafka.py:535",
                          "kafka_nem_deliver_kernel"),
    "kafka_commit_select": ("kafka_round.cu", JAX_PKG + "kafka.py:746",
                            "kafka_commit_select_kernel"),
    "kafka_commit_apply": ("kafka_round.cu", JAX_PKG + "kafka.py:773",
                           "kafka_commit_apply_kernel"),
    # no Pallas kernel: the traffic drivers' XLA AND-fold (and kafka.py:1396)
    "and_fold": ("traffic_fold.cu", JAX_PKG + "broadcast.py:2559",
                 "and_fold_kernel"),
    # no Pallas kernel: the gather round's XLA provenance attribution
    "prov_attribute": ("prov_flood.cu", JAX_PKG + "broadcast.py:317",
                       "prov_attribute_kernel"),
    # no Pallas kernel: the txn round's XLA claim and commit
    "txn_claim": ("txn_round.cu", JAX_PKG + "txn.py:264",
                  "txn_claim_kernel"),
    "txn_commit": ("txn_round.cu", JAX_PKG + "txn.py:280",
                   "txn_commit_kernel"),
    # the scenario batch's forms of the two: the reference vmaps the
    # one-scenario XLA code over the scenario axis (scenario.py:603)
    "fault_coins_batched": ("fault_flood.cu", JAX_PKG + "broadcast.py:162",
                            "fault_coins_kernel"),
    "faulted_gather_round_batched": ("fault_flood.cu",
                                     JAX_PKG + "broadcast.py:557",
                                     "faulted_gather_round_kernel"),
    # no Pallas kernel: certify_loop's XLA freeze of the carry
    "fold_freeze": ("fault_flood.cu", JAX_PKG + "scenario.py:327",
                    "fold_freeze_kernel"),
    # the Pallas tree inbox in its sharded form on a mesh (the
    # reference's structured.py:225-327 around it): the kids' partial a
    # shard sends, and the inbox from the received slices
    "tree_halo_pack": ("tree_flood.cu", "benchmarks/pallas_tree_probe.py:74",
                       "tree_halo_pack_kernel"),
    "tree_halo_round": ("tree_flood.cu",
                        "benchmarks/pallas_tree_probe.py:74",
                        "tree_halo_round_kernel"),
}
# the gather kernels' main shapes are node-major (N, W) = (2^20, 1) and
# (2^20, 128), degree 8
GATHER_SHAPES = [(1, N_NODES), (W128_VALUES // 32, N_NODES)]
# the profiler's names of the port's kernels (csrc/*.cu __global__s)
PORT_KERNEL = re.compile(r"(tree_exchange|tree_masked_exchange|"
                         r"tree_ring_exchange|tree_halo_pack|"
                         r"tree_halo_round|"
                         r"tree_flood_round|col_popcount|col_popcount_nm|"
                         r"shift_tiles|gather_or|sync_diff_pc|"
                         r"gather_flood_round|fault_coins|"
                         r"fold_freeze|"
                         r"faulted_gather_round|wm_fault_coins|"
                         r"counter_select|counter_apply|kafka_merge|"
                         r"kafka_nem_deliver|kafka_commit_select|"
                         r"kafka_commit_apply|and_fold|"
                         r"prov_attribute|txn_claim|txn_commit)_kernel")
LEAD_IN_CYCLES = 2_000_000   # the profiler's lead-in spin, ~1 ms on an H100
# plan tile caps at which shift_masked_exchange is also timed (the
# wrapper's, kernels.SHIFT_TILE, first)
MASKED_TILES = (2048, 1024, 512)
# what the L2 delivered to the SMs in an L2 probe on an H100 (PERF.md)
L2_BYTES_PER_S = 5.33e12
# the H100 SXM's L2 (data sheet): operands below it stay there between
# back-to-back calls
L2_BYTES = 50 << 20


# the host clock at the smoke's start: each phase line carries its
# ``elapsed_s`` since then (where the smoke's time limit goes)
START = time.perf_counter()


def emit(obj: dict) -> None:
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - START)
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, samples: int = 5, inner: int = 10) -> float:
    """Median over ``samples`` of the mean CUDA-event time of ``inner``
    back-to-back calls, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_spans(make_run, attempts: int = 3) -> list[dict] | None:
    """Device spans of one staged run, from torch.profiler's CUDA
    activity: ``[{"name", "us"}]`` for every kernel, copy and set it
    launched.  ``make_run()`` stages a run off the profiler and returns
    it as a zero-argument call.

    The profiler can drop kernels that run just after it starts (or
    all of a short run's), so each attempt stages two runs: the first
    runs in the warm-up step, whose events are dropped, the second in
    the active step behind a ~1 ms spin kernel, so that its first
    kernel starts well inside the recorded window.  An attempt counts
    only if the profiler saw every launch of the port's kernels that
    the wrappers counted in the measured run; after ``attempts``
    incomplete profiles the result is None (not measured)."""
    import torch
    from gossip_glomers_tpu_torch.tpu_sim import kernels
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(1, attempts + 1):
        runs = [make_run(), make_run()]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            runs[0]()
            torch.cuda.synchronize()
            prof.step()
            torch.cuda._sleep(LEAD_IN_CYCLES)
            before = sum(kernels.LAUNCHES.values())
            runs[1]()
            torch.cuda.synchronize()
            launched = sum(kernels.LAUNCHES.values()) - before
            prof.step()
        spans = [{"name": e.name, "us": e.time_range.end - e.time_range.start}
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "spin_kernel" not in e.name]
        seen = sum(1 for s in spans if PORT_KERNEL.search(s["name"]))
        if spans and seen == launched:
            return spans
        print(f"chip_smoke: profile {attempt} of {attempts} saw {seen} of "
              f"{launched} port kernel launches ({len(spans)} device "
              "spans)", file=sys.stderr, flush=True)
    return None


def kernel_ms(spans: list[dict], kernel: str) -> float:
    """Mean time (ms) of the spans of the ``__global__`` named ``kernel``
    (a whole word of the span's name: ``col_popcount_kernel`` is not
    ``col_popcount_nm_kernel``); the other spans of the call — fills,
    casts, elementwise ops a wrapper launches beside its kernel — do not
    count.  Raises if the kernel has no span."""
    name = re.compile(rf"\b{re.escape(kernel)}\b")
    mine = [s["us"] for s in spans if name.search(s["name"])]
    if not mine:
        raise AssertionError(f"no device span of {kernel} among "
                             f"{sorted({s['name'] for s in spans})}")
    return sum(mine) / len(mine) / 1e3


def device_ms(fn, kernel: str, calls: int = 1,
              attempts: int = 3) -> float | None:
    """Mean device time (ms) of one launch of the ``__global__`` named
    ``kernel`` during ``calls`` calls of ``fn`` (None: not measured after
    ``attempts`` profiles)."""
    def staged():
        def run():
            for _ in range(calls):
                fn()
        return run

    spans = device_spans(staged, attempts)
    return None if spans is None else kernel_ms(spans, kernel)


def device_busy_ms(make_run) -> float | None:
    """Total device time (ms) of everything one staged run launched
    (None: not measured)."""
    return busy_and_spans(make_run)[0]


def busy_and_spans(make_run) -> tuple[float | None, int | None]:
    """(total device ms, device spans) of one staged run: every kernel,
    copy and set it launched (None, None: not measured)."""
    spans = device_spans(make_run)
    if spans is None:
        return None, None
    return sum(s["us"] for s in spans) / 1e3, len(spans)


def max_abs_err(a, b) -> int:
    """max |a - b| over int64 copies of chunks of 2^26 elements (a
    state-sized tensor is compared without a state-sized temporary)."""
    a, b = a.reshape(-1), b.reshape(-1)
    step = 1 << 26
    return max((int((a[i:i + step].long() - b[i:i + step].long()).abs()
                    .max()) for i in range(0, a.numel(), step)), default=0)


def at_offset(x, offset: int):
    """A contiguous copy of x starting ``offset`` elements into its
    allocation (1 of int32: 4 bytes, off the 16-byte grid)."""
    import torch

    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


def bound(moved_bytes: float, ops: float,
          bytes_per_s: float = HBM_BYTES_PER_S) -> tuple[float, str]:
    """(least ms, "bytes" | "operations") for work that moves
    ``moved_bytes`` (at ``bytes_per_s``: HBM's rate, or the L2's for
    operands that stay in it) and does ``ops`` integer operations (at
    the card's integer rate, :data:`OPS_PER_S`)."""
    by = moved_bytes / bytes_per_s * 1e3
    op = ops / OPS_PER_S * 1e3
    return (by, "bytes") if by >= op else (op, "operations")


# the integer operations of wm_fault_coins' function (fault_flood.cu's
# hash): a loss coin is the two id products, their xor with the salted
# key, mix32's 8 and the compare; a dup coin shares the products (the
# salted key, mix32, the compare)
OPS_LOSS_COIN, OPS_DUP_COIN = 13, 10
# a closed-form id by its form (kernels.COIN_*): IDENT none; SHIFT an
# add, a subtract of n and an unsigned min; PARENT an add and a shift (k
# a power of two); CHILD a multiply-add
OPS_ID = (0, 3, 2, 1)
# a slot's live bit: its test and the AND with the slot's coins
OPS_LIVE_BIT = 2


def coin_ops(dirs, n: int, n_loss: int, n_dup: int) -> int:
    """Integer operations one ``wm_fault_coins`` call needs: each (row,
    node) slot's two closed-form ids (``dirs``' forms, :data:`OPS_ID`)
    and live bit, and the loss and dup coins it draws."""
    slot = sum(OPS_ID[int(src)] + OPS_ID[int(dst)] + OPS_LIVE_BIT
               for src, _, dst, _ in dirs.tolist())
    return slot * n + OPS_LOSS_COIN * n_loss + OPS_DUP_COIN * n_dup


def shift_edges(tile: int) -> list:
    """The shift kernels' edge shapes for their tile: a row one node
    short of a tile, one tile, one over, and a ragged third at W = 128
    (odd n)."""
    return [(1, tile - 1), (8, tile), (1, tile + 1), (128, 2 * tile + 3)]


def ragged_cols(n: int, grid_cols) -> int:
    """A grid width whose last row is ragged (for n > 2)."""
    return max(1, grid_cols(n) - 1)


def shift_modes(n: int, topology) -> list:
    """The shift kernels' modes at n nodes: (name, topology, kw)."""
    return [("circulant", "circulant",
             {"strides": topology.expander_strides(n, DEGREE, seed=0)}),
            ("ring", "ring", {}), ("line", "line", {}),
            ("grid", "grid", {"cols": ragged_cols(n, topology.grid_cols)})]


def gather_case(w: int, n: int, d: int, n_src: int, seed: int, device):
    """A gather case from ``seed``: an (n_src, W) payload, an (n, W) recv,
    an (n, d) table of indices in [-1, n_src + 3) (-1 pads, and indices
    past the payload, which the kernels clip) and an (n, d) edge mask."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    nbrs = rng.integers(-1, n_src + 3, (n, d)).astype(np.int32)
    gen = torch.Generator(device=device).manual_seed(seed)

    def bits(shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                             device=device, generator=gen)

    return (bits((n_src, w)), bits((n, w)), torch.from_numpy(nbrs).to(device),
            torch.from_numpy(rng.random((n, d)) < 0.7).to(device))


def gather_edges(nodes_per_block) -> list:
    """The gather kernels' edge shapes (w, n, d, n_src): at W = 1 and 128
    (degree 8) a block's nodes (``nodes_per_block(w)``) less one, one
    block's, one more, and two and a ragged third; then degrees 1 and 3,
    and payloads with more and fewer rows than nodes."""
    out = []
    for w in (1, 128):
        b = nodes_per_block(w)
        out += [(w, n, DEGREE, n) for n in (b - 1, b, b + 1, 2 * b + 3)]
    return out + [(1, 4097, 1, 4097), (8, 4097, 3, 4097),
                  (1, 4097, DEGREE, 5000), (32, 4097, DEGREE, 3000)]


def check_gather(kernels, note, payload, recv, nbrs, live,
                 offset: int = 0) -> None:
    """The three gather kernels against their plain versions on one case,
    with and without the mask; ``offset`` 1 moves every operand 4 bytes
    into its allocation."""
    views = (at_offset(payload, offset), at_offset(recv, offset),
             at_offset(nbrs, offset), at_offset(live, 4 * offset))
    for lv, lk in ((None, None), (live, views[3])):
        note("gather_or", (kernels.gather_or(views[0], views[2], lk),
                           kernels.gather_or_plain(payload, nbrs, lv)))
        note("sync_diff_pc", (
            kernels.sync_diff_pc(views[0], views[1], views[2], lk),
            kernels.sync_diff_pc_plain(payload, recv, nbrs, lv)))
        note("gather_flood_round", *zip(
            kernels.gather_flood_round(views[0], views[1], views[2], lk),
            kernels.gather_flood_round_plain(payload, recv, nbrs, lv)))


def gather_inputs(w: int, n: int, seed: int, device, topology):
    """Node-major payload and receiver bitsets, a -1-padded degree-8
    table and an edge mask, made from ``seed``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    nbrs = topology.random_regular(n, DEGREE, seed=seed)
    nbrs[rng.random(nbrs.shape) < 0.1] = -1
    gen = torch.Generator(device=device).manual_seed(seed)

    def bits(shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                             device=device, generator=gen)

    return (bits((n, w)), bits((n, w)), torch.from_numpy(nbrs).to(device),
            torch.from_numpy(rng.random(nbrs.shape) < 0.7).to(device))


# the fault coins' streams in the checks: (loss, dup) active, and the
# rates, round and seed their hashes take
FAULT_STREAMS = ((False, False), (True, False), (False, True), (True, True))
FAULT_COINS = {"t": 7, "seed": 0x9E3779B9 ^ 12345,
               "loss_num": int(0.3 * 2**32), "dup_num": int(0.2 * 2**32)}


def fault_case(w: int, n: int, d: int, n_src: int, seed: int, device):
    """A fault-kernel case from ``seed``: :func:`gather_case`'s operands
    (payload, recv, nbrs, live) and an (n_src, W) received set whose rows
    the dup edges read, an (n_src,) up vector with a tenth of the nodes
    down."""
    import numpy as np
    import torch

    payload, rec, nbrs, live = gather_case(w, n, d, n_src, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    received = torch.randint(-(1 << 31), 1 << 31, (n_src, w),
                             dtype=torch.int32, device=device, generator=gen)
    up = torch.from_numpy(
        np.random.default_rng(seed + 1).random(n_src) >= 0.1).to(device)
    return payload, received, rec, nbrs, live, up


def check_faults(kernels, note, case, lo: int = 0, hi: int | None = None,
                 offset: int = 0) -> None:
    """``fault_coins`` and ``faulted_gather_round`` against their plain
    versions on one case: every (loss, dup) stream combination, with and
    without the partition mask, over the destination rows [lo, hi) (the
    slab's views: rows of the table, node ids from ``lo``), with every
    operand ``offset`` words (4 bytes) into its allocation."""
    payload, received, rec, nbrs, live, up = case
    hi = nbrs.shape[0] if hi is None else hi
    nb, lv, rc = nbrs[lo:hi], live[lo:hi], rec[lo:hi]
    views = {name: at_offset(x, offset * (4 if x.element_size() == 1
                                          else 1))
             for name, x in (("nb", nb), ("lv", lv), ("rc", rc),
                             ("up", up), ("payload", payload),
                             ("received", received))}
    for loss, dup in FAULT_STREAMS:
        for masked in (False, True):
            kw = dict(FAULT_COINS, loss=loss, dup=dup, out_ok=True, row0=lo)
            flags = kernels.fault_coins(views["nb"], views["up"],
                                        live=views["lv"] if masked else None,
                                        **kw)
            want = kernels.fault_coins_plain(nb, up, live=lv if masked
                                             else None, **kw)
            note("fault_coins", (flags, want))
            fl = at_offset(want, 4 * offset)
            got = kernels.faulted_gather_round(
                views["payload"], views["received"] if dup else None,
                views["rc"], views["nb"], fl)
            note("faulted_gather_round", *zip(
                got, kernels.faulted_gather_round_plain(
                    payload, received if dup else None, rc, nb, want)))


ROW_MODES = ("all", "none", "random")


def packed_rows(kernels, d: int, n: int, mode: str, seed: int, device):
    """(d, ceil(n/32)) packed liveness rows: every node live, none, or
    random words (the bits past n random too: no kernel may read them)."""
    import torch

    if mode == "all":
        return kernels.pack_bits(torch.ones((d, n), dtype=torch.bool,
                                            device=device))
    if mode == "none":
        return torch.zeros((d, kernels.packed_words(n)), dtype=torch.int32,
                           device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-(1 << 31), 1 << 31, (d, kernels.packed_words(n)),
                         dtype=torch.int32, device=device, generator=gen)


WM_STREAMS = ((False, False, False), (True, False, False),
              (False, True, False), (True, True, False),
              (False, False, True), (True, False, True))
WM_COINS = {"t": 5, "seed": 5, "loss_num": int(0.3 * 2**32),
            "dup_num": int(0.2 * 2**32)}


def check_masked(kernels, structured, topology, note, fr, seed: int,
                 offset: int = 0) -> None:
    """The masked exchanges against their plain versions over one (W, N)
    payload ``fr``: every row mode, the tree's two rows apart, every shift
    mode, each operand ``offset`` words into its allocation."""
    w, n = fr.shape
    frk = at_offset(fr, offset)
    for mode in ROW_MODES:
        rows = packed_rows(kernels, 2, n, mode, seed, fr.device)
        rk = [at_offset(r, offset) for r in rows]
        note("tree_masked_exchange", (
            kernels.tree_masked_exchange(frk, rk[0], rk[1], BRANCHING),
            kernels.tree_masked_exchange_plain(fr, rows[0], rows[1],
                                               BRANCHING)))
        for _, topo, kw in shift_modes(n, topology):
            dirs = structured.shift_dirs(topo, n, **kw)
            live = packed_rows(kernels, len(dirs.offs), n, mode, seed + 1,
                               fr.device)
            note("shift_masked_exchange", (
                kernels.shift_masked_exchange(frk, at_offset(live, offset),
                                              dirs),
                kernels.shift_masked_exchange_plain(fr, live, dirs)))


# the tree's branchings in the coin checks (k + 1 words a warp at k = 3
# straddle, 32 a word a child in the masked exchange; 4 the main path's)
COIN_BRANCHINGS = (1, 2, 3, 4, 32)
# the mesh's shard counts whose blocks the coin check runs: at the main
# shape's 2^20 nodes, 4 shards give the 2^18-column blocks of the
# mesh_tree_1m_nemesis ranks
COIN_BLOCK_SHARDS = (2, 4)
# a node count whose 2- and 4-shard blocks (2054, 1027 columns) end
# inside a word, so that block starts fall off the word grid
COIN_BLOCK_NS = (4 * 1027,)


def coin_dir_sets(structured, topology, n: int) -> list:
    """Every structured topology's coin descriptors at n nodes: (name,
    (D, 4) int64 numpy rows) for the tree at :data:`COIN_BRANCHINGS` in
    the delivery and the degree contract, a ragged grid, the ring, the
    line and the circulant expander."""
    out = [(f"tree{k}_{c}", structured.coin_dirs(
        "tree", n, degree=c == "deg", branching=k))
        for k in COIN_BRANCHINGS for c in ("del", "deg")]
    return out + [(name, structured.coin_dirs(topo, n, **kw))
                  for name, topo, kw in shift_modes(n, topology)]


def check_coins(kernels, structured, topology, note, n: int, seed: int,
                device, offset: int = 0) -> None:
    """``wm_fault_coins`` on every topology's descriptors
    (:func:`coin_dir_sets`) against ``wm_fault_coins_plain`` over their
    materialized id rows (``kernels.coin_dir_rows``, the kernel's uint32
    ids also where no edge exists, so that random rows compare): every
    row mode, every stream of :data:`WM_STREAMS` (loss, dup, the ledger
    mode), the live rows ``offset`` words into their allocation.  Then
    the block form a mesh rank launches: for 2 and 4 shards that divide
    n, each rank's block of b = n / shards columns (``col0 = r·b``,
    ``n_ids = n``, the ids global) against the whole row's plain coins
    cut to that block."""
    import torch

    def cut(rows, lo, hi):
        return at_offset(kernels.pack_bits(
            kernels.unpack_bits(rows, n)[:, lo:hi].contiguous()), offset)

    shards = [p for p in COIN_BLOCK_SHARDS if n % p == 0 and n >= p]
    for name, rows in coin_dir_sets(structured, topology, n):
        dirs = torch.from_numpy(rows).to(device)
        src, dst = kernels.coin_dir_rows(dirs, n)
        for mode in ROW_MODES:
            live = packed_rows(kernels, len(rows), n, mode, seed, device)
            lk = at_offset(live, offset)
            blocks = [(n // p, r * (n // p), cut(live, r * (n // p),
                                                 (r + 1) * (n // p)))
                      for p in shards for r in range(p)]
            for loss, dup, srv in WM_STREAMS:
                kw = dict(WM_COINS, loss=loss, dup=dup, srv=srv)
                want = kernels.wm_fault_coins_plain(src, dst, live, **kw)
                got = kernels.wm_fault_coins(dirs, n, lk, **kw)
                note("wm_fault_coins", *(
                    (g, x) for g, x in zip(got, want) if x is not None))
                for b, col0, lb in blocks:
                    got = kernels.wm_fault_coins(dirs, b, lb, col0=col0,
                                                 n_ids=n, **kw)
                    if (got[1] is None) != (want[1] is None):
                        raise AssertionError(
                            f"wm_fault_coins' block form at {name}, col0 "
                            f"{col0} of {n}: out1 is None on one side only")
                    note("wm_fault_coins", *(
                        (g, cut(x, col0, col0 + b))
                        for g, x in zip(got, want) if x is not None))


# tree_exchange's vector-path cases: n % 4 in {0, 1, 2, 3} (a row of the
# four-nodes-a-thread path, then rows the scalar kernel takes), rows whose
# last quads' children stop at each vector, k = 4 and k = 3
TREE_VEC_NS = (4, 20, 44, 4096, 4097, 4098, 4099, 65552)


def check_tree(kernels, note, bits) -> None:
    """``tree_exchange`` against ``tree_exchange_plain`` at
    :data:`TREE_VEC_NS`, W = 1 and 128, k = 4 and 3, on views at offsets
    0 and 1 (4 bytes in: the scalar kernel)."""
    for n in TREE_VEC_NS:
        for w in (1, 128):
            fr = bits(w, n)
            for offset in (0, 1):
                view = at_offset(fr, offset)
                for k in (4, 3):
                    note("tree_exchange", (kernels.tree_exchange(view, k),
                                           kernels.tree_exchange_plain(fr,
                                                                       k)))


def ring_tree_tables(rng, slots: int, rows: int) -> list:
    """tree_ring_exchange's table shapes: make_delayed's two ungated
    terms, the nemesis's two gated ones, make_edge_delayed's 2 |V| (|V| =
    3), a 21-entry random table (two launches) and that table with the
    entries of slot 1 dropped (as a send round below 0 drops them)."""
    rand = [(int(rng.integers(0, slots)), int(rng.integers(0, 2)),
             int(rng.integers(-1, rows))) for _ in range(21)]
    return [[(0, 0, -1), (2, 1, -1)], [(1, 0, 0), (0, 1, 1)],
            [(v, kind, 2 * v + kind) for v in range(3) for kind in (0, 1)],
            rand, [e for e in rand if e[0] != 1]]


def check_ring(kernels, structured, topology, note, w: int, n: int,
               seed: int, device, offset: int = 0) -> None:
    """Both ring kernels against their twins on one random (3, W, N) ring
    and random packed rows: the tree's tables (:func:`ring_tree_tables`,
    k = 4 and 3: four nodes a thread on an aligned ring with n % 4 == 0,
    else a node a thread), every shift mode's directions at once, as two
    delay classes (slots 2 and 0: the edge-delayed table, a group a
    slot) and three times over (24 rows, one launch), with random slots,
    with and without rows, and with the rows of slot 1 dropped; ring and
    rows ``offset`` words into their allocation."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    ring = torch.randint(-(1 << 31), 1 << 31, (3, w, n), dtype=torch.int32,
                         device=device, generator=gen)
    live = torch.randint(-(1 << 31), 1 << 31, (48, kernels.packed_words(n)),
                         dtype=torch.int32, device=device, generator=gen)
    rk = at_offset(ring, offset)
    for k in (BRANCHING, 3):
        for table in ring_tree_tables(rng, 3, 6):
            note("tree_ring_exchange", (
                kernels.tree_ring_exchange(rk, table,
                                           at_offset(live[:6], offset), k),
                kernels.tree_ring_exchange_plain(ring, table, live[:6], k)))
    for _, topo, kw in shift_modes(n, topology):
        dirs = structured.shift_dirs(topo, n, **kw)
        for reps in (1, 2, 3):
            slots = (tuple(int(x) for x in
                           rng.integers(0, 3, len(dirs.offs) * reps))
                     if reps != 2 else
                     (2,) * len(dirs.offs) + (0,) * len(dirs.offs))
            keep = [d for d, x in enumerate(slots) if x != 1]
            for sel in (list(range(len(slots))), keep):
                table = kernels.ShiftDirs(
                    tuple((dirs.offs * reps)[d] for d in sel),
                    tuple((dirs.flags * reps)[d] for d in sel), dirs.cols,
                    tuple(slots[d] for d in sel))
                rows = live[:len(sel)]
                for lv in (None, rows):
                    note("shift_ring_exchange", (
                        kernels.shift_ring_exchange(
                            rk, table,
                            None if lv is None else at_offset(lv, offset)),
                        kernels.shift_ring_exchange_plain(ring, table, lv)))


# the ring kernels' shapes besides CHECK_SHAPES and MAIN_SHAPES: n % 4 in
# {0, 2} (CHECK_SHAPES' n hold 1 and 3); n % 4 == 0 takes the tree's four
# nodes a thread, also where no quad has all its children (n < 16)
RING_SHAPES = [(1, 4096), (8, 4098), (1, 12), (8, 20), (128, 4), (1, 65540)]


def check_kernels(kernels, structured, topology, device) -> dict:
    """Every kernel, in every mode, against its plain version on the card;
    returns the per-kernel max |kernel - plain| over all shapes (must be
    0)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(0)

    def bits(w, n):
        return torch.randint(-(1 << 31), 1 << 31, (w, n), dtype=torch.int32,
                             device=device, generator=gen)

    err = {name: 0 for name in KERNELS}

    def note(name, *pairs):
        err[name] = max(err[name], *(max_abs_err(a, b) for a, b in pairs))

    def check_shift(rec, fr, n, offset=0):
        for _, topo, kw in shift_modes(n, topology):
            dirs = structured.shift_dirs(topo, n, **kw)
            note("shift_exchange", (kernels.shift_exchange(fr, dirs),
                                    kernels.shift_exchange_plain(fr, dirs)))
            rk = at_offset(rec, offset)
            nk = at_offset(torch.empty_like(fr), offset)
            kernels.shift_flood_round(rk, fr, nk, dirs)
            rp, np_ = rec.clone(), torch.empty_like(fr)
            kernels.shift_flood_round_plain(rp, fr, np_, dirs)
            note("shift_flood_round", (rk, rp), (nk, np_))

    for w, n in shift_edges(kernels.SHIFT_TILE):
        for offset in (0, 1):
            fr = bits(w, n)
            check_shift(at_offset(bits(w, n), offset),
                        at_offset(fr, offset), n, offset)
            check_masked(kernels, structured, topology, note, fr,
                         w + n + offset, offset)
    # the coins at every n of the shift edges and the shapes, once an n
    for n in sorted({n for _, n in shift_edges(kernels.SHIFT_TILE)
                     + CHECK_SHAPES + MAIN_SHAPES} | set(COIN_BLOCK_NS)):
        for offset in (0, 1):
            check_coins(kernels, structured, topology, note, n, n + offset,
                        device, offset)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    check_tree(kernels, note, bits)
    for w, n in CHECK_SHAPES + RING_SHAPES + MAIN_SHAPES:
        for offset in (0, 1):
            check_ring(kernels, structured, topology, note, w, n,
                       w + n + offset, device, offset)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    lib = kernels._lib("gather_flood")
    for w in (1, 3, 8, 32, 128, 256):
        if lib.gg_gather_nodes_per_block(w, 1) \
                != kernels.gather_nodes_per_block(w):
            raise AssertionError(f"gather geometry at W = {w}: the library "
                                 "and kernels.gather_nodes_per_block differ")
    flib = kernels._lib("fault_flood")
    for w in (1, 3, 8, 32, 128, 256):
        if flib.gg_faulted_nodes_per_block(w, 1) \
                != kernels.gather_nodes_per_block(w):
            raise AssertionError(f"faulted_gather_round's geometry at W = "
                                 f"{w} is not gather_nodes_per_block's")
    for w, n, d, n_src in gather_edges(kernels.gather_nodes_per_block):
        case = gather_case(w, n, d, n_src, n + d, device)
        for offset in (0, 1):
            check_gather(kernels, note, *case, offset=offset)
        # node ids index up: the faulted round's payload covers every node
        case = fault_case(w, n, d, max(n, n_src), n + d, device)
        b = kernels.gather_nodes_per_block(w)
        lo = min(b // 2 + 1, n - 1)           # a slab off the block grid
        for lo, hi, offset in ((0, n, 0), (0, n, 1),
                               (lo, max(n - 3, lo + 1), 1)):
            check_faults(kernels, note, case, lo, hi, offset)
    for w, n in CHECK_SHAPES + MAIN_SHAPES:
        rec, fr = bits(w, n), bits(w, n)
        note("tree_exchange", (kernels.tree_exchange(fr, BRANCHING),
                               kernels.tree_exchange_plain(fr, BRANCHING)))
        rk, nk = rec.clone(), torch.empty_like(fr)
        kernels.tree_flood_round(rk, fr, nk, BRANCHING)
        rp, np_ = rec.clone(), torch.empty_like(fr)
        kernels.tree_flood_round_plain(rp, fr, np_, BRANCHING)
        note("tree_flood_round", (rk, rp), (nk, np_))
        note("col_popcount", (kernels.col_popcount(rec),
                              kernels.col_popcount_plain(rec)))
        check_shift(rec, fr, n)
        if (w, n) in CHECK_SHAPES + MAIN_SHAPES:
            for offset in (0, 1):
                check_masked(kernels, structured, topology, note, fr,
                             w + n + offset, offset)
        del rec, fr, rk, nk, rp, np_
        payload, recv, nbrs, live = gather_inputs(w, n, n + w, device,
                                                  topology)
        check_gather(kernels, note, payload, recv, nbrs, live)
        note("col_popcount_nm", (
            kernels.col_popcount(payload, node_major=True),
            kernels.col_popcount_plain(payload, node_major=True)))
        del payload, recv, nbrs, live
        if (w, n) in GATHER_SHAPES:
            case = fault_case(w, n, DEGREE, n, n + w, device)
            check_faults(kernels, note, case)
            if w == 1:          # an unaligned slab of 4-byte-offset views
                check_faults(kernels, note, case, 1001, n - 77, 1)
            del case
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    check_counter(kernels, note, device)
    check_kafka(kernels, note, device)
    check_kafka_blocks(kernels, note, device)
    check_and_fold(kernels, note, device)
    check_prov(kernels, note, device)
    check_prov_blocks(kernels, note, device)
    check_txn(kernels, note, device)
    check_txn_blocks(kernels, note, device)
    check_batched_faults(kernels, note, device)
    bad = {k: v for k, v in err.items() if v != 0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"(tolerance 0): {bad}")
    return err


def nemesis_spec(faults, n: int, dup: bool):
    """Config 4b's full nemesis (benchmarks/fault_sweep.py's faulted-round
    spec at this phase's rounds): a crash window over rounds [2, 12) of
    every 97th node, loss 0.1 and, with ``dup``, dup 0.05 until round 13,
    seed 0."""
    kw = dict(n_nodes=n, seed=0, crash=((2, 12, tuple(range(0, n, 97))),),
              loss_rate=0.1, loss_until=13)
    if dup:
        kw.update(dup_rate=0.05, dup_until=13)
    return faults.NemesisSpec(**kw)


def tree_nemesis_spec(faults, n: int):
    """benchmarks/fault_sweep.py's structured plan (``_faulted_round_row``
    at 16 rounds): every 97th node down over rounds [2, 16), loss 0.1 and
    dup 0.05 until round 17, seed 5."""
    return faults.NemesisSpec(
        n_nodes=n, seed=5, crash=((2, 16, tuple(range(0, n, 97))),),
        loss_rate=0.1, loss_until=17, dup_rate=0.05, dup_until=17)


def loss_only_spec(faults, n: int):
    """The accounted circulant phase's loss-only plan: loss 0.1 until
    round 13, seed 0."""
    return faults.NemesisSpec(n_nodes=n, seed=0, loss_rate=0.1,
                              loss_until=13)


def config4c_parts(broadcast, n: int):
    """run_all.py config4c's schedule: one half/half window over rounds
    [2, 24), groups ``default_rng(7).integers(0, 2, n)``; returns
    (Partitions, (1, n) groups)."""
    import numpy as np

    group = np.random.default_rng(7).integers(0, 2, n).astype(
        np.int8)[None, :]
    return broadcast.Partitions.from_numpy([2], [24], group), group


def _timed(name, kern, plain, bound_ms_by) -> dict:
    b_ms, b_by = bound_ms_by
    dev_ms = device_ms(kern, KERNELS[name][2], calls=10, attempts=6)
    return {"ms": cuda_ms(kern), "device_ms": dev_ms,
            "plain_ms": cuda_ms(plain, samples=3, inner=1), "bound_ms": b_ms,
            "bound_by": b_by,
            "bound_share": None if dev_ms is None else b_ms / dev_ms}


def idle_share(busy_ms: float | None, wall_ms: float) -> float | None:
    return None if busy_ms is None else 1 - busy_ms / wall_ms


def time_kernels(kernels, structured, topology, device) -> dict:
    """{kernel: {(w, n): {ms, device_ms, plain_ms, bound_ms, bound_by}}}
    at the main path's shapes.  ``ms`` is the CUDA-event time of
    back-to-back calls (the host's launch path included), ``device_ms``
    the profiler's device time of one launch.  Bounds count each input
    read once and each output written once."""
    import torch

    gen = torch.Generator(device=device).manual_seed(1)
    k = BRANCHING
    out = {name: {} for name in KERNELS}
    for w, n in MAIN_SHAPES:
        rec = torch.randint(-(1 << 31), 1 << 31, (w, n), dtype=torch.int32,
                            device=device, generator=gen)
        fr = torch.randint(-(1 << 31), 1 << 31, (w, n), dtype=torch.int32,
                           device=device, generator=gen)
        nxt = torch.empty_like(fr)
        words = w * n
        dirs = structured.shift_dirs(
            "circulant", n,
            strides=topology.expander_strides(n, DEGREE, seed=0))
        n_dirs = len(dirs.offs)
        runs = {
            "tree_exchange": (
                lambda: kernels.tree_exchange(fr, k),
                lambda: kernels.tree_exchange_plain(fr, k),
                bound(2 * 4 * words, k * words)),
            # received is updated in place: every call does the same work
            "tree_flood_round": (
                lambda: kernels.tree_flood_round(rec, fr, nxt, k),
                lambda: kernels.tree_flood_round_plain(rec, fr, nxt, k),
                bound(4 * 4 * words, (k + 3) * words)),
            "col_popcount": (
                lambda: kernels.col_popcount(fr),
                lambda: kernels.col_popcount_plain(fr),
                bound(4 * words + 4 * n, 2 * words)),
            "shift_exchange": (
                lambda: kernels.shift_exchange(fr, dirs),
                lambda: kernels.shift_exchange_plain(fr, dirs),
                bound(2 * 4 * words, n_dirs * words)),
            "shift_flood_round": (
                lambda: kernels.shift_flood_round(rec, fr, nxt, dirs),
                lambda: kernels.shift_flood_round_plain(rec, fr, nxt, dirs),
                bound(4 * 4 * words, (n_dirs + 3) * words)),
        }
        for name, (kern, plain, b) in runs.items():
            out[name][(w, n)] = _timed(name, kern, plain, b)
        del rec, fr, nxt
        torch.cuda.empty_cache()
    # the gather kernels at the main path's node-major (2^20, W), degree
    # 8, fault-free (no edge mask: every index >= 0 delivers), keyed
    # (W, N) like the rest
    from gossip_glomers_tpu_torch.tpu_sim import broadcast, faults

    nbrs = torch.from_numpy(topology.random_regular(N_NODES, DEGREE,
                                                    seed=0)).to(device)
    # the fault kernels at the nemesis phase's round 5: its crash window
    # down, loss and dup active, the server ledger off
    plan = nemesis_spec(faults, N_NODES, dup=True).compile(device)
    up = faults.node_up(plan, 5, torch.arange(N_NODES, device=device))
    coins = broadcast._coins(plan, 5, True, out_ok=False)
    flags = kernels.fault_coins(nbrs, up, **coins)
    n_send, n_del, n_dup = (int(((flags & bit) != 0).sum()) for bit in (
        kernels.FLAG_SEND, kernels.FLAG_DEL, kernels.FLAG_DUP))
    for w, n in GATHER_SHAPES:
        payload, recv, _, _ = gather_inputs(w, n, 2, device, topology)
        edges, words = n * DEGREE, n * w
        runs = {
            "gather_or": (
                lambda: kernels.gather_or(payload, nbrs),
                lambda: kernels.gather_or_plain(payload, nbrs),
                bound(4 * words + 4 * edges + 4 * words, 2 * edges * w)),
            "gather_flood_round": (
                lambda: kernels.gather_flood_round(payload, recv, nbrs),
                lambda: kernels.gather_flood_round_plain(payload, recv, nbrs),
                bound(2 * 4 * words + 4 * edges + 2 * 4 * words,
                      (2 * edges + 3 * n) * w)),
            "sync_diff_pc": (
                lambda: kernels.sync_diff_pc(payload, recv, nbrs),
                lambda: kernels.sync_diff_pc_plain(payload, recv, nbrs),
                bound(2 * 4 * words + 4 * edges + 4, 4 * edges * w)),
            "col_popcount_nm": (
                lambda: kernels.col_popcount(payload, node_major=True),
                lambda: kernels.col_popcount_plain(payload, node_major=True),
                bound(4 * words + 4 * n, 2 * words)),
            # the table, up and the flag bytes; a hash of some 13 integer
            # operations a drawn coin (loss on every sent edge, dup on
            # every delivered one) and a few an edge besides.  Its W is
            # the state's, not its own: the same work at both shapes
            "fault_coins": (
                lambda: kernels.fault_coins(nbrs, up, **coins),
                lambda: kernels.fault_coins_plain(nbrs, up, **coins),
                bound(4 * edges + n + edges,
                      13 * (n_send + n_del) + 8 * edges)),
            # payload and rec0 (also the dup rows), the table, the flags,
            # new and rec_next: an OR a delivered or duplicated word, a
            # popcount a duplicated one, and the merge
            "faulted_gather_round": (
                lambda: kernels.faulted_gather_round(payload, recv, recv,
                                                     nbrs, flags),
                lambda: kernels.faulted_gather_round_plain(
                    payload, recv, recv, nbrs, flags),
                bound(2 * 4 * words + 5 * edges + 2 * 4 * words + 8,
                      (2 * (n_del + n_dup) + n_dup) * w + 3 * n * w)),
        }
        for name, (kern, plain, b) in runs.items():
            out[name][(w, n)] = _timed(name, kern, plain, b)
        del payload, recv
        torch.cuda.empty_cache()
    del nbrs, flags, plan, up
    # the masked exchanges and the words-major coins on the rows of the
    # structured fault phases at round 5: the tree nemesis's two delivery
    # rows, the circulant's eight under config4c's window; the exchanges
    # at both main shapes, the coins (their own (D, N) rows) once
    n, k = N_NODES, BRANCHING
    spec = tree_nemesis_spec(faults, n)
    plan = spec.compile(device)
    arrs = structured.make_nemesis("tree", n, spec, device=device).arrs
    live = faults.wm_live_rows(plan, 5, arrs, (), ())
    rows, _ = faults.wm_live_del(plan, 5, arrs, (), (), True)
    strides = topology.expander_strides(n, DEGREE, seed=0)
    dirs = structured.shift_dirs("circulant", n, strides=strides)
    exists, same = structured.fault_masks(
        "circulant", n, config4c_parts(broadcast, n)[1], strides=strides)
    circ = kernels.pack_bits(torch.from_numpy(exists & same[0])).to(device)
    coins = dict(t=5, seed=plan.seed, loss_num=plan.loss_num,
                 dup_num=plan.dup_num, loss=True, dup=True, srv=False)
    nw, d_circ, d_tree = kernels.packed_words(n), len(dirs.offs), 2
    for w, _ in MAIN_SHAPES:
        fr = torch.randint(-(1 << 31), 1 << 31, (w, n), dtype=torch.int32,
                           device=device, generator=gen)
        words = w * n
        runs = {
            # the payload, the inbox and the two packed rows; a bit, a
            # load, an AND and an OR for the parent and each child
            "tree_masked_exchange": (
                lambda: kernels.tree_masked_exchange(fr, rows[0], rows[1],
                                                     k),
                lambda: kernels.tree_masked_exchange_plain(fr, rows[0],
                                                           rows[1], k),
                bound(2 * 4 * words + 2 * 4 * nw, 3 * (k + 1) * words)),
            "shift_masked_exchange": (
                lambda: kernels.shift_masked_exchange(fr, circ, dirs),
                lambda: kernels.shift_masked_exchange_plain(fr, circ, dirs),
                bound(2 * 4 * words + 4 * d_circ * nw, 3 * d_circ * words)),
        }
        for name, (kern, plain, b) in runs.items():
            out[name][(w, n)] = _timed(name, kern, plain, b)
        # the masked shift kernel's tile, the design's alternative: smaller
        # tiles give an SM more blocks (its device ms by tile cap)
        out["shift_masked_exchange"][(w, n)]["device_ms_by_tile"] = {
            tile: device_ms(
                lambda: kernels.shift_masked_exchange(fr, circ, dirs, tile),
                KERNELS["shift_masked_exchange"][2], calls=10)
            for tile in MASKED_TILES}
        del fr
        torch.cuda.empty_cache()
    # the words-major coins, keyed (D, N): the tree nemesis's two delivery
    # rows at round 5 (loss and dup), and the eight degree rows in ledger
    # mode of the loss-only plan under config4c's window at round 5 (the
    # accounted circulant phase's); the packed rows in, one or two out,
    # and the integer operations the coins drawn need (coin_ops)
    loss_spec = loss_only_spec(faults, n)
    loss_plan = loss_spec.compile(device)
    parts, group = config4c_parts(broadcast, n)
    carrs = structured.make_nemesis("circulant", n, loss_spec, groups=group,
                                    device=device, strides=strides).arrs
    clive = faults.wm_live_rows(loss_plan, 5, carrs, parts.starts,
                                parts.ends, deg=True)
    cases = {(d_tree, n): (arrs.coin_dirs, arrs.src, arrs.dst, live, coins),
             (len(strides) * 2, n): (
                 carrs.deg_coin_dirs, carrs.deg_src, carrs.deg_dst, clive,
                 dict(t=5, seed=loss_plan.seed, loss_num=loss_plan.loss_num,
                      dup_num=loss_plan.dup_num, loss=True, dup=False,
                      srv=True))}
    for key, (cdirs, src, dst, lv, kw) in cases.items():
        d = cdirs.shape[0]
        # the coins this input draws: delivery, a loss coin a live edge
        # and a dup coin a delivered one; ledger, a reply coin a live
        # edge and a forward coin an edge whose reply was kept (out0)
        n_live = int(kernels.popcount(lv).sum())
        kept = int(kernels.popcount(
            kernels.wm_fault_coins(cdirs, n, lv, **kw)[0]).sum())
        n_loss = (n_live + kept if kw["srv"] else n_live) if kw["loss"] \
            else 0
        n_dup = kept if kw["dup"] and not kw["srv"] else 0
        moved = 4 * d * nw * (2 if kw["srv"] or kw["dup"] else 1) + 4 * d * nw
        ops = coin_ops(cdirs, n, n_loss, n_dup)
        out["wm_fault_coins"][key] = _timed(
            "wm_fault_coins",
            lambda: kernels.wm_fault_coins(cdirs, n, lv, **kw),
            lambda: kernels.wm_fault_coins_plain(src, dst, lv, **kw),
            bound(moved, ops))
        out["wm_fault_coins"][key].update({
            "ops": ops, "live_edges": n_live, "loss_coins": n_loss,
            "dup_coins": n_dup})
    time_ring_kernels(kernels, structured, out, gen, strides, device)
    time_counter(kernels, device, out)
    time_kafka(kernels, device, out)
    time_kafka_blocks(kernels, device, out)
    time_and_fold(kernels, device, out)
    return out


def delay_rows(d: int, n: int):
    """run_all.py config4d's law: ``default_rng(11).choice([1, 3], (d,
    n), p=[0.7, 0.3])``, and the generator, which draws the per-direction
    delays next."""
    import numpy as np

    rng = np.random.default_rng(11)
    return rng.choice([1, 3], (d, n), p=[0.7, 0.3]).astype(np.int32), rng


def ring_table(ed, t: int, class_rows):
    """The ring kernel's operands that an edge-delayed bundle ``ed``
    builds at round ``t``: (table, packed rows) — the tree's (slot, kind,
    row) entries or a shift ring table — and, per delay class, the
    (slot, rows) of the masked exchange that the composition launches."""
    import torch

    ring = ed.ring
    terms = [(d, (t - (v - 1)) % ring, j)
             for j, (d, v) in enumerate(ed.classes) if t - (v - 1) >= 0]
    per_class = {v: ((t - (v - 1)) % ring, [j for j, (_, u) in
                                            enumerate(ed.classes) if u == v])
                 for v in ed.delay_set if t - (v - 1) >= 0}
    live = class_rows[[j for _, _, j in terms]]
    return terms, live, per_class


def time_ring_kernels(kernels, structured, out, gen, strides, device):
    """The ring kernels on the delay phases' edge-delayed tables at round
    5 (classes {1, 3} both in flight, from slots 2 and 0 of a 3-slot
    ring): the tree's 2 |V| = 4 terms (w1_tree_edge_delayed) and the
    circulant's 8 directions x 2 classes = 16 rows
    (w1_circulant_delayed), at both main shapes; beside the composition
    they replace (per class one masked exchange of its slot, ORed) and
    its device time (its masked launches).  Bounds: each slot read once,
    each packed row once, the inbox written once; an AND and an OR a term
    and word (the tree's kids term k of each)."""
    import torch

    n, t, k = N_NODES, 5, BRANCHING
    nw = kernels.packed_words(n)
    rows_t, _ = delay_rows(2, n)
    rows_c, _ = delay_rows(2 * len(strides), n)
    tree_ed = structured.make_edge_delayed("tree", n, rows_t)
    circ_ed = structured.make_edge_delayed("circulant", n, rows_c,
                                           strides=strides)
    dirs = structured.shift_dirs("circulant", n, strides=strides)
    for w, _ in MAIN_SHAPES:
        ring = torch.randint(-(1 << 31), 1 << 31, (3, w, n),
                             dtype=torch.int32, device=device, generator=gen)
        words = w * n
        cases = {}
        # the tree: (slot, kind, row) entries over the class rows
        cr = tree_ed.class_rows(device)
        terms, live, per_class = ring_table(tree_ed, t, cr)
        table = [(slot, kernels.TREE_PARENT if d == 0 else kernels.TREE_KIDS,
                  j) for j, (d, slot, _) in enumerate(terms)]
        zero = torch.zeros(nw, dtype=torch.int32, device=device)

        def tree_comp(ring=ring, cr=cr, per_class=per_class):
            acc = None
            for slot, js in per_class.values():
                rows = {tree_ed.classes[j][0]: cr[j] for j in js}
                term = kernels.tree_masked_exchange(
                    ring[slot], rows.get(0, zero), rows.get(1, zero), k)
                acc = term if acc is None else acc | term
            return acc

        ops = sum(k if kind == kernels.TREE_KIDS else 1
                  for _, kind, _ in table) * 2 * words
        cases["tree_ring_exchange"] = (
            lambda: kernels.tree_ring_exchange(ring, table, live, k),
            lambda: kernels.tree_ring_exchange_plain(ring, table, live, k),
            bound(4 * 2 * words + 4 * nw * len(table) + 4 * words, ops),
            tree_comp, "tree_masked_exchange", len(per_class), len(table))
        # the circulant: a 16-row ring table
        cr_c = circ_ed.class_rows(device)
        terms_c, live_c, per_c = ring_table(circ_ed, t, cr_c)
        rtable = kernels.ShiftDirs(
            tuple(dirs.offs[d] for d, _, _ in terms_c),
            tuple(dirs.flags[d] for d, _, _ in terms_c), dirs.cols,
            tuple(slot for _, slot, _ in terms_c))
        # the composition's per-class rows: every direction, its bit where
        # the class holds the edge
        comp_rows = {}
        for v, (slot, js) in per_c.items():
            rows = torch.zeros((len(dirs.offs), nw), dtype=torch.int32,
                               device=device)
            for j in js:
                rows[circ_ed.classes[j][0]] = cr_c[j]
            comp_rows[v] = (slot, rows)

        def circ_comp(ring=ring, comp_rows=comp_rows):
            acc = None
            for slot, rows in comp_rows.values():
                term = kernels.shift_masked_exchange(ring[slot], rows, dirs)
                acc = term if acc is None else acc | term
            return acc

        cases["shift_ring_exchange"] = (
            lambda: kernels.shift_ring_exchange(ring, rtable, live_c),
            lambda: kernels.shift_ring_exchange_plain(ring, rtable, live_c),
            bound(4 * 2 * words + 4 * nw * len(terms_c) + 4 * words,
                  2 * len(terms_c) * words),
            circ_comp, "shift_masked_exchange", len(comp_rows),
            len(terms_c))
        for name, (kern, plain, b, comp, masked, launches,
                   rows) in cases.items():
            if not torch.equal(kern(), comp()):
                raise AssertionError(f"{name} differs from the composition "
                                     "of masked exchanges it replaces")
            rec = _timed(name, kern, plain, b)
            masked_ms = device_ms(comp, KERNELS[masked][2], calls=10)
            rec.update({
                "table_rows": rows, "slots_read": 2,
                "composition_ms": cuda_ms(comp),
                "composition_launches": launches,
                "composition_device_ms": None if masked_ms is None
                else launches * masked_ms})
            out[name][(w, n)] = rec
        # the shift ring plan on a line of its own: its tile, stages and
        # windows; each payload word crosses from L2 to the SMs once a
        # window (the floor above the bytes bound at the L2 probe's rate)
        plan = list(kernels._shift_plan(rtable, n, False, kernels.SHIFT_TILE,
                                        True)[0])
        emit({"phase": "ring_plan", "kernel": "shift_ring_exchange",
              "at": [w, n], "table_rows": len(terms_c), "tile": plan[0],
              "stages": plan[1], "stage_bytes": 4 * plan[2],
              "windows": plan[5],
              "l2_floor_ms": plan[5] * 4 * words / L2_BYTES_PER_S * 1e3})
        del ring
        torch.cuda.empty_cache()


def same_state(a, b) -> bool:
    return (a.t == b.t and int(a.msgs) == int(b.msgs)
            and bool((a.received.cpu() == b.received.cpu()).all())
            and (a.srv_msgs is None) == (b.srv_msgs is None)
            and (a.srv_msgs is None or int(a.srv_msgs) == int(b.srv_msgs)))


def fixed_run(timing, broadcast, topology: str, n: int, n_values: int,
              device: str, **kw):
    sim = timing.structured_sim(topology, n, n_values, device=device, **kw)
    rounds = timing.discover_rounds(topology, n, n_values, **kw)
    state0, target = sim.stage(broadcast.make_inject(n, n_values))
    final = sim.run_staged_fixed(state0, rounds)
    if not sim.converged(final, target):
        raise AssertionError(f"{device} {topology} fixed run at n={n} did "
                             "not converge")
    return final


class Launches:
    """Per-phase kernel launch counts, summed over the main-path phases
    and kept per phase."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.total = {name: 0 for name in kernels.LAUNCHES}
        self.by_phase: dict[str, dict] = {}

    def start(self) -> None:
        import torch

        self.kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()

    def split(self, name: str) -> dict:
        """One kernel's launches by path: the 1M-node floods at W = 128
        and at W = 1 (gather phases included), the small floods, and the
        mesh phases' ranks."""
        out = {"n1m_w128": 0, "n1m_w1": 0, "small_floods": 0, "mesh": 0}
        for phase, counts in self.by_phase.items():
            key = ("small_floods" if phase == "small_floods" else
                   "mesh" if phase.startswith("mesh_") else
                   "n1m_w128" if phase.startswith("w128_") else "n1m_w1")
            out[key] += counts[name]
        return out

    def add_ranks(self, rec: dict, counts: list, expect) -> None:
        """A mesh phase's launches: the sum of its ranks' counts (each
        rank reset them before a run of the path and read them after; the
        parent's comparison runs are not counted).  Fails if a kernel of
        the path was never launched."""
        total = {name: 0 for name in self.total}
        for c in counts:
            for name, v in c.items():
                total[name] += v
        rec["launches"] = {k: v for k, v in total.items() if v}
        for name, v in total.items():
            self.total[name] += v
        self.by_phase[rec["phase"]] = total
        missing = [name for name in expect if not total[name]]
        if missing:
            raise AssertionError(f"{rec['phase']}: kernels {missing} were "
                                 "never launched on the ranks")

    def stop(self, rec: dict, expect: tuple) -> None:
        import torch

        torch.cuda.synchronize()
        counts = dict(self.kernels.LAUNCHES)
        rec["launches"] = {k: v for k, v in counts.items() if v}
        rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        for name, count in counts.items():
            self.total[name] += count
        self.by_phase[rec["phase"]] = counts
        missing = [name for name in expect if counts[name] == 0]
        if missing:
            raise AssertionError(f"{rec['phase']}: kernels {missing} were "
                                 "never launched")


def timed_phase(name: str, topo: str, n_values: int, kw: dict, n_dirs: int,
                timing, broadcast, device) -> tuple[dict, object]:
    """The timed fixed-trip flood of one main-path entry; returns its
    JSON record and final state."""
    import torch

    res = timing.bench_structured(
        N_NODES, [(name, topo, n_values, kw, n_dirs)], device=device)[name]
    state = res["_state"]
    if state.t != res["rounds"]:
        raise AssertionError(f"{name}: t = {state.t}")
    if int(state.msgs) != res["msgs64"] % (1 << 32):
        raise AssertionError(f"{name}: msgs {int(state.msgs)} is not the "
                             f"closed form {res['msgs64']} mod 2^32")
    # one more run of the loop under the profiler: the device's busy time
    # against the timed wall gives its idle share
    sim = timing.structured_sim(topo, N_NODES, n_values, device=device,
                                **kw)
    loop_fn, _ = sim.build_fixed(res["rounds"], donate=True)
    inject = broadcast.make_inject(N_NODES, n_values)

    def staged():
        state0, _ = sim.stage(inject)
        return lambda: loop_fn(state0.received, state0.frontier)

    busy_ms = device_busy_ms(staged)
    from gossip_glomers_tpu_torch.tpu_sim import kernels

    port = launches_of(kernels, staged())
    del sim
    torch.cuda.synchronize()
    record = {"phase": name, "n": N_NODES, "n_values": n_values,
              "port_launches_per_round": port / res["rounds"],
              "rounds": res["rounds"], "wall_ms": res["wall_s"] * 1e3,
              "samples_ms": [s * 1e3 for s in res["samples_s"]],
              "ms_per_round": res["ms_per_round"],
              "gbytes_per_s_lb": res["gbytes_per_s_lb"],
              "device_busy_ms": busy_ms,
              "device_idle_share": idle_share(busy_ms, res["wall_s"] * 1e3),
              "msgs": int(state.msgs), "msgs64": res["msgs64"]}
    return record, state


def w1_structured(name: str, topo: str, kw: dict, n_dirs: int, expect,
                  modules, device, launches: Launches,
                  want_rounds: int | None = None, gather_nbrs=None) -> None:
    """A W = 1 structured phase: the timed flood, the accounted run with
    the server ledger on, the CPU path at the same size, and (given
    ``gather_nbrs``) the node-major gather path on the same graph."""
    import torch

    broadcast, timing = modules
    launches.start()
    rec, state = timed_phase(name, topo, W1_VALUES, kw, n_dirs, timing,
                             broadcast, device)
    if want_rounds is not None and rec["rounds"] != want_rounds:
        raise AssertionError(f"{name}: {rec['rounds']} rounds, expected "
                             f"{want_rounds}")
    acct = timing.structured_sim(topo, N_NODES, W1_VALUES, srv_ledger=True,
                                 device=device, **kw)
    inject = broadcast.make_inject(N_NODES, W1_VALUES)
    state_a, rounds_a = acct.run_fused(inject)
    if rounds_a != rec["rounds"] or int(state_a.msgs) != rec["msgs"]:
        raise AssertionError(f"{name} accounted run: {rounds_a} rounds, "
                             f"msgs {int(state_a.msgs)}; fixed run: "
                             f"{rec['rounds']}, {rec['msgs']}")
    if gather_nbrs is not None:
        gsim = broadcast.BroadcastSim(gather_nbrs, n_values=W1_VALUES,
                                      sync_every=acct.sync_every,
                                      device=device)
        state_g, rounds_g = gsim.run_fused(inject)
        if not (rounds_g == rounds_a and int(state_g.msgs) == rec["msgs"]
                and int(state_g.srv_msgs) == int(state_a.srv_msgs)
                and (gsim.received_node_major(state_g)
                     == acct.received_node_major(state_a)).all()):
            raise AssertionError(f"{name}: the gather path on the same "
                                 "graph differs from the structured path")
        rec["gather_rounds"] = rounds_g
        del state_g, gsim
    launches.stop(rec, expect)
    # the port's plain CPU path at the same size, bit for bit
    cpu_fixed = fixed_run(timing, broadcast, topo, N_NODES, W1_VALUES,
                          "cpu", **kw)
    cpu_acct = timing.structured_sim(topo, N_NODES, W1_VALUES,
                                     srv_ledger=True, device="cpu", **kw)
    cpu_state_a, cpu_rounds_a = cpu_acct.run_fused(inject)
    if not (same_state(state, cpu_fixed) and cpu_rounds_a == rounds_a
            and same_state(state_a, cpu_state_a)):
        raise AssertionError(f"{name}: GPU run differs from the CPU path")
    rec.update({"srv_msgs": acct.server_msgs(state_a),
                "accounted_rounds": rounds_a, "cpu_match": True})
    emit(rec)
    del state, state_a, acct, cpu_fixed, cpu_state_a
    torch.cuda.empty_cache()


def w128_structured(name: str, topo: str, kw_for, n_dirs: int, expect,
                    modules, device, launches: Launches,
                    want_rounds: int | None = None) -> None:
    """A W = 128 structured phase: the timed flood and its unwrapped
    ledger, then the GPU path against the CPU path at CHECK_NODES."""
    import torch

    broadcast, timing = modules
    launches.start()
    rec, state = timed_phase(name, topo, W128_VALUES, kw_for(N_NODES),
                             n_dirs, timing, broadcast, device)
    if want_rounds is not None and rec["rounds"] != want_rounds:
        raise AssertionError(f"{name}: {rec['rounds']} rounds, expected "
                             f"{want_rounds}")
    launches.stop(rec, expect)
    del state
    torch.cuda.empty_cache()
    kw = kw_for(CHECK_NODES)
    gpu_small = fixed_run(timing, broadcast, topo, CHECK_NODES, W128_VALUES,
                          device, **kw)
    cpu_small = fixed_run(timing, broadcast, topo, CHECK_NODES, W128_VALUES,
                          "cpu", **kw)
    if not same_state(gpu_small, cpu_small):
        raise AssertionError(f"{name}: GPU run differs from the CPU path "
                             f"at n={CHECK_NODES}")
    rec.update({"cpu_check_n": CHECK_NODES, "cpu_match": True})
    emit(rec)


GATHER_EXPECT = ("gather_flood_round", "col_popcount_nm", "sync_diff_pc")


def gather_phases(modules, topology, device, launches: Launches) -> None:
    """Config 4b, the uniform random-regular epidemic through the
    node-major gather: fault-free (timed, then accounted) and under one
    half/half partition window."""
    import numpy as np
    import torch

    broadcast, timing = modules
    nbrs = topology.random_regular(N_NODES, DEGREE, seed=0)
    inject = broadcast.make_inject(N_NODES, W1_VALUES)

    def sim(device, **kw):
        return broadcast.BroadcastSim(nbrs, n_values=W1_VALUES,
                                      device=device, **kw)

    launches.start()
    fast = sim(device, sync_every=1 << 20, srv_ledger=False)
    _, rounds = fast.run(inject)                # host-stepped discovery
    tr = timing.TimedRun(fast, inject, rounds)
    tr.prepare()
    tr.sample(3)
    wall_s, _, state = tr.finish()

    def staged():
        state0, _ = fast.stage(inject)
        return lambda: fast.run_staged_fixed(state0, rounds, donate=True)

    busy_ms = device_busy_ms(staged)
    port = launches_of(launches.kernels, staged())
    rec = {"phase": "w1_random_regular", "n": N_NODES, "degree": DEGREE,
           "n_values": W1_VALUES, "rounds": rounds, "wall_ms": wall_s * 1e3,
           "port_launches_per_round": port / rounds,
           "samples_ms": [s * 1e3 for s in tr.samples],
           "ms_per_round": wall_s / rounds * 1e3, "device_busy_ms": busy_ms,
           "device_idle_share": idle_share(busy_ms, wall_s * 1e3),
           "msgs": int(state.msgs)}
    acct = sim(device, sync_every=4)
    state_a, rounds_a = acct.run_fused(inject)
    launches.stop(rec, GATHER_EXPECT)
    cpu_a, cpu_rounds_a = sim("cpu", sync_every=4).run_fused(inject)
    if not (cpu_rounds_a == rounds_a and same_state(state_a, cpu_a)):
        raise AssertionError("w1_random_regular: GPU accounted run differs "
                             "from the CPU path")
    rec.update({"accounted_sync_every": 4, "accounted_rounds": rounds_a,
                "accounted_msgs": int(state_a.msgs),
                "srv_msgs": acct.server_msgs(state_a), "cpu_match": True})
    emit(rec)
    del fast, tr, state, acct, state_a, cpu_a
    torch.cuda.empty_cache()

    group = np.random.default_rng(7).integers(0, 2, N_NODES).astype(
        np.int8)[None, :]
    parts = broadcast.Partitions.from_numpy([2], [24], group)
    launches.start()
    part = sim(device, sync_every=16, parts=parts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state_p, rounds_p = part.run_fused(inject)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if not part.converged(state_p, part.target_bits(inject)) \
            or rounds_p <= 24:
        raise AssertionError(f"w1_random_regular_partitioned: {rounds_p} "
                             "rounds, not converged after the window")
    rec = {"phase": "w1_random_regular_partitioned", "n": N_NODES,
           "n_values": W1_VALUES, "window": [2, 24], "sync_every": 16,
           "rounds": rounds_p, "run_ms_host_clock": run_s * 1e3,
           "msgs": int(state_p.msgs), "srv_msgs": part.server_msgs(state_p)}
    launches.stop(rec, GATHER_EXPECT)
    cpu_p, cpu_rounds_p = sim("cpu", sync_every=16,
                              parts=parts).run_fused(inject)
    if not (cpu_rounds_p == rounds_p and same_state(state_p, cpu_p)):
        raise AssertionError("w1_random_regular_partitioned: GPU run "
                             "differs from the CPU path")
    rec["cpu_match"] = True
    emit(rec)
    del part, state_p, cpu_p
    torch.cuda.empty_cache()


NEMESIS_EXPECT = ("fault_coins", "faulted_gather_round", "col_popcount_nm")


def nemesis_phases(modules, faults, topology, device,
                   launches: Launches) -> None:
    """Config 4b's graph under the Maelstrom nemesis through the faulted
    gather round: crash + loss + dup with the server ledger off (run to
    convergence host-stepped, then the fixed trip timed), and crash +
    loss under config 4c's partition window with the ledger on; each
    held against the CPU path bit for bit."""
    import numpy as np
    import torch

    broadcast, timing = modules
    nbrs = topology.random_regular(N_NODES, DEGREE, seed=0)
    inject = broadcast.make_inject(N_NODES, W1_VALUES)

    def sim(spec, device, **kw):
        return broadcast.BroadcastSim(
            nbrs, n_values=W1_VALUES, fault_plan=spec.compile(device),
            device=device, **kw)

    spec = nemesis_spec(faults, N_NODES, dup=True)
    launches.start()
    nem = sim(spec, device, sync_every=4, srv_ledger=False)
    state, rounds = nem.run(inject)             # host-stepped discovery
    # the crashed rows restart empty at round 12: no run converges before
    # the last faulted round has run
    if not nem.converged(state, nem.target_bits(inject)) \
            or rounds < spec.clear_round:
        raise AssertionError(f"w1_random_regular_nemesis: {rounds} rounds, "
                             "not converged once the faults cleared at "
                             f"round {spec.clear_round}")
    tr = timing.TimedRun(nem, inject, rounds)
    tr.prepare()
    tr.sample(3)
    wall_s, _, fixed = tr.finish()

    def staged():
        state0, _ = nem.stage(inject)
        return lambda: nem.run_staged_fixed(state0, rounds, donate=True)

    busy_ms = device_busy_ms(staged)
    port = launches_of(launches.kernels, staged())
    rec = {"phase": "w1_random_regular_nemesis", "n": N_NODES,
           "port_launches_per_round": port / rounds,
           "degree": DEGREE, "n_values": W1_VALUES, "sync_every": 4,
           "crash": [2, 12, "range(0, n, 97)"], "loss_rate": 0.1,
           "dup_rate": 0.05, "until": 13, "clear_round": spec.clear_round,
           "rounds": rounds, "wall_ms": wall_s * 1e3,
           "samples_ms": [s * 1e3 for s in tr.samples],
           "ms_per_round": wall_s / rounds * 1e3, "device_busy_ms": busy_ms,
           "device_idle_share": idle_share(busy_ms, wall_s * 1e3),
           "msgs": int(state.msgs)}
    launches.stop(rec, NEMESIS_EXPECT)
    cpu, cpu_rounds = sim(spec, "cpu", sync_every=4,
                          srv_ledger=False).run(inject)
    if not (cpu_rounds == rounds and same_state(state, cpu)
            and same_state(fixed, cpu)):
        raise AssertionError("w1_random_regular_nemesis: GPU run differs "
                             "from the CPU path")
    rec["cpu_match"] = True
    keep_run("random_regular_nemesis", nem, state)
    emit(rec)
    del nem, tr, state, fixed, cpu
    torch.cuda.empty_cache()

    spec = nemesis_spec(faults, N_NODES, dup=False)
    group = np.random.default_rng(7).integers(0, 2, N_NODES).astype(
        np.int8)[None, :]
    parts = broadcast.Partitions.from_numpy([2], [24], group)
    launches.start()
    acct = sim(spec, device, sync_every=16, parts=parts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, rounds = acct.run_fused(inject)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if not acct.converged(state, acct.target_bits(inject)) \
            or rounds <= max(24, spec.clear_round):
        raise AssertionError(f"w1_random_regular_nemesis_accounted: {rounds}"
                             " rounds, not converged after the faults")
    rec = {"phase": "w1_random_regular_nemesis_accounted", "n": N_NODES,
           "n_values": W1_VALUES, "sync_every": 16, "window": [2, 24],
           "crash": [2, 12, "range(0, n, 97)"], "loss_rate": 0.1,
           "until": 13, "rounds": rounds, "run_ms_host_clock": run_s * 1e3,
           "msgs": int(state.msgs), "srv_msgs": acct.server_msgs(state)}
    launches.stop(rec, NEMESIS_EXPECT + ("sync_diff_pc",))
    cpu, cpu_rounds = sim(spec, "cpu", sync_every=16,
                          parts=parts).run_fused(inject)
    if not (cpu_rounds == rounds and same_state(state, cpu)):
        raise AssertionError("w1_random_regular_nemesis_accounted: GPU run "
                             "differs from the CPU path")
    rec["cpu_match"] = True
    emit(rec)
    del acct, state, cpu
    torch.cuda.empty_cache()


# each kernel's launches in one trip of each timed path (one staged run
# counted by launches_of or add_trip: no profiler retries, no checks)
TRIP_LAUNCHES: dict[str, int] = {}


def add_trip(kernels, before: dict) -> int:
    """Add the launches since the ``before`` counts to
    :data:`TRIP_LAUNCHES`; returns their total."""
    delta = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
    for k, v in delta.items():
        TRIP_LAUNCHES[k] = TRIP_LAUNCHES.get(k, 0) + v
    return sum(delta.values())


def launches_of(kernels, run) -> int:
    """Port-kernel launches of one call of ``run``, a timed path's trip
    (added to :data:`TRIP_LAUNCHES`)."""
    import torch

    before = dict(kernels.LAUNCHES)
    run()
    torch.cuda.synchronize()
    return add_trip(kernels, before)


def timed_fixed(sim, timing, kernels, inject, rounds: int) -> dict:
    """The fixed trip of ``rounds`` rounds timed with CUDA events (median
    of 3), its device busy time and spans under the profiler, and the
    port-kernel launches of one run; checks that it converges."""
    tr = timing.TimedRun(sim, inject, rounds)
    tr.prepare()
    tr.sample(3)
    wall_s, _, fixed = tr.finish()

    def staged():
        state0, _ = sim.stage(inject)
        return lambda: sim.run_staged_fixed(state0, rounds, donate=True)

    busy_ms, spans = busy_and_spans(staged)
    port = launches_of(kernels, staged())
    return {"wall_ms": wall_s * 1e3,
            "samples_ms": [x * 1e3 for x in tr.samples],
            "ms_per_round": wall_s / rounds * 1e3,
            "device_busy_ms": busy_ms,
            "device_idle_share": idle_share(busy_ms, wall_s * 1e3),
            "port_launches_per_round": port / rounds,
            "device_spans_per_round": None if spans is None
            else spans / rounds}, fixed


def same_run(a_sim, a, b_sim, b) -> bool:
    """Two runs on (possibly) different layouts and devices agree: t,
    ledgers and the received sets."""
    return (a.t == b.t and int(a.msgs) == int(b.msgs)
            and (a.srv_msgs is None) == (b.srv_msgs is None)
            and (a.srv_msgs is None or int(a.srv_msgs) == int(b.srv_msgs))
            and bool((a_sim.received_node_major(a)
                      == b_sim.received_node_major(b)).all()))


def structured_fault_phases(modules, faults, structured, kernels, topology,
                            device, launches: Launches) -> None:
    """Maelstrom's faults on the structured main path at 2^20 nodes:
    config4c's partition window on the circulant, fault_sweep.py's
    structured plan on the tree, and a loss-only plan under config4c's
    window with the server ledger on; each held against the port's CPU
    path and the card's gather path on the same graph."""
    import torch

    broadcast, timing = modules
    n = N_NODES
    inject = broadcast.make_inject(n, W1_VALUES)
    strides = topology.expander_strides(n, DEGREE, seed=0)
    circ_nbrs = topology.circulant(n, strides)
    parts, group = config4c_parts(broadcast, n)

    # -- w1_circulant_partitioned: config4c ---------------------------
    def part_sim(dev, srv):
        return timing.structured_sim("circulant", n, W1_VALUES,
                                     sync_every=16, parts=parts,
                                     srv_ledger=srv, device=dev,
                                     strides=strides)

    launches.start()
    fast = part_sim(device, False)
    state, rounds = fast.run_fused(inject)
    if not fast.converged(state, fast.target_bits(inject)) or rounds <= 24:
        raise AssertionError(f"w1_circulant_partitioned: {rounds} rounds, "
                             "not converged after the window")
    rec = {"phase": "w1_circulant_partitioned", "n": n,
           "n_values": W1_VALUES, "window": [2, 24], "sync_every": 16,
           "rounds": rounds}
    timed, fixed = timed_fixed(fast, timing, kernels, inject, rounds)
    rec.update(timed)
    acct = part_sim(device, True)
    state_a, rounds_a = acct.run_fused(inject)
    gsim = broadcast.BroadcastSim(circ_nbrs, n_values=W1_VALUES,
                                  sync_every=16, parts=parts, device=device)
    state_g, rounds_g = gsim.run_fused(inject)
    launches.stop(rec, ("shift_masked_exchange", "shift_exchange",
                        "col_popcount", "gather_flood_round"))
    if not (rounds_a == rounds_g == rounds and same_run(fast, state, fast,
                                                        fixed)
            and int(state_a.msgs) == int(state.msgs)
            and same_run(acct, state_a, gsim, state_g)):
        raise AssertionError("w1_circulant_partitioned: the fixed, "
                             "accounted and gather runs differ")
    cpu = part_sim("cpu", True)
    cpu_state, cpu_rounds = cpu.run_fused(inject)
    if not (cpu_rounds == rounds and same_run(acct, state_a, cpu,
                                              cpu_state)):
        raise AssertionError("w1_circulant_partitioned: GPU run differs "
                             "from the CPU path")
    rec.update({"msgs": int(state_a.msgs),
                "srv_msgs": acct.server_msgs(state_a),
                "gather_rounds": rounds_g, "cpu_match": True})
    emit(rec)
    del fast, state, fixed, acct, state_a, gsim, state_g, cpu, cpu_state
    torch.cuda.empty_cache()

    # -- w1_tree_nemesis: fault_sweep.py --structured ----------------
    spec = tree_nemesis_spec(faults, n)
    tree_nbrs = topology.to_padded_neighbors(topology.tree(n, BRANCHING))

    def tree_sim(dev, structured_path):
        kw = (dict(exchange=structured.make_exchange("tree", n),
                   nemesis=structured.make_nemesis("tree", n, spec,
                                                   device=dev))
              if structured_path else {})
        return broadcast.BroadcastSim(tree_nbrs, n_values=W1_VALUES,
                                      sync_every=8, srv_ledger=False,
                                      fault_plan=spec.compile(dev),
                                      device=dev, **kw)

    launches.start()
    nem = tree_sim(device, True)
    state, rounds = nem.run(inject)            # host-stepped discovery
    if not nem.converged(state, nem.target_bits(inject)) \
            or rounds < spec.clear_round:
        raise AssertionError(f"w1_tree_nemesis: {rounds} rounds, not "
                             "converged once the faults cleared at round "
                             f"{spec.clear_round}")
    rec = {"phase": "w1_tree_nemesis", "n": n, "n_values": W1_VALUES,
           "sync_every": 8, "crash": [2, 16, "range(0, n, 97)"],
           "loss_rate": 0.1, "dup_rate": 0.05, "until": 17,
           "clear_round": spec.clear_round, "rounds": rounds}
    timed, fixed = timed_fixed(nem, timing, kernels, inject, rounds)
    rec.update(timed)
    gsim = tree_sim(device, False)
    state_g, rounds_g = gsim.run(inject)
    launches.stop(rec, ("tree_masked_exchange", "wm_fault_coins",
                        "col_popcount", "fault_coins",
                        "faulted_gather_round"))
    if not (rounds_g == rounds and same_run(nem, state, nem, fixed)
            and same_run(nem, state, gsim, state_g)):
        raise AssertionError("w1_tree_nemesis: the structured and gather "
                             "runs differ")
    cpu = tree_sim("cpu", True)
    cpu_state, cpu_rounds = cpu.run(inject)
    if not (cpu_rounds == rounds and same_run(nem, state, cpu, cpu_state)):
        raise AssertionError("w1_tree_nemesis: GPU run differs from the "
                             "CPU path")
    rec.update({"msgs": int(state.msgs), "gather_rounds": rounds_g,
                "cpu_match": True})
    keep_run("tree_nemesis", nem, state)
    emit(rec)
    del nem, state, fixed, gsim, state_g, cpu, cpu_state
    torch.cuda.empty_cache()

    # -- w1_circulant_nemesis_accounted: loss-only under config4c -----
    spec = loss_only_spec(faults, n)

    def loss_sim(dev, structured_path):
        kw = (dict(exchange=structured.make_exchange("circulant", n,
                                                     strides=strides),
                   nemesis=structured.make_nemesis(
                       "circulant", n, spec, groups=group, device=dev,
                       strides=strides))
              if structured_path else {})
        return broadcast.BroadcastSim(circ_nbrs, n_values=W1_VALUES,
                                      sync_every=16, parts=parts,
                                      fault_plan=spec.compile(dev),
                                      device=dev, **kw)

    twin = BackgroundTwin(cpu_circulant_accounted, ())
    launches.start()
    acct = loss_sim(device, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, rounds = acct.run_fused(inject)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if not acct.converged(state, acct.target_bits(inject)) \
            or rounds <= max(24, spec.clear_round):
        raise AssertionError(f"w1_circulant_nemesis_accounted: {rounds} "
                             "rounds, not converged after the faults")
    rec = {"phase": "w1_circulant_nemesis_accounted", "n": n,
           "n_values": W1_VALUES, "sync_every": 16, "window": [2, 24],
           "loss_rate": 0.1, "until": 13, "rounds": rounds,
           "run_ms_host_clock": run_s * 1e3, "msgs": int(state.msgs),
           "srv_msgs": acct.server_msgs(state)}
    gsim = loss_sim(device, False)
    state_g, rounds_g = gsim.run_fused(inject)
    launches.stop(rec, ("shift_masked_exchange", "wm_fault_coins",
                        "col_popcount", "fault_coins",
                        "faulted_gather_round"))
    if not (rounds_g == rounds and same_run(acct, state, gsim, state_g)):
        raise AssertionError("w1_circulant_nemesis_accounted: the "
                             "structured and gather runs differ")
    rec["gather_rounds"] = rounds_g
    keep_run("circulant_nemesis_accounted", acct, state)
    card = (rounds, acct.received_node_major(state), int(state.msgs),
            acct.server_msgs(state))

    def hold(rec, cpu):
        # the port's plain CPU path at the same size, bit for bit
        rec["cpu_match"] = (cpu[0] == card[0] and bool(
            (cpu[1] == card[1]).all()) and cpu[2:] == card[2:])
        rec["ok"] = rec["cpu_match"]

    PENDING.append((rec, twin, hold))
    del acct, state, gsim, state_g
    torch.cuda.empty_cache()


def cpu_circulant_accounted() -> tuple:
    """w1_circulant_nemesis_accounted's CPU twin (a background process):
    the structured run on the port's CPU path, its ``(rounds, received,
    msgs, srv_msgs)``."""
    import torch

    from gossip_glomers_tpu_torch.parallel import topology
    from gossip_glomers_tpu_torch.tpu_sim import (broadcast, faults,
                                                  structured)

    torch.set_num_threads(SMALL_TWIN_THREADS)
    n = N_NODES
    strides = topology.expander_strides(n, DEGREE, seed=0)
    parts, group = config4c_parts(broadcast, n)
    spec = loss_only_spec(faults, n)
    sim = broadcast.BroadcastSim(
        topology.circulant(n, strides), n_values=W1_VALUES, sync_every=16,
        parts=parts, fault_plan=spec.compile("cpu"), device="cpu",
        exchange=structured.make_exchange("circulant", n, strides=strides),
        nemesis=structured.make_nemesis("circulant", n, spec, groups=group,
                                        device="cpu", strides=strides))
    state, rounds = sim.run_fused(broadcast.make_inject(n, W1_VALUES))
    return (rounds, sim.received_node_major(state), int(state.msgs),
            sim.server_msgs(state))


def delayed_way(sim, timing, kernels, inject, want_rounds=None) -> tuple:
    """One way of a delay phase on the card: host-stepped discovery, then
    the fixed trip timed (:func:`timed_fixed`), which must equal it.
    Returns (record, final state)."""
    state, rounds = sim.run(inject)
    if not sim.converged(state, sim.target_bits(inject)):
        raise AssertionError(f"{rounds} rounds, not converged")
    if want_rounds is not None and rounds != want_rounds:
        raise AssertionError(f"{rounds} rounds, the gather ring took "
                             f"{want_rounds}")
    timed, fixed = timed_fixed(sim, timing, kernels, inject, rounds)
    if not same_run(sim, state, sim, fixed):
        raise AssertionError("the fixed trip differs from the host-stepped "
                             "run")
    return {"rounds": rounds, **timed, "msgs": int(state.msgs)}, state


def check_cpu(make_sim, gpu_sim, gpu_state, inject, fused=False) -> None:
    """The port's plain CPU path at the same size equals the card's run
    bit for bit (rounds, received, msgs, srv_msgs)."""
    cpu = make_sim("cpu")
    state, rounds = cpu.run_fused(inject) if fused else cpu.run(inject)
    if not (rounds == gpu_state.t
            and same_run(gpu_sim, gpu_state, cpu, state)):
        raise AssertionError("the card's run differs from the CPU path")


def delay_phases(modules, faults, structured, kernels, topology, device,
                 launches: Launches) -> None:
    """Maelstrom's per-hop latency at 2^20 nodes: run_all.py config4d (the
    circulant with per-edge delays of 1 or 3 rounds) three ways — the
    gather ring, per-direction classes and per-edge delays on the
    structured path — then under config4c's partition window; the tree
    with per-edge delays of the same law; the tree nemesis with
    dir_delays (1, 3).  Each way host-stepped, its fixed trip timed, held
    against the port's CPU path and the gather ring on the same graph."""
    import torch

    broadcast, timing = modules
    n = N_NODES
    inject = broadcast.make_inject(n, W1_VALUES)
    strides = topology.expander_strides(n, DEGREE, seed=0)
    circ = topology.circulant(n, strides)
    ckw = {"strides": strides}
    rows, rng = delay_rows(2 * len(strides), n)
    dd = tuple(int(x) for x in
               rng.choice([1, 3], size=2 * len(strides), p=[0.7, 0.3]))
    gdelays = structured.gather_delays_from_rows("circulant", n, rows, circ,
                                                 **ckw)

    def circ_sim(way, dev, srv=False, sync_every=1 << 20, parts=None,
                 group=None):
        kw = dict(n_values=W1_VALUES, sync_every=sync_every,
                  srv_ledger=srv, parts=parts, device=dev)
        if way == "gather":
            return broadcast.BroadcastSim(circ, delays=gdelays, **kw)
        ex = structured.make_exchange("circulant", n, **ckw)
        diff = structured.make_sync_diff("circulant", n, **ckw)
        if way == "delayed":
            return broadcast.BroadcastSim(circ, exchange=ex, sync_diff=diff,
                                          delayed=structured.make_delayed(
                                              "circulant", n, dd, **ckw),
                                          **kw)
        edge = (structured.make_edge_delayed("circulant", n, rows, **ckw)
                if parts is None else structured.make_edge_delayed_faulted(
                    "circulant", n, rows, group, **ckw))
        return broadcast.BroadcastSim(circ, exchange=ex, edge_delayed=edge,
                                      sync_diff=diff if parts is None
                                      else None, **kw)

    # -- w1_circulant_delayed: run_all.py config4d -------------------
    launches.start()
    rec = {"phase": "w1_circulant_delayed", "n": n, "n_values": W1_VALUES,
           "delay_values": [1, 3], "dir_delays": list(dd), "ways": {}}
    runs = {}
    for way in ("gather", "delayed", "edge"):
        sim = circ_sim(way, device)
        want = runs["gather"][1].t if way == "edge" else None
        rec["ways"][way], state = delayed_way(sim, timing, kernels, inject,
                                              want)
        runs[way] = (sim, state)
    (gsim, gstate), (esim, estate) = runs["gather"], runs["edge"]
    if not same_run(gsim, gstate, esim, estate):
        raise AssertionError("w1_circulant_delayed: the edge-delayed "
                             "structured run differs from the gather ring")
    # accounted: the server ledger on, sync waves every 16 rounds
    acct = {}
    for way in ("gather", "edge"):
        sim = circ_sim(way, device, srv=True, sync_every=16)
        acct[way] = (sim, *sim.run_fused(inject))
    (ga, gas, gar), (ea, eas, ear) = acct["gather"], acct["edge"]
    if not (gar == ear and same_run(ga, gas, ea, eas)):
        raise AssertionError("w1_circulant_delayed: the accounted edge "
                             "run differs from the gather ring's")
    rec.update({"accounted_sync_every": 16, "accounted_rounds": ear,
                "accounted_msgs": int(eas.msgs),
                "srv_msgs": ea.server_msgs(eas)})
    launches.stop(rec, ("shift_ring_exchange", "gather_or", "col_popcount",
                        "col_popcount_nm", "sync_diff_pc"))
    for way, (sim, state) in runs.items():
        check_cpu(lambda dev, way=way: circ_sim(way, dev), sim, state,
                  inject)
    keep_run("circulant_delayed", *runs["delayed"])
    keep_run("circulant_edge_delayed", *runs["edge"])
    for way, (sim, state, _) in acct.items():
        check_cpu(lambda dev, way=way: circ_sim(way, dev, srv=True,
                                                  sync_every=16),
                  sim, state, inject, fused=True)
    rec["cpu_match"] = True
    emit(rec)
    del runs, acct, gsim, gstate, esim, estate, ga, gas, ea, eas
    torch.cuda.empty_cache()

    # -- w1_circulant_edge_delayed_partitioned: config4d under 4c -----
    parts, group = config4c_parts(broadcast, n)

    def part_sim(way, dev):
        return circ_sim(way, dev, srv=True, sync_every=16, parts=parts,
                        group=group)

    launches.start()
    esim = part_sim("edge", device)
    gsim = part_sim("gather", device)
    gstate, grounds = gsim.run(inject)
    timed, estate = delayed_way(esim, timing, kernels, inject, grounds)
    if not same_run(gsim, gstate, esim, estate) or grounds <= 24:
        raise AssertionError("w1_circulant_edge_delayed_partitioned: the "
                             "edge-delayed run differs from the gather "
                             "ring, or converged inside the window")
    rec = {"phase": "w1_circulant_edge_delayed_partitioned", "n": n,
           "n_values": W1_VALUES, "window": [2, 24], "sync_every": 16,
           "delay_values": [1, 3], **timed,
           "srv_msgs": esim.server_msgs(estate), "gather_rounds": grounds}
    launches.stop(rec, ("shift_ring_exchange", "gather_or", "col_popcount",
                        "sync_diff_pc"))
    check_cpu(lambda dev: part_sim("edge", dev), esim, estate, inject)
    check_cpu(lambda dev: part_sim("gather", dev), gsim, gstate, inject)
    rec["cpu_match"] = True
    keep_run("circulant_edge_delayed_partitioned", esim, estate)
    emit(rec)
    del esim, gsim, gstate, estate
    torch.cuda.empty_cache()

    # -- w1_tree_edge_delayed: bench.py's tree, config4d's law --------
    tree_nbrs = topology.to_padded_neighbors(topology.tree(n, BRANCHING))
    trows, _ = delay_rows(2, n)
    tdelays = structured.gather_delays_from_rows("tree", n, trows, tree_nbrs)

    def tree_sim(way, dev):
        kw = dict(n_values=W1_VALUES, sync_every=1 << 20, srv_ledger=False,
                  device=dev)
        if way == "gather":
            return broadcast.BroadcastSim(tree_nbrs, delays=tdelays, **kw)
        return broadcast.BroadcastSim(
            tree_nbrs, exchange=structured.make_exchange("tree", n),
            edge_delayed=structured.make_edge_delayed("tree", n, trows), **kw)

    launches.start()
    gsim = tree_sim("gather", device)
    gstate, grounds = gsim.run(inject)
    esim = tree_sim("edge", device)
    timed, estate = delayed_way(esim, timing, kernels, inject, grounds)
    if not same_run(gsim, gstate, esim, estate):
        raise AssertionError("w1_tree_edge_delayed: the edge-delayed run "
                             "differs from the gather ring")
    rec = {"phase": "w1_tree_edge_delayed", "n": n, "n_values": W1_VALUES,
           "branching": BRANCHING, "delay_values": [1, 3], **timed,
           "gather_rounds": grounds}
    launches.stop(rec, ("tree_ring_exchange", "gather_or", "col_popcount",
                        "col_popcount_nm"))
    check_cpu(lambda dev: tree_sim("edge", dev), esim, estate, inject)
    rec["cpu_match"] = True
    emit(rec)
    del gsim, gstate, esim, estate
    torch.cuda.empty_cache()

    # -- w1_tree_nemesis_delayed: fault_sweep.py's plan, dir_delays ---
    spec = tree_nemesis_spec(faults, n)
    tdd = (1, 3)

    def nem_sim(structured_path, dev):
        kw = dict(n_values=W1_VALUES, sync_every=8, srv_ledger=False,
                  fault_plan=spec.compile(dev), device=dev)
        if not structured_path:
            return broadcast.BroadcastSim(
                tree_nbrs, delays=structured.gather_delays_for(
                    "tree", n, tdd, tree_nbrs), **kw)
        return broadcast.BroadcastSim(
            tree_nbrs, exchange=structured.make_exchange("tree", n),
            nemesis=structured.make_nemesis("tree", n, spec, dir_delays=tdd,
                                            device=dev), **kw)

    launches.start()
    gsim = nem_sim(False, device)
    gstate, grounds = gsim.run(inject)
    if grounds < spec.clear_round:
        raise AssertionError(f"w1_tree_nemesis_delayed: {grounds} rounds, "
                             "converged before the faults cleared")
    nsim = nem_sim(True, device)
    timed, nstate = delayed_way(nsim, timing, kernels, inject, grounds)
    if not same_run(gsim, gstate, nsim, nstate):
        raise AssertionError("w1_tree_nemesis_delayed: the structured run "
                             "differs from the gather ring")
    rec = {"phase": "w1_tree_nemesis_delayed", "n": n,
           "n_values": W1_VALUES, "sync_every": 8, "dir_delays": list(tdd),
           "crash": [2, 16, "range(0, n, 97)"], "loss_rate": 0.1,
           "dup_rate": 0.05, "until": 17, "clear_round": spec.clear_round,
           **timed, "gather_rounds": grounds}
    launches.stop(rec, ("tree_ring_exchange", "wm_fault_coins",
                        "col_popcount", "gather_or", "fault_coins"))
    check_cpu(lambda dev: nem_sim(True, dev), nsim, nstate, inject)
    rec["cpu_match"] = True
    keep_run("tree_nemesis_delayed", nsim, nstate)
    emit(rec)
    del gsim, gstate, nsim, nstate
    torch.cuda.empty_cache()


def small_floods(modules, device, launches: Launches) -> None:
    """Grid, ring and line floods run to convergence with the server
    ledger on, on the card and on the CPU (coverage, not timing)."""
    broadcast, timing = modules
    launches.start()
    rec = {"phase": "small_floods", "runs": {}}
    for topo, n in (("grid", 1 << 16), ("ring", 4099), ("line", 4099)):
        inject = broadcast.make_inject(n, W1_VALUES)
        states = []
        for dev in (device, "cpu"):
            sim = timing.structured_sim(topo, n, W1_VALUES, srv_ledger=True,
                                        device=dev)
            states.append(sim.run_fused(inject))
        (gpu, rounds), (cpu, cpu_rounds) = states
        want = timing.discover_rounds(topo, n, W1_VALUES)
        if not (rounds == cpu_rounds == want and same_state(gpu, cpu)):
            raise AssertionError(f"small_floods {topo}: GPU run differs "
                                 "from the CPU path")
        rec["runs"][topo] = {"n": n, "rounds": rounds, "msgs": int(gpu.msgs),
                             "srv_msgs": int(gpu.srv_msgs),
                             "cpu_match": True}
    launches.stop(rec, ("shift_exchange", "col_popcount"))
    emit(rec)


# the counter phases' node counts: run_all.py config3b's and config3c's,
# fault_sweep.py's large-N counter row's, and the ids / echo phase's
COUNTER_3B_NODES = 1 << 20
# counter_nemesis_device_kv's two ways (fault_sweep.py's counter plan over
# the device KV): allreduce with the gate in slabs and kv_amnesia, cas
# with seq-kv stale reads
COUNTER_NEMESIS_WAYS = {
    "allreduce": dict(mode="allreduce", union_block=4096, kv_amnesia=True),
    "cas": dict(mode="cas", stale_prob=0.1, stale_until=8)}
COUNTER_3C_NODES = 1 << 24
COUNTER_NEMESIS_NODES = 1 << 17
IDS_ECHO_NODES = 1 << 20
# the counter kernels' checked shapes: one node, a ragged warp, a million
# and three (no multiple of 4: the scalar tail), and config3c's 2^24
COUNTER_NS = (1, 31, (1 << 20) + 3, COUNTER_3C_NODES)
# the seq-kv stale coin the checks draw: threshold 0.5, round 3, seed 5
COUNTER_STALE = {"stale_num": 1 << 31, "stale_seed": 5, "t": 3}
# the partial form's checked block offset: a mesh rank's first row past
# 2^22 (the wide key's low word and the stale coin take global rows)
COUNTER_PARTIAL_ROW0 = (1 << 22) + 5


def counter_case(n: int, seed: int, device, gate: bool):
    """A counter round's operands from ``seed``: pending in [-3, 10) with
    one node in 64 near 2^30 (the allreduce sum wraps), cached equal to
    kv0 at half the nodes (fresh), a gate byte of every kind at a
    quarter of them, kv0 and msgs random."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, dtype=dtype, device=device,
                             generator=gen)

    kv0 = ints(-5, 5, ())
    pending = torch.where(ints(0, 64, (n,)) == 0, ints(1 << 29, 1 << 30,
                                                       (n,)),
                          ints(-3, 10, (n,)))
    cached = torch.where(ints(0, 2, (n,)) == 0, kv0, ints(-5, 5, (n,)))
    g = ints(0, 16, (n,))
    gates = torch.where(g < 12, 0, g & 3).to(torch.uint8) if gate else None
    msgs = ints(0, 1 << 32, (), torch.int64)
    return pending, cached, gates, kv0, msgs


def counter_modes(n: int) -> list:
    """(cas, wide) of every layout the counter takes at n nodes: cas
    packed (below 24 row bits), cas wide, allreduce."""
    row_bits = max(1, (n - 1).bit_length())
    return ([(True, False)] if row_bits < 24 else []) \
        + [(True, True), (False, False)]


def check_counter(kernels, note, device) -> None:
    """``counter_select`` and ``counter_apply`` against their plain
    versions at :data:`COUNTER_NS`: every layout, with and without the
    gate, poll and no poll, the stale coin on and off (cas), aligned and
    on 4-byte-offset views (the scalar path), out of place and in
    place."""
    import torch

    for n in COUNTER_NS:
        row_bits = max(1, (n - 1).bit_length())
        for cas, wide in counter_modes(n):
            for gate in (False, True):
                for offset in (0, 1):
                    case = counter_case(n, n + 2 * gate + offset, device,
                                        gate)
                    pending, cached, gates, kv0, msgs = case
                    poll = bool(offset) != gate
                    kw = dict(cas=cas, wide=wide, row_bits=row_bits, t=7,
                              seed=n, poll=poll)
                    views = [at_offset(x, offset) if x is not None else None
                             for x in (pending, cached, gates)]
                    wk, wp = (kernels.counter_work(device) for _ in "kp")
                    kv_k, m_k = kernels.counter_select(*views, kv0, msgs, wk,
                                                       **kw)
                    kv_p, m_p = kernels.counter_select_plain(
                        pending, cached, gates, kv0, msgs, wp, **kw)
                    note("counter_select", (kv_k, kv_p), (m_k, m_p),
                         (wk, wp))
                    for stale in ({}, COUNTER_STALE) if cas else ({},):
                        akw = dict(cas=cas, poll=poll, **stale)
                        got = kernels.counter_apply(*views, kv_k, wk, **akw)
                        want = kernels.counter_apply_plain(
                            pending, cached, gates, kv_p, wp, **akw)
                        note("counter_apply", *zip(got, want))
                        # in place, as the donated run_fused loop runs it
                        into = [at_offset(x, offset)
                                for x in (pending, cached)]
                        kernels.counter_apply(*into, views[2], kv_k, wk,
                                              out=into, **akw)
                        note("counter_apply", *zip(into, want))
                    # the partial form over a mesh block of global rows
                    # row0 .. (the read pass) and the update pass there
                    row0 = COUNTER_PARTIAL_ROW0
                    pkw = dict(kw, row_bits=max(row_bits, (row0 + n - 1)
                                                .bit_length()))
                    if pkw["row_bits"] <= 23 or wide or not cas:
                        pk = kernels.counter_select(
                            *views, kv0, msgs, wk, row0=row0, partial=True,
                            **pkw)
                        pp = kernels.counter_select_plain(
                            pending, cached, gates, kv0, msgs, wp,
                            row0=row0, partial=True, **pkw)
                        note("counter_select", (pk, pp), (wk, wp))
                        wk[3] = wp[3] = row0 + (n // 2)
                        akw = dict(cas=cas, poll=poll, row0=row0,
                                   **(COUNTER_STALE if cas else {}))
                        note("counter_apply", *zip(
                            kernels.counter_apply(*views, kv_k, wk, **akw),
                            kernels.counter_apply_plain(
                                pending, cached, gates, kv_p, wp, **akw)))
                    del case, views, got, want, into
            torch.cuda.synchronize()
        torch.cuda.empty_cache()


def time_counter(kernels, device, out) -> None:
    """The counter kernels and their plain versions, keyed (1, n), at
    config3c's 2^24 (cas, the wide layout, no gate, a poll round) and
    config3b's 2^20 (allreduce under its window: half the nodes
    blocked).  Bounds: the read pass reads pending and the gate, and in
    cas mode cached (cas 8 bytes a node, allreduce gated 5), the update
    pass reads pending, cached and the gate and writes pending and
    cached (16 or 17); their integer operations a node (the read pass's
    hash, masks, key and counts: 14 in cas mode, 7 in allreduce; the
    update pass's masks and selects: 8) lie below those bytes.  Bytes
    go at HBM's rate, or at the L2's where every operand fits in the L2
    and so stays there between the timed calls (2^20: 17 MB of 50)."""
    import torch

    for n, cas, gated in ((COUNTER_3C_NODES, True, False),
                          (COUNTER_3B_NODES, False, True)):
        pending, cached, _, kv0, msgs = counter_case(n, 3, device, False)
        gate = ((torch.arange(n, device=device) < n // 2).to(torch.uint8)
                * kernels.GATE_BLOCKED if gated else None)
        kw = dict(cas=cas, wide=cas, row_bits=max(1, (n - 1).bit_length()),
                  t=4, seed=0, poll=True)
        wk, wp = kernels.counter_work(device), kernels.counter_work(device)
        kv, _ = kernels.counter_select(pending, cached, gate, kv0, msgs, wk,
                                       **kw)
        kv_p, _ = kernels.counter_select_plain(pending, cached, gate, kv0,
                                               msgs, wp, **kw)
        g_bytes = n if gated else 0
        resident = 16 * n + g_bytes <= L2_BYTES
        rate = L2_BYTES_PER_S if resident else HBM_BYTES_PER_S
        out["counter_select"][(1, n)] = _timed(
            "counter_select",
            lambda: kernels.counter_select(pending, cached, gate, kv0, msgs,
                                           wk, **kw),
            lambda: kernels.counter_select_plain(pending, cached, gate, kv0,
                                                 msgs, wp, **kw),
            bound((8 if cas else 4) * n + g_bytes, (14 if cas else 7) * n,
                  rate))
        akw = dict(cas=cas, poll=True)
        out["counter_apply"][(1, n)] = _timed(
            "counter_apply",
            lambda: kernels.counter_apply(pending, cached, gate, kv, wk,
                                          **akw),
            lambda: kernels.counter_apply_plain(pending, cached, gate, kv_p,
                                                wp, **akw),
            bound(16 * n + g_bytes, 8 * n, rate))
        for name in ("counter_select", "counter_apply"):
            out[name][(1, n)]["mode"] = "cas-wide" if cas else \
                "allreduce-gated"
            out[name][(1, n)]["bound_rate"] = "L2" if resident else "HBM"
        del pending, cached, gate, kv, kv_p
        torch.cuda.empty_cache()
    # the read pass's partial form on the mesh's block of config3c's 2^24
    # nodes over 4 ranks (rank 3's rows): the same bytes and hash as the
    # full form, its three words written instead of the finish
    n = COUNTER_3C_NODES // MESH_RANKS
    pending, cached, _, kv0, msgs = counter_case(n, 5, device, False)
    kw = dict(cas=True, wide=True, row_bits=24, t=4, seed=0, poll=True,
              row0=3 * n, partial=True)
    wk, wp = kernels.counter_work(device), kernels.counter_work(device)
    rate = L2_BYTES_PER_S if 16 * n <= L2_BYTES else HBM_BYTES_PER_S
    out["counter_select_partial"] = {(1, n): dict(_timed(
        "counter_select",
        lambda: kernels.counter_select(pending, cached, None, kv0, msgs, wk,
                                       **kw),
        lambda: kernels.counter_select_plain(pending, cached, None, kv0,
                                             msgs, wp, **kw),
        bound(8 * n, 14 * n, rate)), mode="cas-wide partial, row0 3 n",
        bound_rate="L2" if rate == L2_BYTES_PER_S else "HBM")}
    del pending, cached
    torch.cuda.empty_cache()


COUNTER_EXPECT = ("counter_select", "counter_apply")


def counter_timed(sim, kernels, state0, rounds: int) -> dict:
    """``sim.run(state0, rounds)`` (out of place: ``state0`` stays) timed
    with CUDA events (median of 3 after a warm-up), its device busy time
    under the profiler and the port-kernel launches of one run."""
    def run():
        return sim.run(state0, rounds)

    wall = cuda_ms(run, samples=3, inner=1)
    busy, spans = busy_and_spans(lambda: run)
    port = launches_of(kernels, run)
    return {"rounds": rounds, "wall_ms": wall, "ms_per_round": wall / rounds,
            "device_busy_ms": busy,
            "device_idle_share": idle_share(busy, wall),
            "launches_per_round": port / rounds,
            "device_spans_per_round": None if spans is None
            else spans / rounds}


def same_counter(a, b) -> bool:
    """Two counter states agree: t, kv, msgs, the node rows and the KV
    rows."""
    import torch

    def eq(x, y):
        return bool(torch.equal(x.cpu(), y.cpu()))

    return (a.t == b.t and int(a.kv) == int(b.kv)
            and int(a.msgs) == int(b.msgs) and eq(a.pending, b.pending)
            and eq(a.cached, b.cached)
            and (a.rows is None) == (b.rows is None)
            and (a.rows is None or (eq(a.rows.vals, b.rows.vals)
                                    and eq(a.rows.vers, b.rows.vers))))


def counter_nemesis_spec(faults, n: int):
    """benchmarks/fault_sweep.py ``_large_n_faulted_rows``'s counter plan
    at seed 0: ``random_spec(n, seed=1, horizon=12, n_crash_windows=2,
    loss_rate=0.1)`` with its crash windows and loss horizon moved 4
    rounds later (``_shift_crash``); no dup stream."""
    spec = faults.random_spec(n, seed=1, horizon=12, n_crash_windows=2,
                              loss_rate=0.1)
    meta = spec.to_meta()
    meta["crash"] = [[s + 4, e + 4, ns] for s, e, ns in meta["crash"]]
    meta["loss_until"] += 4
    return faults.NemesisSpec.from_meta(meta)


def counter_phases(counter, faults, kernels, device, launches: Launches,
                   card: str) -> None:
    """benchmarks/run_all.py's counter configs on the card (config3b at
    2^20, config3c at 2^24) and fault_sweep.py's large-N counter plan at
    2^17 over the device KV, each held to its own ok condition and to the
    port's CPU path."""
    import numpy as np
    import torch

    # config3b: half the nodes cut off the KV for rounds [0, 8) of 16
    n, rounds = COUNTER_3B_NODES, 16
    deltas = np.random.default_rng(0).integers(0, 10, n).astype(np.int32)
    blocked = np.zeros((1, n), bool)
    blocked[0, : n // 2] = True

    def sim3b(dev):
        return counter.CounterSim(
            n, mode="allreduce", poll_every=2, device=dev,
            kv_sched=counter.KVReach.from_numpy([0], [8], blocked))

    launches.start()
    sim = sim3b(device)
    st0 = sim.add(sim.init_state(), deltas)
    rec = {"phase": "counter_1m_partitioned", "card": card, "n": n,
           "mode": "allreduce", "window": [0, 8], "poll_every": 2,
           **counter_timed(sim, kernels, st0, rounds)}
    st = sim.run(st0, rounds)
    total = int(deltas.sum())
    ok = sim.kv_value(st) == total and bool((sim.reads(st) == total).all())
    rec.update(kv=sim.kv_value(st), msgs=int(st.msgs), ok=ok)
    launches.stop(rec, COUNTER_EXPECT)
    cpu = sim3b("cpu")
    if not (ok and same_counter(st, cpu.run(cpu.add(cpu.init_state(),
                                                    deltas), rounds))):
        raise AssertionError(f"counter_1m_partitioned: ok {ok}, or the GPU "
                             "run differs from the CPU path")
    rec["cpu_match"] = True
    keep_counter("counter_1m_partitioned", sim, st)
    emit(rec)
    del sim, st0, st, cpu
    torch.cuda.empty_cache()

    # config3c: cas at 2^24 nodes, the wide winner layout, 16 rounds
    n = COUNTER_3C_NODES
    deltas = np.random.default_rng(0).integers(1, 10, n).astype(np.int32)

    def sim3c(dev):
        return counter.CounterSim(n, mode="cas", poll_every=4, device=dev)

    launches.start()
    sim = sim3c(device)
    if not sim._wide:
        raise AssertionError("2^24 nodes must select the wide winner layout")
    st0 = sim.add(sim.init_state(), deltas)
    rec = {"phase": "counter_16m_cas_wide", "card": card, "n": n,
           "mode": "cas", "winner_key": "wide", "poll_every": 4,
           **counter_timed(sim, kernels, st0, rounds)}
    st = sim.run(st0, rounds)
    drained = int((st0.pending - st.pending).sum(dtype=torch.int64))
    n_drained = int((st.pending == 0).sum())
    ok = sim.kv_value(st) == drained and n_drained == rounds
    fused = sim.run_fused(sim.add(sim.init_state(), deltas), rounds)
    rec.update(kv=sim.kv_value(st), drained=drained, n_drained=n_drained,
               msgs=int(st.msgs), ok=ok,
               fused_match=same_counter(st, fused))
    launches.stop(rec, COUNTER_EXPECT)
    del fused
    cpu = sim3c("cpu")
    if not (ok and rec["fused_match"]
            and same_counter(st, cpu.run(cpu.add(cpu.init_state(), deltas),
                                         rounds))):
        raise AssertionError(f"counter_16m_cas_wide: ok {ok}, or the GPU "
                             "run differs from run_fused or the CPU path")
    rec["cpu_match"] = True
    keep_counter("counter_16m_cas_wide", sim, st)
    emit(rec)
    del sim, st0, st, cpu
    torch.cuda.empty_cache()

    # fault_sweep.py's counter plan at 2^17 over the device KV: allreduce
    # with the fault gate swept in slabs and kv_amnesia, run to
    # convergence; then cas with seq-kv stale reads for a fixed trip
    n = COUNTER_NEMESIS_NODES
    spec = counter_nemesis_spec(faults, n)
    clear = spec.clear_round
    deltas = np.random.default_rng(0).integers(0, 10, n).astype(np.int32)
    acked = int(deltas.sum())
    members = torch.from_numpy(spec.host_members(clear)).to(device)
    ways = COUNTER_NEMESIS_WAYS
    launches.start()
    rec = {"phase": "counter_nemesis_device_kv", "card": card, "n": n,
           "spec": {"crash": [[s, e, len(ns)] for s, e, ns in spec.crash],
                    "loss_rate": spec.loss_rate,
                    "loss_until": spec.loss_until, "seed": spec.seed},
           "clear_round": clear, "ways": {}}
    finals = {}
    for way, kw in ways.items():
        def make(dev, kw=kw):
            return counter.CounterSim(n, poll_every=2, kv_backend="device",
                                      fault_plan=spec.compile(dev),
                                      device=dev, **kw)

        sim = make(device)
        plan = sim.fault_plan
        ids = torch.arange(n, device=device)
        st0 = sim.add(sim.init_state(), deltas)
        state, wiped, conv = st0, 0, None
        limit = clear + 64 if way == "allreduce" else clear + 16
        while state.t < limit:
            # the acked deltas that die unflushed in an amnesia row
            wiped += int(state.pending[faults.amnesia(plan, state.t,
                                                      ids)].sum())
            state = sim.step(state)
            if way == "allreduce" and state.t >= clear \
                    and int(state.pending.sum()) == 0 \
                    and bool(((state.cached == state.kv)
                              | ~members).all()):
                conv = state.t
                break
        kv = sim.kv_value(state)
        left = int(state.pending.sum(dtype=torch.int64))
        store = int(state.rows.vals[sim._key_at])
        ok = (kv + left + wiped == acked and store == kv
              and (way == "cas" or conv is not None))
        r = {"rounds": state.t, "converged_round": conv, "kv": kv,
             "pending_left": left, "lost_writes_sum": wiped,
             "msgs": int(state.msgs), "ok": ok,
             **{k: v for k, v in kw.items() if k != "mode"},
             **counter_timed(sim, kernels, st0, state.t)}
        rec["ways"][way] = r
        finals[way] = (make, state)
        keep_counter(f"counter_nemesis_device_kv_{way}", sim, state)
        if not ok:
            raise AssertionError(f"counter_nemesis_device_kv {way}: {r}")
        del sim, st0
    launches.stop(rec, COUNTER_EXPECT)
    for way, (make, state) in finals.items():
        cpu = make("cpu")
        if not same_counter(state, cpu.run(cpu.add(cpu.init_state(),
                                                   deltas), state.t)):
            raise AssertionError(f"counter_nemesis_device_kv {way}: GPU "
                                 "run differs from the CPU path")
        rec["ways"][way]["cpu_match"] = True
    emit(rec)
    del finals
    torch.cuda.empty_cache()


# -- Kafka (challenge 5) ---------------------------------------------------

# benchmarks/run_all.py config5_kafka_10k: (nodes, keys, capacity, sends a
# node a round) and its rounds and poll queries
KAFKA_10K = (8, 10_000, 128, 64)
KAFKA_10K_ROUNDS, KAFKA_POLL_Q = 64, 4096
# config5b_kafka_node_sweep: (nodes, sends a node) at 10,000 keys, capacity
# 128, 8 rounds; then the extension rows (K = N / 16, capacity 64, one
# round-robin send a node, two run_fused calls of 2 rounds)
KAFKA_SWEEP = ((8, 64), (64, 64), (256, 16), (1024, 16))
KAFKA_SWEEP_KEYS, KAFKA_SWEEP_CAP, KAFKA_SWEEP_ROUNDS = 10_000, 128, 8
KAFKA_SWEEP_EXT = (4096, 16384, 65536, 131072, 262144)
KAFKA_SWEEP_CPU = 256           # rows up to this many nodes: CPU path too
# benchmarks/fault_sweep.py's faulted Kafka points: (nodes, keys,
# capacity, sends, slab, the matmul oracle too, dup, seed)
KAFKA_FAULTED = ((1024, 10_000, 128, 16, 256, True, True, 7),
                 (4096, 256, 64, 1, 512, False, False, 8))
# fault_sweep.py's large-N faulted Kafka row: nodes, keys, capacity, sends
KAFKA_NEMESIS = (4096, 1024, 128, 1)
# the kernels' checked shapes (n, k, c, s): odd ones, then the phases'
KAFKA_ODD_SHAPES = ((1, 1, 1, 1), (3, 7, 32, 2), (31, 7, 33, 3),
                    (31, 1, 128, 1), (3, 1, 128, 4),
                    # rows too wide for kafka_nem_deliver's shared memory
                    (5, 16_000, 128, 3))
KAFKA_PHASE_SHAPES = ((8, 10_000, 128, 64), (64, 10_000, 128, 64),
                      (256, 10_000, 128, 16), (1024, 10_000, 128, 16),
                      (4096, 256, 64, 1), (4096, 1024, 128, 1),
                      (16384, 1024, 64, 1), (65536, 4096, 64, 1),
                      (131072, 8192, 64, 1), (262144, 16384, 64, 1))
# above this many presence words a shape checks only its phase's mode,
# node chunk by node chunk (check_kafka_rows)
KAFKA_FULL_CHECK_WORDS = 1 << 28
# and kafka_nem_deliver only where its plain version's (rows, N S) coin
# tensor stays below this many coins (the faulted phases' shapes do)
KAFKA_NEM_CHECK_COINS = 1 << 26
# a coin the faulted union draws: the hash and its compare
# (OPS_LOSS_COIN), the origin test and the OR of the bit
OPS_NEM_SEND = OPS_LOSS_COIN + 2


def kafka_words(shape, c: int, gen, device, sparse: int = 3):
    """int32 presence words (shape + (Wc,)) with each bit of a slot below
    ``c`` set at probability 2^-sparse."""
    import torch

    wc = (c + 31) // 32

    def draw():
        return torch.randint(-(1 << 31), 1 << 31, (*shape, wc),
                             dtype=torch.int32, device=device,
                             generator=gen)

    w = draw()
    for _ in range(sparse - 1):
        w &= draw()
    if c % 32:
        w[..., -1] &= (1 << c % 32) - 1
    return w


def kafka_sends(n: int, k: int, c: int, s: int, gen, device):
    """(widx, bit): N S sends, about 3 in 4 holding a distinct (key, slot)
    bit (none past the K C cells)."""
    import torch

    from gossip_glomers_tpu_torch.tpu_sim import kernels

    m, wc = n * s, (c + 31) // 32
    cells = torch.randperm(k * c, device=device, generator=gen)
    cells = cells.repeat(-(-m // (k * c)))[:m]
    has = (torch.rand(m, device=device, generator=gen) < 0.75) \
        & (torch.arange(m, device=device) < k * c)
    slot = cells % c
    widx = torch.where(has, cells // c * wc + slot // 32, -1)
    bit = kernels._wrap_i32(torch.where(has, 1 << slot % 32, 0))
    return widx.to(torch.int32), bit


def kafka_rows(n: int, p: float, gen, device):
    import torch

    return torch.rand(n, device=device, generator=gen) < p


def kafka_ints(lo: int, hi: int, shape, gen, device):
    import torch

    return torch.randint(lo, hi, shape, dtype=torch.int32, device=device,
                         generator=gen)


def kafka_requests(n: int, k: int, c: int, gen, device):
    """Commit requests: a third of the (node, key) cells in [-1, c + 3),
    the rest -1; and the cells after the sends, a quarter missing."""
    import torch

    req = torch.where(kafka_ints(0, 3, (n, k), gen, device) == 0,
                      kafka_ints(-1, c + 3, (n, k), gen, device), -1)
    sent = torch.where(kafka_ints(0, 4, (k,), gen, device) == 0, 0,
                       kafka_ints(1, c + 2, (k,), gen, device))
    return req, sent


def kafka_past_memory(n: int, k: int, c: int) -> bool:
    """The sweep's memory rule (run_all.py config5b's 1.5 x presence >
    14 GB, with the card's total memory): true where a Kafka state of n
    nodes, k keys and capacity c does not fit the card."""
    import torch

    return 1.5 * n * k * ((c + 31) // 32) * 4 > torch.cuda.mem_get_info()[1]


def check_kafka_rows(kernels, note, device, n: int, k: int, c: int,
                     row) -> None:
    """``kafka_merge`` with the union row at a shape too large for a second
    copy of its state: each node chunk's presence and cache come from a
    generator seeded by the chunk, the kernel runs once over the whole
    state, and each chunk is then held against the plain version on the
    same chunk drawn again (the rows are independent in this mode)."""
    import torch

    wc = (c + 31) // 32
    step = max(1, (1 << 30) // (4 * k * (wc + 1)))

    def chunk(lo):
        gen = torch.Generator(device=device).manual_seed(
            (n * 7919 + k) * 104_729 + lo)
        m = min(n, lo + step) - lo
        return (kafka_words((m, k), c, gen, device),
                kafka_ints(0, c + 1, (m, k), gen, device))

    present = torch.empty((n, k, wc), dtype=torch.int32, device=device)
    lc = torch.empty((n, k), dtype=torch.int32, device=device)
    for lo in range(0, n, step):
        present[lo:lo + step], lc[lo:lo + step] = chunk(lo)
    kernels.kafka_merge(present, lc, row=row)
    for lo in range(0, n, step):
        pp, lp = chunk(lo)
        kernels.kafka_merge_plain(pp, lp, row=row)
        note("kafka_merge", (present[lo:lo + step], pp),
             (lc[lo:lo + step], lp))
    del present, lc, pp, lp
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def check_kafka(kernels, note, device) -> None:
    """The four Kafka kernels against their plain versions, in place on
    copies of one case, at :data:`KAFKA_ODD_SHAPES` and
    :data:`KAFKA_PHASE_SHAPES`: ``kafka_merge`` in every mode (no
    delivery, the union row, the carry, the carry and own words; with and
    without the wipe; no resync, pull, push), ``kafka_commit_select``
    with and without the take, the requests and ``want_ok``,
    ``kafka_commit_apply`` after it, ``kafka_nem_deliver`` over the whole
    axis and over slabs that do not divide it, loss on and off; on
    aligned tensors and 4-byte-offset views.  A shape above
    :data:`KAFKA_FULL_CHECK_WORDS` words checks only its phase's merge
    (the union row), aligned, in node chunks (:func:`check_kafka_rows`);
    a shape past the card's memory (:func:`kafka_past_memory`), which the
    sweep does not run, is not checked; ``kafka_nem_deliver`` runs where
    its plain version's coins stay below :data:`KAFKA_NEM_CHECK_COINS`."""
    import torch

    for n, k, c, s in KAFKA_ODD_SHAPES + KAFKA_PHASE_SHAPES:
        if kafka_past_memory(n, k, c):
            continue                    # the sweep does not run it either
        gen = torch.Generator(device=device).manual_seed(n + k + c + s)
        row = kafka_words((k,), c, gen, device, sparse=1)
        row &= torch.where(kafka_rows(k, 0.3, gen, device), 0, -1)[:, None]
        if n * k * ((c + 31) // 32) > KAFKA_FULL_CHECK_WORDS:
            check_kafka_rows(kernels, note, device, n, k, c, row)
            continue
        present = kafka_words((n, k), c, gen, device)
        lc = kafka_ints(0, c + 1, (n, k), gen, device)
        parts = {"row": row,
                 "carry": kafka_words((n, k), c, gen, device, sparse=5),
                 "own": kafka_words((n, k), c, gen, device, sparse=5)}
        origin = kafka_words((n, k), c, gen, device)
        wipe, live = (kafka_rows(n, p, gen, device) for p in (0.2, 0.6))
        for offset in (0, 1):
            def view(x):
                return at_offset(x, offset)

            for deliver in ((), ("row",), ("carry",), ("carry", "own")):
                for wiped in (False, True):
                    for resync in (kernels.RESYNC_NONE, kernels.RESYNC_PULL,
                                   kernels.RESYNC_PUSH):
                        kw = {name: view(parts[name]) for name in deliver}
                        if resync:
                            kw.update(resync=resync, live=live,
                                      origin=view(origin))
                        if wiped:
                            kw["wipe"] = wipe
                        pk, lk = view(present), view(lc)
                        got = kernels.kafka_merge(pk, lk, **kw)
                        pp, lp = present.clone(), lc.clone()
                        want = kernels.kafka_merge_plain(pp, lp, **kw)
                        note("kafka_merge", (pk, pp), (lk, lp),
                             *[(a, b) for a, b in zip(got, want)
                               if a is not None])
                        del pk, lk, pp, lp, got, want
            union = kernels.kafka_merge_plain(
                present.clone(), lc.clone(), resync=kernels.RESYNC_PULL,
                live=live)[0]
            req, sent = kafka_requests(n, k, c, gen, device)
            take, want_ok, reach, tally = (kafka_rows(n, p, gen, device)
                                           for p in (0.7, 0.8, 0.8, 0.5))
            for taking in (False, True):
                for commits in (False, True):
                    for ok_rows in (None, want_ok):
                        if not (taking or commits):
                            continue
                        kw = dict(take=take if taking else None,
                                  union=union,
                                  req=view(req) if commits else None,
                                  want_ok=ok_rows, reach=reach,
                                  kv_sent=sent, tally=tally)
                        pk, lk = view(present), view(lc)
                        got = kernels.kafka_commit_select(pk, lk, **kw)
                        pp, lp = present.clone(), lc.clone()
                        want = kernels.kafka_commit_select_plain(pp, lp,
                                                                 **kw)
                        note("kafka_commit_select", (pk, pp), (lk, lp),
                             *zip(got, want))
                        if commits:
                            msgs = torch.tensor((1 << 32) - 7,
                                                dtype=torch.int64,
                                                device=device)
                            akw = dict(kv_retries=10, tally_mult=n - 1)
                            a = kernels.kafka_commit_apply(
                                lk, kw["req"], *want[:2], sent, reach,
                                ok_rows, want[2], msgs, **akw)
                            b = kernels.kafka_commit_apply_plain(
                                lp, req, *want[:2], sent, reach, ok_rows,
                                want[2], msgs, **akw)
                            note("kafka_commit_apply", (lk, lp),
                                 *zip(a, b))
                        del pk, lk, pp, lp, got, want
        if n * n * s > KAFKA_NEM_CHECK_COINS:
            continue
        widx, bit = kafka_sends(n, k, c, s, gen, device)
        up = kafka_rows(n, 0.8, gen, device)
        for loss_num in (0, int(0.3 * 2**32)):
            for step in (n, max(1, n // 3 + 1)):
                got = torch.full_like(present, -1)
                want = got.clone()
                for lo in range(0, n, step):
                    kw = dict(s_dim=s, lo=lo, hi=min(n, lo + step), t=5,
                              seed=n, loss_num=loss_num)
                    kernels.kafka_nem_deliver(got, widx, bit, up, **kw)
                    kernels.kafka_nem_deliver_plain(want, widx, bit, up,
                                                    **kw)
                note("kafka_nem_deliver", (got, want))
                del got, want
        del present, lc, parts, origin
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def time_kafka(kernels, device, out) -> None:
    """The Kafka kernels and their plain versions at the phases' shapes,
    keyed (nodes, keys), each call in place on the same state: after the
    first call the state is at rest (present already holds the delivery,
    the cache its top), so every timed call moves what the bound counts —
    each input it needs read once, each output it changes written once,
    from this run's data:

    - ``kafka_merge`` (the union row: config5b's 1,024-node and 131,072-
      node rows; the carry with the pull resync: the nemesis phase's
      resync round) touches only the keys (the words) whose delivery is
      non-zero, except that a pull reads every live row's presence: the
      delivery, the presence read and written there, the cache read
      where the top is non-zero, the live rows' presence, the union;
    - ``kafka_nem_deliver`` (one launch over all rows of the faulted 1k
      and 4k points): the rows written, the sends' metadata read once,
      and a coin a (row, send) for the sends with a bit of every up row
      (a down row's own sends only), :data:`OPS_NEM_SEND` operations
      each;
    - ``kafka_commit_select`` (the nemesis phase's resync round with
      commits): the cache and the requests, and the taken rows' presence
      where the union has a bit;
    - ``kafka_commit_apply``: the requests, the cache of the dancing
      cells, the per-key cells and winners.

    Bytes go at HBM's rate, or at the L2's where every operand fits in
    it (:data:`L2_BYTES`)."""
    import torch

    def rate(total):
        return (L2_BYTES_PER_S, "L2") if total <= L2_BYTES \
            else (HBM_BYTES_PER_S, "HBM")

    gen = torch.Generator(device=device).manual_seed(12)
    for n, k, c, mode in ((1024, 10_000, 128, "row"),
                          (131072, 8192, 64, "row"),
                          (4096, 1024, 128, "carry-pull")):
        wc = (c + 31) // 32
        present = kafka_words((n, k), c, gen, device)
        lc = kafka_ints(0, c + 1, (n, k), gen, device)
        if mode == "row":
            # keys that received a bit: as in the sweep's rounds
            row = kafka_words((k,), c, gen, device, sparse=4)
            kw = dict(row=row)
            touched = int((row != 0).any(-1).sum())
            moved = touched * n * (8 * wc + 4) + 4 * k * wc
            operands = 4 * n * k * (wc + 1) + 4 * k * wc
        else:
            carry = kafka_words((n, k), c, gen, device, sparse=6)
            live = kafka_rows(n, 0.8, gen, device)
            kw = dict(carry=carry, resync=kernels.RESYNC_PULL, live=live)
            got = (carry != 0).any(-1)
            touched = int(got.sum())
            reads = int((got | live[:, None]).sum())
            moved = (4 * n * k * wc + 4 * wc * (reads + touched)
                     + 4 * touched + 4 * k * wc + n)
            operands = 4 * n * k * (2 * wc + 1)
        kernels.kafka_merge(present, lc, **kw)
        pp, lp = present.clone(), lc.clone()
        kernels.kafka_merge_plain(pp, lp, **kw)
        bps, where = rate(operands)
        out["kafka_merge"][(n, k)] = _timed(
            "kafka_merge", lambda: kernels.kafka_merge(present, lc, **kw),
            lambda: kernels.kafka_merge_plain(pp, lp, **kw),
            bound(moved, 0, bps))
        out["kafka_merge"][(n, k)].update(
            mode=mode, capacity=c, touched=touched, bytes=moved,
            bound_rate=where)
        if mode == "carry-pull":
            # the nemesis phase's commit passes on this state
            union = kernels.kafka_merge_plain(
                present.clone(), lc.clone(), resync=kernels.RESYNC_PULL,
                live=live)[0]
            req, sent = kafka_requests(n, k, c, gen, device)
            reach = kafka_rows(n, 0.9, gen, device)
            skw = dict(take=live, union=union, req=req, want_ok=live,
                       reach=reach, kv_sent=sent, tally=live)
            sel = kernels.kafka_commit_select(present, lc, **skw)
            sel = kernels.kafka_commit_select(present, lc, **skw)
            ukeys = (union != 0).any(-1)
            moved = (8 * n * k + 4 * wc * int(live.sum())
                     * int(ukeys.sum()) + 4 * k * (wc + 3) + 4 * n)
            bps, where = rate(4 * n * k * (wc + 2))
            out["kafka_commit_select"][(n, k)] = _timed(
                "kafka_commit_select",
                lambda: kernels.kafka_commit_select(present, lc, **skw),
                lambda: kernels.kafka_commit_select_plain(pp, lp, **skw),
                bound(moved, 0, bps))
            out["kafka_commit_select"][(n, k)].update(
                mode="resync-take-and-commits", capacity=c, bytes=moved,
                bound_rate=where)
            msgs = torch.zeros((), dtype=torch.int64, device=device)
            akw = dict(kv_retries=10, tally_mult=2)
            args = (req, *sel[:2], sent, reach, live, sel[2], msgs)
            kernels.kafka_commit_apply(lc, *args, **akw)
            dancing = int(((req >= 1) & live[:, None]
                           & reach[:, None]).sum())
            moved = 4 * n * k + 4 * dancing + 16 * k + 2 * n
            bps, where = rate(8 * n * k)
            out["kafka_commit_apply"][(n, k)] = _timed(
                "kafka_commit_apply",
                lambda: kernels.kafka_commit_apply(lc, *args, **akw),
                lambda: kernels.kafka_commit_apply_plain(lp, *args, **akw),
                bound(moved, 0, bps))
            out["kafka_commit_apply"][(n, k)].update(
                capacity=c, dancing=dancing, bytes=moved, bound_rate=where)
            del union, req, sent, sel, args
        del present, lc, pp, lp, kw
        torch.cuda.empty_cache()
    for n, k, c, s, *_ in KAFKA_FAULTED:
        wc = (c + 31) // 32
        deliver = torch.empty((n, k, wc), dtype=torch.int32, device=device)
        widx, bit = kafka_sends(n, k, c, s, gen, device)
        up = kafka_rows(n, 0.99, gen, device)
        kw = dict(s_dim=s, lo=0, hi=n, t=1, seed=7, loss_num=int(0.1 * 2**32))
        n_up, sent = int(up.sum()), int((bit != 0).sum())
        own = int(((bit != 0).view(n, s).sum(1) * ~up).sum())
        moved = 4 * n * k * wc + 8 * n * s + n
        ops = OPS_NEM_SEND * (n_up * sent + own)
        out["kafka_nem_deliver"][(n, k)] = _timed(
            "kafka_nem_deliver",
            lambda: kernels.kafka_nem_deliver(deliver, widx, bit, up, **kw),
            lambda: kernels.kafka_nem_deliver_plain(deliver, widx, bit, up,
                                                    **kw),
            bound(moved, ops, rate(moved)[0]))
        out["kafka_nem_deliver"][(n, k)].update(
            capacity=c, sends=s, coins=n_up * sent + own, ops=ops,
            bytes=moved, bound_rate=rate(moved)[1])
        del deliver, widx, bit
        torch.cuda.empty_cache()


# the block forms' checked problems (n, k, c, s), each split into 2 and 4
# blocks of rows as the mesh's ranks hold them: odd widths, then the
# mesh_kafka phase's 4,096-node shapes
KAFKA_BLOCK_SHAPES = ((8, 3, 33, 2), (64, 7, 128, 1), (4096, 256, 64, 1),
                      (4096, 1024, 128, 1))


def check_kafka_blocks(kernels, note, device) -> None:
    """The Kafka kernels' block forms (a mesh rank's rows) against their
    plain versions on the same block, and the blocks combined as the mesh
    combines them against the whole problem's plain result, at 2 and 4
    blocks of each of :data:`KAFKA_BLOCK_SHAPES`: ``kafka_merge`` over
    each block (the pull union the OR of the blocks'); ``kafka_nem_
    deliver`` with ``row0`` over all origins (the materialized union) and
    over each visiting origin block in the ring's order, ``origin0`` and
    ``accumulate`` (block 0 in two slabs); ``kafka_commit_select`` with
    ``row0`` and ``n_total`` (the minimum CAS row, the maximum writer
    row, the summed counts); ``kafka_commit_apply``'s partial form (the
    requests summed, then ``commit_finish``)."""
    import torch

    for n, k, c, s in KAFKA_BLOCK_SHAPES:
        gen = torch.Generator(device=device).manual_seed(7 * n + k + c)
        wc = (c + 31) // 32
        present = kafka_words((n, k), c, gen, device)
        lc = kafka_ints(0, c + 1, (n, k), gen, device)
        carry = kafka_words((n, k), c, gen, device, sparse=5)
        wipe, live = (kafka_rows(n, p, gen, device) for p in (0.2, 0.6))
        pull = dict(resync=kernels.RESYNC_PULL)
        pw, lw = present.clone(), lc.clone()
        uw = kernels.kafka_merge_plain(pw, lw, wipe=wipe, carry=carry,
                                       live=live, **pull)[0]
        widx, bit = kafka_sends(n, k, c, s, gen, device)
        up = kafka_rows(n, 0.8, gen, device)
        nkw = dict(s_dim=s, t=5, seed=n, loss_num=int(0.3 * 2**32))
        whole = torch.empty((n, k, wc), dtype=torch.int32, device=device)
        kernels.kafka_nem_deliver_plain(whole, widx, bit, up, lo=0, hi=n,
                                        **nkw)
        req, sent = kafka_requests(n, k, c, gen, device)
        take, want_ok, reach, tally = (kafka_rows(n, p, gen, device)
                                       for p in (0.7, 0.8, 0.8, 0.5))
        skw = dict(take=take, union=uw, req=req, want_ok=want_ok,
                   reach=reach, kv_sent=sent, tally=tally)
        akw = dict(kv_retries=10, tally_mult=2)
        msgs = torch.tensor((1 << 32) - 7, dtype=torch.int64, device=device)
        ps, ls = pw.clone(), lw.clone()
        cw, wl, cnt = kernels.kafka_commit_select_plain(ps, ls, **skw)
        kvw, mw = kernels.kafka_commit_apply_plain(
            ls, req, cw, wl, sent, reach, want_ok, cnt, msgs, **akw)
        for shards in (2, 4):
            b = n // shards
            pk_all, lk_all = present.clone(), lc.clone()
            union = None
            for r in range(shards):
                sl = slice(r * b, (r + 1) * b)
                u = kernels.kafka_merge(pk_all[sl], lk_all[sl],
                                        wipe=wipe[sl], carry=carry[sl],
                                        live=live[sl], **pull)[0]
                pp, lp = present[sl].clone(), lc[sl].clone()
                up_ = kernels.kafka_merge_plain(pp, lp, wipe=wipe[sl],
                                                carry=carry[sl],
                                                live=live[sl], **pull)[0]
                note("kafka_merge", (pk_all[sl], pp), (lk_all[sl], lp),
                     (u, up_))
                union = u if union is None else union | u
            note("kafka_merge", (pk_all, pw), (lk_all, lw), (union, uw))
            for r in range(shards):
                sl = slice(r * b, (r + 1) * b)
                got, want = (torch.full((b, k, wc), -1, dtype=torch.int32,
                                        device=device) for _ in "gw")
                kernels.kafka_nem_deliver(got, widx, bit, up[sl], lo=0,
                                          hi=b, row0=r * b, **nkw)
                kernels.kafka_nem_deliver_plain(want, widx, bit, up[sl],
                                                lo=0, hi=b, row0=r * b,
                                                **nkw)
                note("kafka_nem_deliver", (got, want), (got, whole[sl]))
                got.fill_(-1)
                want.fill_(-1)
                slabs = ((0, b // 2), (b // 2, b)) if r == 0 else ((0, b),)
                for step in range(shards):
                    o = (r - step) % shards
                    ms = slice(o * b * s, (o + 1) * b * s)
                    for lo, hi in slabs:
                        kw = dict(lo=lo, hi=hi, row0=r * b, origin0=o * b,
                                  accumulate=step > 0, **nkw)
                        kernels.kafka_nem_deliver(got, widx[ms], bit[ms],
                                                  up[sl], **kw)
                        kernels.kafka_nem_deliver_plain(
                            want, widx[ms], bit[ms], up[sl], **kw)
                note("kafka_nem_deliver", (got, want), (got, whole[sl]))
            sel, parts = [], []
            for r in range(shards):
                sl = slice(r * b, (r + 1) * b)
                bkw = {name: (x[sl] if name in ("take", "req", "want_ok",
                                                "reach", "tally") else x)
                       for name, x in skw.items()}
                pk, lk = pw[sl].clone(), lw[sl].clone()
                got = kernels.kafka_commit_select(pk, lk, row0=r * b,
                                                  n_total=n, **bkw)
                pp, lp = pw[sl].clone(), lw[sl].clone()
                want = kernels.kafka_commit_select_plain(
                    pp, lp, row0=r * b, n_total=n, **bkw)
                note("kafka_commit_select", (pk, pp), (lk, lp),
                     *zip(got, want))
                sel.append((pk, lk, lp, got))
            bcw = torch.stack([x[3][0] for x in sel]).amin(0)
            bwl = torch.stack([x[3][1] for x in sel]).amax(0)
            bcnt = sum(x[3][2] for x in sel)
            note("kafka_commit_select", (bcw, cw), (bwl, wl), (bcnt, cnt),
                 (torch.cat([x[0] for x in sel]), ps))
            for r, (_, lk, lp, _) in enumerate(sel):
                sl = slice(r * b, (r + 1) * b)
                args = (req[sl], bcw, bwl, sent, reach[sl], want_ok[sl],
                        None, None)
                pkw = dict(row0=r * b, n_total=n, partial=True, **akw)
                got = kernels.kafka_commit_apply(lk, *args, **pkw)
                want = kernels.kafka_commit_apply_plain(lp, *args, **pkw)
                note("kafka_commit_apply", (lk, lp), (got, want))
                parts.append(got.long())
            kv, m = kernels.commit_finish(sum(parts), bcw, bwl, sent, bcnt,
                                          msgs, n_total=n, **akw)
            note("kafka_commit_apply", (kv, kvw), (m, mw),
                 (torch.cat([x[1] for x in sel]), ls))
            del pk_all, lk_all, sel, parts
        del present, lc, carry, pw, lw, whole, ps, ls
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# the block forms' timed shapes, mesh_kafka's on 4 ranks: the union row
# over a rank's 32,768 of 131,072 nodes (K 8,192, C 64); the 4,096-node
# nemesis campaign's rank block of 1,024 rows (K 1,024, C 128, S 1)
KAFKA_BLOCK_TIMED = ((131072, 8192, 64), (4096, 1024, 128))


def time_kafka_blocks(kernels, device, out) -> None:
    """The block forms at mesh_kafka's shapes on 4 ranks (rank 3's rows),
    keyed (rows, keys) under ``out["<kernel>_block"]``, with their plain
    versions, bounds counted from this run's data as :func:`time_kafka`
    counts the whole forms': ``kafka_merge`` with the union row over the
    rank's rows of the 131,072-node union, and with the carry and the pull
    resync over the 4,096-node campaign's; ``kafka_nem_deliver`` over
    the rank's 1,024 rows against all 4,096 origins (materialized) and
    against one visiting block of 1,024, accumulating (a ring step);
    ``kafka_commit_select`` with ``row0`` and ``n_total`` (the take and
    the commits), ``kafka_commit_apply``'s partial form."""
    import torch

    def rate(total):
        return (L2_BYTES_PER_S, "L2") if total <= L2_BYTES \
            else (HBM_BYTES_PER_S, "HBM")

    blk = {name: out.setdefault(f"{name}_block", {}) for name in (
        "kafka_merge", "kafka_nem_deliver", "kafka_commit_select",
        "kafka_commit_apply")}
    gen = torch.Generator(device=device).manual_seed(21)
    n, k, c = KAFKA_BLOCK_TIMED[0]
    b, wc = n // MESH_RANKS, (c + 31) // 32
    present = kafka_words((b, k), c, gen, device)
    lc = kafka_ints(0, c + 1, (b, k), gen, device)
    row = kafka_words((k,), c, gen, device, sparse=4)
    kernels.kafka_merge(present, lc, row=row)
    pp, lp = present.clone(), lc.clone()
    touched = int((row != 0).any(-1).sum())
    moved = touched * b * (8 * wc + 4) + 4 * k * wc
    bps, where = rate(4 * b * k * (wc + 1))
    blk["kafka_merge"][(b, k)] = dict(_timed(
        "kafka_merge", lambda: kernels.kafka_merge(present, lc, row=row),
        lambda: kernels.kafka_merge_plain(pp, lp, row=row),
        bound(moved, 0, bps)), mode="row, a rank of 131,072 nodes",
        capacity=c, touched=touched, bytes=moved, bound_rate=where)
    del present, lc, pp, lp
    torch.cuda.empty_cache()
    n, k, c = KAFKA_BLOCK_TIMED[1]
    b, wc, r0 = n // MESH_RANKS, (c + 31) // 32, 3 * (n // MESH_RANKS)
    present = kafka_words((b, k), c, gen, device)
    lc = kafka_ints(0, c + 1, (b, k), gen, device)
    carry = kafka_words((b, k), c, gen, device, sparse=6)
    live = kafka_rows(b, 0.8, gen, device)
    kw = dict(carry=carry, resync=kernels.RESYNC_PULL, live=live)
    kernels.kafka_merge(present, lc, **kw)
    pp, lp = present.clone(), lc.clone()
    got = (carry != 0).any(-1)
    touched = int(got.sum())
    reads = int((got | live[:, None]).sum())
    moved = (4 * b * k * wc + 4 * wc * (reads + touched) + 4 * touched
             + 4 * k * wc + b)
    bps, where = rate(4 * b * k * (2 * wc + 1))
    blk["kafka_merge"][(b, k)] = dict(_timed(
        "kafka_merge", lambda: kernels.kafka_merge(present, lc, **kw),
        lambda: kernels.kafka_merge_plain(pp, lp, **kw),
        bound(moved, 0, bps)), mode="carry-pull, a rank of 4,096 nodes",
        capacity=c, touched=touched, bytes=moved, bound_rate=where)
    widx, bit = kafka_sends(n, k, c, 1, gen, device)
    up_all = kafka_rows(n, 0.99, gen, device)
    up = up_all[r0:r0 + b]
    nkw = dict(s_dim=1, t=1, seed=2, loss_num=int(0.1 * 2**32), row0=r0)
    deliver = torch.empty((b, k, wc), dtype=torch.int32, device=device)
    for way, (o0, m) in {"materialized": (0, n), "ring step": (0, b)}.items():
        wi, bi = widx[o0:o0 + m], bit[o0:o0 + m]
        acc = way == "ring step"
        dkw = dict(nkw, origin0=o0, accumulate=acc, lo=0, hi=b)
        n_up, sent = int(up.sum()), int((bi != 0).sum())
        mine = (bi != 0)[max(0, r0 - o0):max(0, r0 - o0 + b)]
        own = int((mine & ~up[:mine.numel()]).sum()) if r0 >= o0 \
            and r0 < o0 + m else 0
        moved = 4 * b * k * wc * (2 if acc else 1) + 8 * m + b
        ops = OPS_NEM_SEND * (n_up * sent + own)
        kern = (lambda dkw=dkw, wi=wi, bi=bi: kernels.kafka_nem_deliver(
            deliver, wi, bi, up, **dkw))
        plain = (lambda dkw=dkw, wi=wi, bi=bi:
                 kernels.kafka_nem_deliver_plain(deliver, wi, bi, up, **dkw))
        blk["kafka_nem_deliver"][(b, m)] = dict(_timed(
            "kafka_nem_deliver", kern, plain,
            bound(moved, ops, rate(moved)[0])), mode=way, capacity=c,
            coins=n_up * sent + own, ops=ops, bytes=moved,
            bound_rate=rate(moved)[1], row0=r0, origins=m)
    union = kernels.kafka_merge_plain(present.clone(), lc.clone(),
                                      resync=kernels.RESYNC_PULL,
                                      live=live)[0]
    req, sent = kafka_requests(b, k, c, gen, device)
    reach = kafka_rows(b, 0.9, gen, device)
    skw = dict(take=live, union=union, req=req, want_ok=live, reach=reach,
               kv_sent=sent, tally=live, row0=r0, n_total=n)
    sel = kernels.kafka_commit_select(present, lc, **skw)
    sel = kernels.kafka_commit_select(present, lc, **skw)
    ukeys = (union != 0).any(-1)
    moved = (8 * b * k + 4 * wc * int(live.sum()) * int(ukeys.sum())
             + 4 * k * (wc + 3) + 4 * b)
    bps, where = rate(4 * b * k * (wc + 2))
    blk["kafka_commit_select"][(b, k)] = dict(_timed(
        "kafka_commit_select",
        lambda: kernels.kafka_commit_select(present, lc, **skw),
        lambda: kernels.kafka_commit_select_plain(pp, lp, **skw),
        bound(moved, 0, bps)), mode="take and commits, row0 3,072 of 4,096",
        capacity=c, bytes=moved, bound_rate=where)
    args = (req, *sel[:2], sent, reach, live, None, None)
    akw = dict(kv_retries=10, tally_mult=2, row0=r0, n_total=n, partial=True)
    kernels.kafka_commit_apply(lc, *args, **akw)
    dancing = int(((req >= 1) & live[:, None] & reach[:, None]).sum())
    moved = 4 * b * k + 4 * dancing + 16 * k + 2 * b
    bps, where = rate(8 * b * k)
    blk["kafka_commit_apply"][(b, k)] = dict(_timed(
        "kafka_commit_apply",
        lambda: kernels.kafka_commit_apply(lc, *args, **akw),
        lambda: kernels.kafka_commit_apply_plain(lp, *args, **akw),
        bound(moved, 0, bps)), mode="partial, row0 3,072 of 4,096",
        capacity=c, dancing=dancing, bytes=moved, bound_rate=where)
    del present, lc, pp, lp, carry, deliver
    torch.cuda.empty_cache()


def same_kafka(a, b, rows: bool = True) -> bool:
    """Two Kafka states agree: t, msgs, every tensor field and (with
    ``rows``) the KV rows."""
    import torch

    def eq(x, y):
        return x.shape == y.shape and bool(torch.equal(x.cpu(), y.cpu()))

    fields = ("log_vals", "present", "kv_val", "local_committed",
              "origin_bits")
    ok = (a.t == b.t and int(a.msgs) == int(b.msgs)
          and all(eq(getattr(a, f), getattr(b, f)) for f in fields))
    if rows and ok and (a.rows is not None or b.rows is not None):
        ok = (a.rows is not None and b.rows is not None
              and eq(a.rows.vals, b.rows.vals)
              and eq(a.rows.vers, b.rows.vers))
    return ok


def profiled_call(kernels, fn):
    """``(fn(), device busy ms, device spans)`` of one call under the
    profiler behind the ~1 ms spin lead-in (busy None: the profile missed
    a port launch).  For runs whose state leaves no room for the second
    staging :func:`device_spans` makes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(LEAD_IN_CYCLES)
        before = sum(kernels.LAUNCHES.values())
        out = fn()
        torch.cuda.synchronize()
        launched = sum(kernels.LAUNCHES.values()) - before
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "spin_kernel" not in e.name]
    seen = sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and PORT_KERNEL.search(e.name))
    if seen != launched:
        print(f"chip_smoke: profile saw {seen} of {launched} port kernel "
              "launches", file=sys.stderr, flush=True)
        return out, None, None
    return out, sum(spans) / 1e3, len(spans)


def event_ms(fn) -> tuple:
    """(fn(), CUDA-event ms of the call)."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    out = fn()
    ev[1].record()
    ev[1].synchronize()
    return out, ev[0].elapsed_time(ev[1])


def no_host_sync(fn):
    """``fn()`` with torch's sync debug mode at "error": any operation
    that waits for the card on the host (a copy to the host, ``.item()``,
    ``nonzero``, a pageable copy to the card) raises."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def kafka_timed(kernels, stage, rounds: int, samples: int = 3) -> dict:
    """A Kafka run timed: ``stage()`` returns a run on a fresh state
    (made outside the timing); the median CUDA-event ms of ``samples``
    runs after a warm-up, the device busy time of one under the profiler,
    and the port launches of one."""
    wall = statistics.median([event_ms(stage())[1]
                              for _ in range(samples + 1)][1:])
    busy, spans = busy_and_spans(stage)
    port = launches_of(kernels, stage())
    return {"rounds": rounds, "wall_ms": wall, "ms_per_round": wall / rounds,
            "device_busy_ms": busy,
            "device_idle_share": idle_share(busy, wall),
            "launches_per_round": port / rounds,
            "device_spans_per_round": None if spans is None
            else spans / rounds}


def allocated(state) -> int:
    """Slots the cells have handed out: the sum of (cell - 1) over the
    set cells."""
    kv = state.kv_val.long()
    return int((kv - 1).clamp(min=0).sum())


KAFKA_EXPECT = ("kafka_merge",)


def kafka_10k(kafka, kernels, device, launches: Launches, card: str) -> None:
    """benchmarks/run_all.py config5_kafka_10k: 8 nodes, 10,000 keys,
    capacity 128, 64 sends a node a round for 64 rounds of
    ``default_rng(0)`` keys and values, commit-free, the union path;
    ``ok``: the cells handed out as many offsets as there were sends.
    Then the batched poll of 4,096 (node, key, from) queries from the
    same generator, timed on the card (``poll_batch_ms``), and the run
    again over the device KV.  Each equals the CPU path."""
    import numpy as np
    import torch

    n, k, cap, s = KAFKA_10K
    rounds = KAFKA_10K_ROUNDS
    rng = np.random.default_rng(0)
    sks = rng.integers(0, k, (rounds, n, s)).astype(np.int32)
    svs = rng.integers(0, 1 << 20, (rounds, n, s)).astype(np.int32)
    sks_d, svs_d = (torch.from_numpy(x).to(device) for x in (sks, svs))

    def make(dev, **kw):
        return kafka.KafkaSim(n, k, cap, max_sends=s, device=dev, **kw)

    launches.start()
    sim = make(device)

    def stage():
        st = sim.init_state()
        return lambda: sim.run_fused(st, sks_d, svs_d)

    rec = {"phase": "kafka_10k", "card": card, "n": n, "keys": k,
           "capacity": cap, "sends_per_round": s,
           **kafka_timed(kernels, stage, rounds)}
    st = no_host_sync(stage())
    rec["no_host_sync"] = True
    sends = rounds * n * s
    ok = allocated(st) == sends
    rec.update(sends=sends, allocated=allocated(st), msgs=int(st.msgs),
               sends_per_s=sends / rec["wall_ms"] * 1e3, ok=ok)
    # the batched poll (log.go:79-110) as one device function
    q = KAFKA_POLL_Q
    pn = rng.integers(0, n, q).astype(np.int32)
    pk = rng.integers(0, k, q).astype(np.int32)
    pf = rng.integers(1, cap + 1, q).astype(np.int32)
    qd = [torch.from_numpy(x).to(device) for x in (pn, pk, pf)]
    fn = sim.poll_batch_program()
    rec["poll_batch_ms"] = cuda_ms(lambda: fn(st.present, st.log_vals, *qd))
    rec["polls_per_s"] = q / rec["poll_batch_ms"] * 1e3
    offs, vals = sim.poll_batch(st, pn, pk, pf)
    dsim = make(device, kv_backend="device")
    dst = dsim.run_fused(dsim.init_state(), sks_d, svs_d)
    launches.stop(rec, KAFKA_EXPECT)
    cpu = make("cpu")
    cst = cpu.run_rounds(cpu.init_state(), sks, svs)
    coffs, cvals = cpu.poll_batch(cst, pn, pk, pf)
    rec["cpu_match"] = same_kafka(st, cst)
    rec["poll_cpu_match"] = bool((offs == coffs).all()
                                 and (vals == cvals).all())
    rec["device_kv_match"] = (same_kafka(dst, st, rows=False)
                              and bool(torch.equal(kafka.kvstore.rows_view_at(
                                  dst.rows, dsim._slots)[0], dst.kv_val)))
    emit(rec)
    if not (ok and rec["cpu_match"] and rec["poll_cpu_match"]
            and rec["device_kv_match"]):
        raise AssertionError(f"kafka_10k: {rec}")
    del sim, st, dsim, dst
    torch.cuda.empty_cache()


def sweep_checks(kafka, kernels, sim, st) -> dict:
    """The sweep's full-replication checks, in node chunks of about 1 GB
    (no state-sized temporary): every node's presence equals node 0's,
    node 0's popcount of each key is its cell - 1, and the committed
    cache is the cell - 1 where the cell is set, 0 elsewhere."""
    import torch

    n, k, wc = st.present.shape
    kv = st.kv_val
    want = torch.where(kv > 0, kv - 1, 0)
    pc0 = kernels.popcount(st.present[0]).sum(-1)
    step = max(1, (1 << 30) // (4 * k * (wc + 1)))
    same_rows = lc_ok = True
    for lo in range(0, n, step):
        same_rows &= bool((st.present[lo:lo + step]
                           == st.present[:1]).all())
        lc_ok &= bool((st.local_committed[lo:lo + step]
                       == want[None]).all())
    return {"presence_rows_equal": same_rows,
            "popcount_is_cell_less_1": bool((pc0 == want).all()),
            "committed_is_cell_less_1": lc_ok}


def kafka_node_sweep(kafka, kernels, device, launches: Launches,
                     card: str) -> None:
    """benchmarks/run_all.py config5b_kafka_node_sweep: 8 / 64 / 256 /
    1,024 nodes at 10,000 keys, capacity 128, 8 rounds (64 / 64 / 16 /
    16 sends a node, ``default_rng(n)``), then the extension rows 4,096
    ... 262,144 nodes (K = N / 16, capacity 64, one round-robin send a
    node, two ``run_fused`` calls of 2 rounds, which fill every key's
    capacity exactly; the first under the profiler, the second timed).
    A row runs unless 1.5 x its presence exceeds the card's memory (the
    reference's rule with the card's total in place of 14 GB); else it
    gets the reference's error row.  ``ok`` for every row: the offsets
    handed out equal the sends; each row also checks full replication
    (:func:`sweep_checks`), and rows up to 256 nodes equal the CPU
    path."""
    import numpy as np
    import torch

    total = torch.cuda.mem_get_info()[1]
    rec = {"phase": "kafka_node_sweep", "card": card,
           "card_memory_bytes": total, "rows": {}}
    launches.start()
    ok_all = True
    k, cap, rounds = KAFKA_SWEEP_KEYS, KAFKA_SWEEP_CAP, KAFKA_SWEEP_ROUNDS
    for n, s in KAFKA_SWEEP:
        torch.cuda.reset_peak_memory_stats()
        rng = np.random.default_rng(n)
        sks = rng.integers(0, k, (rounds, n, s)).astype(np.int32)
        svs = rng.integers(0, 1 << 20, (rounds, n, s)).astype(np.int32)
        sks_d, svs_d = (torch.from_numpy(x).to(device) for x in (sks, svs))
        sim = kafka.KafkaSim(n, k, cap, max_sends=s, device=device)

        def stage():
            st = sim.init_state()
            return lambda: sim.run_fused(st, sks_d, svs_d)

        row = kafka_timed(kernels, stage, rounds)
        st = no_host_sync(stage())
        sends = rounds * n * s
        row.update(sends=sends, allocated=allocated(st),
                   ok=allocated(st) == sends, no_host_sync=True,
                   sends_per_s=sends / row["wall_ms"] * 1e3,
                   present_mb_total=n * k * sim.n_pwords * 4 / 1e6,
                   **sweep_checks(kafka, kernels, sim, st))
        if n <= KAFKA_SWEEP_CPU:
            cpu = kafka.KafkaSim(n, k, cap, max_sends=s, device="cpu")
            row["cpu_match"] = same_kafka(
                st, cpu.run_rounds(cpu.init_state(), sks, svs))
            ok_all &= row["cpu_match"]
        row["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        ok_all &= row["ok"] and row["presence_rows_equal"] \
            and row["popcount_is_cell_less_1"] \
            and row["committed_is_cell_less_1"]
        rec["rows"][f"nodes-{n}"] = row
        del sim, st, sks_d, svs_d
        torch.cuda.empty_cache()
    boundary = None
    for n in KAFKA_SWEEP_EXT:
        k2, cap2, s2, r2 = max(256, n // 16), 64, 1, 2
        wc = (cap2 + 31) // 32
        present_gb = n * k2 * wc * 4 / 1e9
        name = f"nodes-{n}-k{k2}"
        row = {"n_keys": k2, "capacity": cap2,
               "present_mb_total": present_gb * 1e3,
               "present_kb_per_node": present_gb * 1e6 / n}
        if kafka_past_memory(n, k2, cap2):
            row["error"] = (f"exceeds the card's memory: ~1.5 x "
                            f"{present_gb:.1f} GB donated presence "
                            "footprint")
            boundary = boundary or name
            rec["rows"][name] = row
            continue
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rng = np.random.default_rng(n)
        sks = np.tile((np.arange(n, dtype=np.int32) % k2)[None, :, None],
                      (r2, 1, 1))
        svs = rng.integers(0, 1 << 20, (r2, n, s2)).astype(np.int32)
        sks_d, svs_d = (torch.from_numpy(x).to(device) for x in (sks, svs))
        sim = kafka.KafkaSim(n, k2, cap2, max_sends=s2, device=device)
        st = sim.init_state()
        sends = r2 * n * s2
        st, busy, spans = profiled_call(
            kernels, lambda: sim.run_fused(st, sks_d, svs_d))
        first_ok = allocated(st) == sends
        before = dict(kernels.LAUNCHES)
        st, wall = event_ms(lambda: sim.run_fused(st, sks_d, svs_d))
        port = add_trip(kernels, before)
        row.update(rounds=r2, wall_ms=wall, ms_per_round=wall / r2,
                   sends_per_s=sends / wall * 1e3, device_busy_ms=busy,
                   device_idle_share=idle_share(busy, wall),
                   launches_per_round=port / r2,
                   device_spans_per_round=None if spans is None
                   else spans / r2,
                   sends=sends, allocated_first_run=sends if first_ok
                   else None, allocated=allocated(st),
                   ok=first_ok and allocated(st) == 2 * sends,
                   **sweep_checks(kafka, kernels, sim, st),
                   peak_mem_bytes=torch.cuda.max_memory_allocated())
        ok_all &= row["ok"] and row["presence_rows_equal"] \
            and row["popcount_is_cell_less_1"] \
            and row["committed_is_cell_less_1"]
        rec["rows"][name] = row
        del sim, st, sks_d, svs_d
        torch.cuda.empty_cache()
    rec.update(oom_boundary=boundary, ok=ok_all)
    launches.stop(rec, KAFKA_EXPECT)
    emit(rec)
    if not ok_all:
        raise AssertionError(f"kafka_node_sweep: {rec}")


def kafka_faulted_1k(kafka, faults, kernels, device, launches: Launches,
                     card: str) -> None:
    """benchmarks/fault_sweep.py's faulted Kafka points under a crash
    window over rounds [1, 3) of every 97th node and loss 0.1 until round
    3 (seed 7 / 8): ``_kafka_faulted_repl_row`` and
    ``_kafka_blocked_timing_row`` at 1,024 nodes (10,000 keys, capacity
    128, 16 sends, 2 rounds, dup 0.05 too, inert here) and
    ``_kafka_blocked_timing_row`` at 4,096 nodes (256 keys, capacity 64,
    one send): the materialized faulted union, the blocked one (slabs of
    256 / 512) and, at 1,024, the matmul oracle, each timed, equal field
    by field."""
    import numpy as np
    import torch

    rec = {"phase": "kafka_faulted_1k", "card": card, "points": {}}
    launches.start()
    for n, k, cap, s, block, matmul, dup, seed in KAFKA_FAULTED:
        rounds = 2
        extra = dict(dup_rate=0.05, dup_until=rounds + 1) if dup else {}
        spec = faults.NemesisSpec(
            n_nodes=n, seed=seed,
            crash=((1, rounds + 1, tuple(range(0, n, 97))),),
            loss_rate=0.1, loss_until=rounds + 1, **extra)
        rng = np.random.default_rng(seed)
        sks = rng.integers(0, k, (rounds, n, s)).astype(np.int32)
        svs = rng.integers(0, 1 << 20, (rounds, n, s)).astype(np.int32)
        sks_d, svs_d = (torch.from_numpy(x).to(device) for x in (sks, svs))
        ways = [("materialized", dict(union_block="materialized")),
                ("blocked", dict(union_block=block))]
        if matmul:
            ways.append(("matmul_oracle", dict(repl_fast=False)))
        point = {"n": n, "keys": k, "capacity": cap, "sends": s,
                 "rounds": rounds, "dup": dup, "seed": seed, "ways": {}}
        finals = {}
        for name, kw in ways:
            sim = kafka.KafkaSim(n, k, cap, max_sends=s, device=device,
                                 fault_plan=spec.compile(device), **kw)

            def stage(sim=sim):
                st = sim.init_state()
                return lambda: sim.run_fused(st, sks_d, svs_d)

            point["ways"][name] = {"union_block": sim._ub,
                                   **kafka_timed(kernels, stage, rounds),
                                   "no_host_sync": True}
            finals[name] = no_host_sync(stage())
            del sim
        ref = finals["materialized"]
        point["equal"] = all(same_kafka(ref, st) for st in finals.values())
        point["allocated"] = allocated(ref)
        point["msgs"] = int(ref.msgs)
        rec["points"][f"nodes-{n}"] = point
        del finals, ref
        torch.cuda.empty_cache()
    rec["ok"] = all(p["equal"] for p in rec["points"].values())
    launches.stop(rec, ("kafka_nem_deliver", "kafka_merge"))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"kafka_faulted_1k: {rec}")


def kafka_nemesis_4k(kafka, nemesis, faults, kernels, device,
                     launches: Launches, card: str) -> None:
    """benchmarks/fault_sweep.py's large-N faulted Kafka row (:336-341):
    ``random_spec(4096, seed=2, horizon=12, n_crash_windows=1,
    loss_rate=0.1)``, 1,024 keys, capacity 128, one send a node, 12
    driven rounds of ``stage_kafka_ops`` traffic with commits, the resync
    every 4 rounds, then quiescent rounds until every node's presence
    agrees (at most 48).  Pull and push through the port's
    ``run_kafka_nemesis`` with provenance on, each result equal to the
    CPU runner's; pull over the device KV through the port's
    ``kafka_campaign`` and ``kafka_lost_writes`` (the runner takes no
    ``kv_backend``), equal to its CPU path and to the pull runner's
    campaign, its staged rounds with no host sync.  ``ok``: every verdict
    (converged, no lost write, no committed cache above its cell, the
    provenance certificate) and every twin.  The three CPU twins run in a
    background process (:class:`BackgroundTwin`) while the smoke goes on;
    the record waits in :data:`PENDING` and :func:`finish_pending` holds
    it against them."""
    import torch
    from gossip_glomers_tpu_torch.harness.checkers import check_recovery

    n, k, cap, s = KAFKA_NEMESIS
    spec = kafka_nemesis_spec(faults)
    clear = max(spec.clear_round, 12)
    kw = kafka_nemesis_kw()
    twin = BackgroundTwin(cpu_kafka_nemesis, ())
    rec = {"phase": "kafka_nemesis_4k", "card": card, "n": n, "keys": k,
           "capacity": cap, "sends": s, "clear_round": clear,
           "spec": {"crash": [[a, b, len(ns)] for a, b, ns in spec.crash],
                    "loss_rate": spec.loss_rate,
                    "loss_until": spec.loss_until, "seed": spec.seed},
           "ways": {}}
    launches.start()
    results = {}
    for way in ("pull", "push"):
        before = dict(kernels.LAUNCHES)
        res, wall = event_ms(lambda: nemesis.run_kafka_nemesis(
            spec, resync_mode=way, device=device, **kw))
        port = add_trip(kernels, before)
        rounds = (res["converged_round"] if res["converged_round"]
                  is not None else clear + 48)
        check = res["provenance"]["check"]
        rec["ways"][way] = {
            "rounds": rounds, "converged_round": res["converged_round"],
            "wall_ms": wall, "ms_per_round": wall / rounds,
            "launches_per_round": port / rounds,
            "allocated": res["n_allocated"],
            "lost_writes": res["n_lost_writes"], "msgs": res["msgs_total"],
            "provenance_ok": not check["problems"],
            "n_direct": check["n_direct"], "n_resync": check["n_resync"],
            "ok": res["ok"]}
        results[way] = res
    # the device KV: the runner's campaign and verdict on its own sim
    sks, svs, crs = nemesis.stage_kafka_ops(spec, clear, n_keys=k,
                                            max_sends=s)
    staged = tuple(torch.from_numpy(x).to(device) for x in (sks, svs, crs))

    def make(dev):
        return kafka.KafkaSim(n, k, cap, max_sends=s, device=dev,
                              fault_plan=spec.compile(dev), resync_every=4,
                              kv_backend="device")

    def campaign(sim, batches):
        return nemesis.kafka_campaign(sim, spec, batches, clear)

    sim = make(device)
    no_host_sync(lambda: sim.run_fused(sim.init_state(), *staged))
    (st, _, _, at_clear, conv), wall = event_ms(lambda: campaign(sim,
                                                                 staged))
    ok, det = check_recovery(
        clear_round=clear, converged_round=conv, max_recovery_rounds=48,
        lost_writes=nemesis.kafka_lost_writes(sim, st,
                                              spec.host_members(clear)),
        msgs_at_clear=at_clear, msgs_at_converged=int(st.msgs))
    rounds = st.t

    def stage():
        return lambda: campaign(sim, staged)

    busy, spans = busy_and_spans(stage)
    port = launches_of(kernels, stage())
    pull = results["pull"]
    rec["ways"]["pull_device_kv"] = {
        "rounds": rounds, "converged_round": conv, "wall_ms": wall,
        "ms_per_round": wall / rounds, "device_busy_ms": busy,
        "device_idle_share": idle_share(busy, wall),
        "launches_per_round": port / rounds,
        "device_spans_per_round": None if spans is None
        else spans / rounds,
        "allocated": allocated_slots(st),
        "lost_writes": det["n_lost_writes"], "msgs": int(st.msgs),
        "staged_rounds_no_host_sync": True, "ok": ok,
        "host_kv_match": (conv, int(st.msgs), allocated_slots(st),
                          det["n_lost_writes"])
        == (pull["converged_round"], pull["msgs_total"],
            pull["n_allocated"], pull["n_lost_writes"])}
    launches.stop(rec, ("kafka_merge", "kafka_nem_deliver",
                        "kafka_commit_select", "kafka_commit_apply"))
    card_st = host_copy(st)

    def hold(rec, twin_out):
        cpu, cst = twin_out
        for way, res in results.items():
            rec["ways"][way]["cpu_match"] = same_result(res, cpu[way])
        rec["ways"]["pull_device_kv"]["cpu_match"] = same_kafka(card_st,
                                                                cst)
        rec["ok"] = all(r["ok"] and r["cpu_match"]
                        for r in rec["ways"].values()) \
            and rec["ways"]["pull_device_kv"]["host_kv_match"]

    PENDING.append((rec, twin, hold))
    del sim, st
    torch.cuda.empty_cache()


def kafka_nemesis_spec(faults):
    """fault_sweep.py:336-341's plan at :data:`KAFKA_NEMESIS`'s nodes."""
    return faults.random_spec(KAFKA_NEMESIS[0], seed=2, horizon=12,
                              n_crash_windows=1, loss_rate=0.1)


def kafka_nemesis_kw() -> dict:
    n, k, cap, s = KAFKA_NEMESIS
    return dict(n_keys=k, capacity=cap, max_sends=s, rounds=12,
                provenance=True)


def cpu_kafka_nemesis() -> tuple:
    """kafka_nemesis_4k's CPU twins: the pull and push runners' results
    and the device-KV campaign's final state, on the port's CPU path."""
    import torch

    from gossip_glomers_tpu_torch.harness import nemesis
    from gossip_glomers_tpu_torch.tpu_sim import faults, kafka

    torch.set_num_threads(SMALL_TWIN_THREADS)
    n, k, cap, s = KAFKA_NEMESIS
    spec = kafka_nemesis_spec(faults)
    clear = max(spec.clear_round, 12)
    kw = kafka_nemesis_kw()
    results = {way: nemesis.run_kafka_nemesis(spec, resync_mode=way,
                                              device="cpu", **kw)
               for way in ("pull", "push")}
    sim = kafka.KafkaSim(n, k, cap, max_sends=s, device="cpu",
                         fault_plan=spec.compile("cpu"), resync_every=4,
                         kv_backend="device")
    staged = nemesis.stage_kafka_ops(spec, clear, n_keys=k, max_sends=s)
    st = nemesis.kafka_campaign(sim, spec, staged, clear)[0]
    return results, st




def same_result(a: dict, b: dict) -> bool:
    """Two runner results agree on every field (numpy arrays by value)."""
    import numpy as np

    if a.keys() != b.keys():
        return False
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, dict) and isinstance(y, dict):
            if not same_result(x, y):
                return False
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if not np.array_equal(np.asarray(x), np.asarray(y)):
                return False
        elif x != y:
            return False
    return True


def kafka_device_ops(kafka, faults, kernels, device, card: str) -> None:
    """The Kafka round's device functions that stay PyTorch ops, each
    timed two ways: ``ms`` the CUDA-event time of back-to-back calls,
    ``device_ms`` the profiler's time of all the spans of one call
    (``spans`` of them). At config5b's 1,024-node row (16,384 sends,
    10,000 keys, capacity 128) and its 262,144-node row (one send a node,
    16,384 keys, capacity 64): ``_alloc`` (the stable sort, the max
    scan, the counts), ``_append`` (the log write) and ``_send_bits``
    with the union row's scatter; config5's poll batch (4,096 queries at
    8 nodes, 10,000 keys); and at the faulted 1,024-node point the matmul
    oracle's delivery (``_matmul_deliver``: the byte planes, the float16
    product, the recombination)."""
    import torch

    def both(fn):
        busy, spans = busy_and_spans(lambda: fn)
        return {"ms": cuda_ms(fn, samples=3, inner=5), "device_ms": busy,
                "spans": spans}

    gen = torch.Generator(device=device).manual_seed(21)
    rec = {"phase": "kafka_device_ops", "card": card, "ops": {}}
    for n, s, k, cap in ((1024, 16, 10_000, 128), (262144, 1, 16384, 64)):
        wc = (cap + 31) // 32
        keys = kafka_ints(0, k, (n, s), gen, device)
        vals = kafka_ints(0, 1 << 20, (n * s,), gen, device)
        kv = kafka_ints(0, 4, (k,), gen, device)
        ones = torch.ones(n, dtype=torch.bool, device=device)
        log_vals = torch.full((k, cap), -1, dtype=torch.int32, device=device)
        _, _, keys_c, _, slot, ok = kafka._alloc(kv, keys, ones, None, k,
                                                 cap)
        keys64 = keys_c.to(torch.int64)

        def union_row():
            widx, bit = kafka._send_bits(ok, keys64, slot, wc)
            return kafka._scatter_bits(widx, ok, bit, k * wc)

        rec["ops"][f"{n}x{s}_k{k}"] = {
            "alloc": both(lambda: kafka._alloc(kv, keys, ones, None, k,
                                               cap)),
            "append": both(lambda: kafka._append(log_vals, ok, keys64,
                                                 slot, vals)),
            "send_bits_union_row": both(union_row)}
        del keys, vals, log_vals, keys_c, slot, ok, keys64
    n, k, cap, s = KAFKA_10K
    sim = kafka.KafkaSim(n, k, cap, max_sends=s, device=device)
    present = kafka_words((n, k), cap, gen, device)
    log_vals = kafka_ints(0, 1 << 20, (k, cap), gen, device)
    q = [kafka_ints(0, hi, (KAFKA_POLL_Q,), gen, device)
         for hi in (n, k, cap)]
    fn = sim.poll_batch_program()
    rec["ops"]["poll_batch_q4096"] = both(lambda: fn(present, log_vals, *q))
    n, k, cap, s = KAFKA_FAULTED[0][:4]
    spec = faults.NemesisSpec(n_nodes=n, seed=7, crash=((1, 3, (0,)),),
                              loss_rate=0.1, loss_until=3)
    sim = kafka.KafkaSim(n, k, cap, max_sends=s, device=device,
                         fault_plan=spec.compile(device), repl_fast=False)
    own = kafka_words((n, k), cap, gen, device, sparse=8)
    repl_ok = torch.ones((n, n), dtype=torch.bool, device=device)
    rec["ops"]["matmul_deliver_1024"] = both(
        lambda: sim._matmul_deliver(own, repl_ok, sim.fault_plan, 1))
    emit(rec)
    del sim, present, own
    torch.cuda.empty_cache()


def kafka_phases(kafka, nemesis, faults, kernels, device,
                 launches: Launches, card: str) -> None:
    """Challenge 5 on the card: config5, config5b and fault_sweep.py's
    faulted points and large-N row."""
    kafka_device_ops(kafka, faults, kernels, device, card)
    kafka_10k(kafka, kernels, device, launches, card)
    kafka_node_sweep(kafka, kernels, device, launches, card)
    kafka_faulted_1k(kafka, faults, kernels, device, launches, card)
    kafka_nemesis_4k(kafka, nemesis, faults, kernels, device, launches,
                     card)


# -- causal provenance and the nemesis campaign runners ---------------------

# the attribution modes of prov_attribute (the gather round's): one hop
# with no flags, partition flags, plan flags, plan flags with dup rows; the
# delay ring's slot bytes, without and with the receiver's liveness
PROV_MODES = ("plain", "partitions", "plan", "plan_dup", "delays",
              "delays_plan")
# (nodes, words, values, directions): odd and ragged shapes (V not a
# multiple of 32, spare words); the tree phase's captured rounds add its
# (2^20, 1, 32, 5)
PROV_SHAPES = ((1, 1, 1, 1), (5, 1, 7, 3), (37, 3, 70, 7), (4097, 2, 45, 5),
               ((1 << 16) + 3, 1, 32, 8))
# fault_sweep.py --structured's plan on the main path's tree: the
# provenance campaign's rounds whose attribution is captured (a faulted
# flood round and the first sync wave)
PROV_CAPTURE_ROUNDS = (5, 8)
PROV_EXPECT = ("prov_attribute", "fault_coins", "faulted_gather_round",
               "col_popcount_nm")


def prov_case(kernels, mode: str, n: int, w: int, nv: int, d: int,
              seed: int, device) -> dict:
    """Seeded :func:`kernels.prov_attribute` arguments in ``mode``: the
    new bits (none past V), stamps so far, a table with padded (-1)
    directions, and the mode's payload, flag bytes, dup rows, or ring
    and slot bytes."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, dtype=torch.int32,
                             device=device, generator=gen)

    def coin(p, shape):
        return torch.rand(shape, device=device, generator=gen) < p

    def words(*shape):
        return ints(-(1 << 31), 1 << 31, shape)

    nbrs = torch.where(coin(0.3, (n, d)), -1, ints(0, n, (n, d)))
    arrival = torch.where(coin(0.4, (n, nv)), ints(0, 6, (n, nv)), -1)
    parent = torch.where(arrival > 0, ints(-1, n, (n, nv)), -1)
    keep = kernels._wrap_i32(torch.tensor(
        [(1 << min(32, max(0, nv - 32 * c))) - 1 for c in range(w)],
        dtype=torch.int64, device=device))
    valid = nbrs >= 0
    edges = {}
    if mode.startswith("delays"):
        src = words(3, n, w)
        slots = torch.where(valid & coin(0.8, (n, d)), ints(0, 3, (n, d)),
                            -1).to(torch.int8)
        if mode == "delays_plan":
            slots = slots.masked_fill(~coin(0.8, (n,))[:, None], -1)
        edges["slots"] = slots
    else:
        src = words(n, w)
        live = valid & coin(0.8, (n, d))
        if mode == "partitions":
            edges["flags"] = live.to(torch.uint8) * kernels.FLAG_DEL
        elif mode.startswith("plan"):
            dele = live & coin(0.8, (n, d))
            flags = (live.to(torch.uint8) * kernels.FLAG_SEND
                     + dele.to(torch.uint8) * kernels.FLAG_DEL)
            if mode == "plan_dup":
                flags += (dele & coin(0.4, (n, d))).to(torch.uint8) \
                    * kernels.FLAG_DUP
                edges["dup"] = words(n, w)
            edges["flags"] = flags
    return dict(new=words(n, w) & keep, src=src, nbrs=nbrs.contiguous(),
                arrival=arrival, parent=parent, t_next=7, edges=edges)


def prov_pairs(kernels, case: dict) -> list:
    """``[(kernel, plain)]`` of the two stamps of one
    :func:`kernels.prov_attribute` call (in place, on copies of the
    stamps) and its plain version."""
    want = kernels.prov_attribute_plain(
        case["new"], case["src"], case["nbrs"], case["arrival"],
        case["parent"], t_next=case["t_next"], **case["edges"])
    arr, par = case["arrival"].clone(), case["parent"].clone()
    kernels.prov_attribute(case["new"], case["src"], case["nbrs"], arr, par,
                           t_next=case["t_next"], **case["edges"])
    return [(arr, want[0]), (par, want[1])]


def check_prov(kernels, note, device) -> None:
    """``prov_attribute`` against its plain version in every mode at
    :data:`PROV_SHAPES` (the tree phase checks its own captured rounds)."""
    import torch

    for i, (n, w, nv, d) in enumerate(PROV_SHAPES):
        for mode in PROV_MODES:
            note("prov_attribute", *prov_pairs(kernels, prov_case(
                kernels, mode, n, w, nv, d, 31 * i + len(mode), device)))
        torch.cuda.empty_cache()


# a rank's rows of a mesh round: (nodes, words, values, directions) cut
# into 2 and 4 row blocks, each stamped against the whole source rows
# (what a mesh round all-gathers), in flag mode and in slot mode over a
# stack of widened ring slots
PROV_BLOCK_SHAPES = ((4096, 2, 45, 5), (1 << 16, 1, 32, 8))
PROV_BLOCK_MODES = ("plan_dup", "partitions", "delays_plan")
PROV_BLOCK_SHARDS = (2, 4)


def prov_block_case(case: dict, shards: int, r: int) -> dict:
    """Rank ``r``'s part of a :func:`prov_case` over ``shards`` row blocks:
    its rows of the new bits, table, stamps and edge bytes; the source
    rows (and dup rows) whole, the table's ids global."""
    b = case["new"].shape[0] // shards
    rows = slice(r * b, (r + 1) * b)

    def cut(x):
        return x[rows].contiguous()

    return dict(case, new=cut(case["new"]), nbrs=cut(case["nbrs"]),
                arrival=cut(case["arrival"]), parent=cut(case["parent"]),
                edges={k: v if k == "dup" else cut(v)
                       for k, v in case["edges"].items()})


def prov_block_pairs(kernels, case: dict, shards: int) -> list:
    """``[(kernel, plain)]`` of every rank's block of ``case``
    (:func:`prov_block_case`), then of the blocks' stamps combined
    against the kernel on the whole problem."""
    import torch

    out, arrs, pars = [], [], []
    for r in range(shards):
        pairs = prov_pairs(kernels, prov_block_case(case, shards, r))
        out += pairs
        arrs.append(pairs[0][0])
        pars.append(pairs[1][0])
    whole = prov_pairs(kernels, case)
    return out + [(torch.cat(arrs), whole[0][0]),
                  (torch.cat(pars), whole[1][0])]


def check_prov_blocks(kernels, note, device) -> None:
    """``prov_attribute`` on a rank's rows (fewer rows than sources)
    against its plain version, and 2 and 4 blocks combined against the
    whole problem, in :data:`PROV_BLOCK_MODES`."""
    import torch

    for i, (n, w, nv, d) in enumerate(PROV_BLOCK_SHAPES):
        for mode in PROV_BLOCK_MODES:
            case = prov_case(kernels, mode, n, w, nv, d, 53 * i + len(mode),
                             device)
            for shards in PROV_BLOCK_SHARDS:
                note("prov_attribute", *prov_block_pairs(kernels, case,
                                                         shards))
        torch.cuda.empty_cache()


def prov_capture(kernels, rounds):
    """``(wrapped, kept)``: a stand-in for :func:`kernels.prov_attribute`
    that keeps copies of its arguments at the ``rounds`` it stamps (the
    stamps before the call) in ``kept``, then calls the kernel."""
    real = kernels.prov_attribute
    kept = {}

    def wrapped(new, src, nbrs, arrival, parent, *, t_next, **edges):
        t = t_next - 1
        if t in rounds and t not in kept:
            kept[t] = dict(new=new.clone(), src=src.clone(), nbrs=nbrs,
                           arrival=arrival.clone(), parent=parent.clone(),
                           t_next=t_next,
                           edges={k: None if v is None else v.clone()
                                  for k, v in edges.items()})
        return real(new, src, nbrs, arrival, parent, t_next=t_next,
                    **edges)

    return wrapped, kept


def prov_work(kernels, case: dict) -> dict:
    """What one attribution needs, counted from its inputs the way the
    kernel walks them: new words read; a thread whose word holds a fresh
    bit reads its table entry and edge byte for each direction it walks
    (until every fresh bit is attributed) and one random source word for
    each delivering one (a 32-byte sector each); the arrival cell of each
    new bit read, both stamps of each fresh one written."""
    import torch

    new, nbrs, arr = case["new"], case["nbrs"], case["arrival"]
    edges = case["edges"]
    n, w = new.shape
    nv, d = arr.shape[1], nbrs.shape[1]
    bits = kernels.unpack_bits(new, nv)
    fresh = bits & (arr < 0)
    pad = torch.zeros((n, 32 * w), dtype=torch.bool, device=new.device)
    pad[:, :nv] = fresh
    fresh_w = kernels.pack_bits(pad.view(n, w, 32)).view(n, w)
    remaining = new.clone()
    walked = reads = 0
    flags, dup, slots = (edges.get("flags"), edges.get("dup"),
                         edges.get("slots"))
    for k in range(d):
        active = (remaining & fresh_w) != 0
        walked += int(active.sum())
        if slots is not None:
            reads += int((active & (slots[:, k:k + 1] >= 0)).sum())
        else:
            f = (nbrs[:, k:k + 1] >= 0).to(torch.uint8) * kernels.FLAG_DEL \
                if flags is None else flags[:, k:k + 1]
            reads += int((active & ((f & kernels.FLAG_DEL) != 0)).sum())
            if dup is not None:
                reads += int((active & ((f & kernels.FLAG_DUP) != 0)).sum())
        term = kernels._prov_term(k, case["src"], nbrs, flags, dup, slots)
        remaining = remaining & ~(term & remaining)
    n_new, n_fresh = int(bits.sum()), int(fresh.sum())
    moved = 4 * n * w + 5 * walked + 4 * reads + 4 * n_new + 8 * n_fresh
    return {"new_bits": n_new, "fresh_bits": n_fresh, "walked": walked,
            "source_reads": reads, "bytes": moved,
            "ops": 2 * n * w + 6 * walked + 3 * n_new + 4 * n_fresh}


def time_prov(kernels, case: dict) -> dict:
    """``prov_attribute`` on one captured round: its device time (the
    profiler's spans of the kernel alone), the CUDA-event time of
    back-to-back calls less that of the stamps' restoring copies (each
    call gets the stamps as they were before the round, so each does the
    round's work), the plain version's time and the bound from
    :func:`prov_work`: the bytes at HBM's rate or the random source reads
    at the L2's sector rate, whichever is longer."""
    arr0, par0 = case["arrival"], case["parent"]
    arr, par = arr0.clone(), par0.clone()
    args = (case["new"], case["src"], case["nbrs"])

    def restore():
        arr.copy_(arr0)
        par.copy_(par0)

    def kern():
        restore()
        kernels.prov_attribute(*args, arr, par, t_next=case["t_next"],
                               **case["edges"])

    work = prov_work(kernels, case)
    by = bound(work["bytes"], work["ops"])
    sector_ms = work["source_reads"] * 32 / L2_BYTES_PER_S * 1e3
    b_ms, b_by = (sector_ms, "bytes") if sector_ms > by[0] else by
    dev = device_ms(kern, KERNELS["prov_attribute"][2], calls=10)
    return {"ms": cuda_ms(kern) - cuda_ms(restore), "device_ms": dev,
            "plain_ms": cuda_ms(lambda: kernels.prov_attribute_plain(
                *args, arr0, par0, t_next=case["t_next"], **case["edges"]),
                inner=3),
            "bound_ms": b_ms, "bound_by": b_by, "sector_ms": sector_ms,
            "bytes_ms": by[0] if by[1] == "bytes" else None,
            "bound_share": None if dev is None else b_ms / dev,
            "library_ms": None, **work}


# the provenance campaign's values: 16, cut from the main path's 32 for
# the smoke's time limit (depth: the host certificate walks every (node,
# value) cell, 2^24 of them)
PROV_VALUES = 16


def tree_prov_sim(broadcast, topology, faults, n: int, device, mesh=None):
    """The provenance campaign's sim: the 4-ary tree through the gather
    path (D = 5) under :func:`tree_nemesis_spec`, :data:`PROV_VALUES`
    values, sync waves every 8 rounds, as harness/nemesis.py builds it
    (on ``mesh`` a rank's rows of it)."""
    nbrs = topology.to_padded_neighbors(topology.tree(n, branching=BRANCHING))
    place = dict(device=device) if mesh is None else dict(mesh=mesh)
    return broadcast.BroadcastSim(
        nbrs, n_values=PROV_VALUES, sync_every=8, srv_ledger=False,
        fault_plan=tree_nemesis_spec(faults, n).compile(
            device if mesh is None else mesh.device), **place)


def nemesis_tree_1m_provenance(modules, device, launches: Launches,
                               card: str, times: dict) -> None:
    """The main path's topology under fault_sweep.py --structured's plan
    (:func:`tree_nemesis_spec`) through the port's
    ``run_broadcast_nemesis(n_values=16, topology="tree", sync_every=8)``
    on the gather path at 2^20 nodes, with telemetry and provenance on,
    then with observation off.  ``ok``: both verdicts, the provenance
    certificate, the tree's first-delivery edges within ``msgs_total``,
    and the two campaigns' rounds, ``msgs`` and received sets equal (the
    last from the two fixed trips of the campaign's rounds, each timed
    with CUDA events and profiled for its device busy time).  Also holds
    ``prov_attribute`` against its plain version on the rounds of
    :data:`PROV_CAPTURE_ROUNDS` and times it there."""
    import torch

    broadcast, nemesis, faults, topology, kernels = modules
    from gossip_glomers_tpu_torch.tpu_sim import provenance as PV
    n = N_NODES
    rec = {"phase": "nemesis_tree_1m_provenance", "card": card, "n": n,
           "n_values": PROV_VALUES, "degree": BRANCHING + 1,
           "sync_every": 8,
           "crash": [2, 16, "range(0, n, 97)"], "loss_rate": 0.1,
           "dup_rate": 0.05, "until": 17}
    spec = tree_nemesis_spec(faults, n)
    kw = dict(n_values=PROV_VALUES, topology="tree", sync_every=8,
              device=device)
    launches.start()
    before = dict(kernels.LAUNCHES)
    on, wall_on = event_ms(lambda: nemesis.run_broadcast_nemesis(
        spec, telemetry=True, provenance=True, **kw))
    add_trip(kernels, before)
    launches.stop(rec, PROV_EXPECT)
    off, wall_off = event_ms(lambda: nemesis.run_broadcast_nemesis(
        spec, telemetry=False, provenance=False, **kw))
    check = on["provenance"]["check"]
    tree = on["provenance"]["tree"]
    rounds = on["converged_round"]
    # the campaign's rounds as fixed trips, observation off and on: the
    # device side of provenance's cost and the received sets
    sim = tree_prov_sim(broadcast, topology, faults, n, device)
    inject = broadcast.make_inject(n, PROV_VALUES)
    psp = PV.ProvenanceSpec("broadcast")
    def trip_off():
        state0 = sim.init_state(inject)
        return lambda: sim.run_staged_fixed(state0, rounds, donate=True)

    def trip_on():
        state0 = sim.init_state(inject)
        prov0 = sim.provenance_state(psp, inject)
        return lambda: sim.run_observed(state0, None, None, rounds,
                                        donate=True, prov=prov0,
                                        prov_spec=psp)[0]

    plain, ms_off = event_ms(trip_off())
    obs, ms_on = event_ms(trip_on())
    same_received = bool(torch.equal(plain.received, obs.received))
    # what mesh_provenance_batches's ranks are held against
    MESH_PROV_ONE["tree"] = {"result": prov_result(on), "rounds": rounds,
                             "blocks": row_blocks(plain.received,
                                                  MESH_RANKS)}
    del plain, obs
    busy_off, spans_off = busy_and_spans(trip_off)
    busy_on, spans_on = busy_and_spans(trip_on)
    rec.update(
        rounds=rounds, clear_round=on["clear_round"],
        msgs_total=on["msgs_total"], n_lost_writes=on["n_lost_writes"],
        recovery_rounds=on["recovery_rounds"],
        n_arrivals=check["n_arrivals"], n_tree_edges=check["n_tree_edges"],
        n_origins=check["n_origins"], provenance_ok=not check["problems"],
        problems=check["problems"][:3],
        telemetry_ok=not on["telemetry"]["check"]["problems"],
        max_depth_hops=tree["max_depth_hops"],
        max_span_rounds=tree["max_span_rounds"],
        critical_path_hops=tree["critical_path"]["hops"],
        wall_ms_observed=wall_on, wall_ms_plain=wall_off,
        trip_ms_observed=ms_on, trip_ms_plain=ms_off,
        trip_busy_ms_observed=busy_on, trip_busy_ms_plain=busy_off,
        trip_idle_share_observed=idle_share(busy_on, ms_on),
        trip_idle_share_plain=idle_share(busy_off, ms_off),
        trip_spans_observed=spans_on, trip_spans_plain=spans_off,
        stamp_bytes=2 * n * PROV_VALUES * 4,
        off_rounds=off["converged_round"], off_msgs=off["msgs_total"],
        same_received=same_received)
    rec["ok"] = bool(on["ok"] and off["ok"] and rec["provenance_ok"]
                     and check["n_tree_edges"] <= on["msgs_total"]
                     and rounds == off["converged_round"]
                     and on["msgs_total"] == off["msgs_total"]
                     and same_received)
    del on, off
    # the kernel on the campaign's own rounds: captured in a short
    # observed run of the same sim, held against its plain version, timed
    wrapped, kept = prov_capture(kernels, PROV_CAPTURE_ROUNDS)
    real = kernels.prov_attribute
    kernels.prov_attribute = wrapped
    try:
        sim.run_observed(sim.init_state(inject), None, None,
                         max(PROV_CAPTURE_ROUNDS) + 1, donate=True,
                         prov=sim.provenance_state(psp, inject),
                         prov_spec=psp)
    finally:
        kernels.prov_attribute = real
    rec["kernel"] = {}
    for t, case in sorted(kept.items()):
        err = max(max_abs_err(a, b) for a, b in prov_pairs(kernels, case))
        timed = time_prov(kernels, case)
        timed["max_abs_err"] = err
        rec["kernel"][f"round_{t}"] = timed
        if err:
            rec["ok"] = False
    # the kernels line's row: the faulted flood round's
    times["prov_attribute"][(1, n)] = dict(
        rec["kernel"][f"round_{PROV_CAPTURE_ROUNDS[0]}"])
    times["prov_attribute"][(1, n)]["also"] = rec["kernel"]
    # and over a rank's rows of that round (a mesh of MESH_RANKS: its
    # rows' stamps against the whole all-gathered payload), the rank
    # whose rows the round's new bits land in most
    whole = kept[PROV_CAPTURE_ROUNDS[0]]
    rows = n // MESH_RANKS
    r = max(range(MESH_RANKS), key=lambda q: int(kernels.popcount(
        whole["new"][q * rows:(q + 1) * rows]).sum()))
    case = prov_block_case(whole, MESH_RANKS, r)
    blk = time_prov(kernels, case)
    blk["max_abs_err"] = max(max_abs_err(x, y)
                             for x, y in prov_pairs(kernels, case))
    blk.update(rows=rows, sources=n, rank=r)
    times["prov_attribute_block"] = {(1, n // MESH_RANKS): blk}
    rec["kernel"]["rank_rows"] = blk
    if blk["max_abs_err"]:
        rec["ok"] = False
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"nemesis_tree_1m_provenance: {rec}")
    del sim, kept
    torch.cuda.empty_cache()


# fault_sweep.py:590-601's large-N counter row: 2^17 nodes, allreduce,
# default_rng(0) deltas in [0, 10), the fault gate in 16,384-node slabs
COUNTER_PROV_BLOCK = 16384
COUNTER_PROV_EXPECT = ("counter_select", "counter_apply")


def nemesis_counter_128k_provenance(nemesis, faults, kernels, device,
                                    launches: Launches, card: str) -> None:
    """fault_sweep.py:590-601's row through the port's
    ``run_counter_nemesis``: :func:`counter_nemesis_spec` (``random_spec(
    2^17, seed=1, horizon=12, 2 windows, loss 0.1)``, crash shifted by 4),
    allreduce, ``union_block=16384``, telemetry and provenance on, then
    off.  ``ok``: the verdict and the provenance certificate pass, and the
    two campaigns agree in rounds, ``kv`` and ``msgs``."""
    import numpy as np

    n = COUNTER_NEMESIS_NODES
    spec = counter_nemesis_spec(faults, n)
    deltas = np.random.default_rng(0).integers(0, 10, n).astype(np.int32)
    kw = dict(mode="allreduce", deltas=deltas,
              union_block=COUNTER_PROV_BLOCK, device=device)
    rec = {"phase": "nemesis_counter_128k_provenance", "card": card, "n": n,
           "union_block": COUNTER_PROV_BLOCK,
           "spec": {"crash": [[s, e, len(ns)] for s, e, ns in spec.crash],
                    "loss_rate": spec.loss_rate,
                    "loss_until": spec.loss_until, "seed": spec.seed}}
    launches.start()
    before = dict(kernels.LAUNCHES)
    on, wall_on = event_ms(lambda: nemesis.run_counter_nemesis(
        spec, telemetry=True, provenance=True, **kw))
    add_trip(kernels, before)
    launches.stop(rec, COUNTER_PROV_EXPECT)
    off, wall_off = event_ms(lambda: nemesis.run_counter_nemesis(
        spec, telemetry=False, provenance=False, **kw))
    check = on["provenance"]["check"]
    rec.update(converged_round=on["converged_round"],
               clear_round=on["clear_round"], kv=on["kv"],
               acked_sum=on["acked_sum"], msgs_total=on["msgs_total"],
               n_lost_writes=on["n_lost_writes"],
               n_flushed=check["n_flushed"], n_visible=check["n_visible"],
               provenance_ok=not check["problems"],
               problems=check["problems"][:3],
               wall_ms_observed=wall_on, wall_ms_plain=wall_off)
    rec["ok"] = bool(on["ok"] and rec["provenance_ok"]
                     and (off["converged_round"], off["kv"],
                          off["msgs_total"])
                     == (on["converged_round"], on["kv"], on["msgs_total"]))
    MESH_PROV_ONE["counter"] = prov_result(on)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"nemesis_counter_128k_provenance: {rec}")


def allocated_slots(state) -> int:
    """The (key, slot) cells the log holds."""
    return int((state.log_vals >= 0).sum())


# telemetry_overhead.py:200-232: the faulted sweep point, provenance on
KAFKA_PROV_POINT = (1024, 10_000, 128, 16, 256, 2)


def kafka_sweep_point_provenance(kafka, nemesis, faults, kernels, device,
                                 launches: Launches, card: str) -> None:
    """telemetry_overhead.py:200-232's point: 1,024 nodes, 10,000 keys,
    capacity 128, 16 sends a node, ``union_block=256``, every 97th node
    down and loss 0.1 over the 2 rounds, seed 5, a send-only campaign:
    ``run_observed(prov=)`` against ``run_rounds``, both timed.  ``ok``:
    the states are equal and slots were allocated.  The record's
    certificate is reported, not required: two faulted rounds end before
    the resync, and the witness (node 0) is down in both, so its
    first-presence stamps stay empty."""
    import torch
    from gossip_glomers_tpu_torch.harness.checkers import check_provenance
    from gossip_glomers_tpu_torch.tpu_sim import provenance as PV

    n, k, cap, s, block, rounds = KAFKA_PROV_POINT
    spec = faults.NemesisSpec(n_nodes=n, seed=5,
                              crash=((0, rounds, tuple(range(0, n, 97))),),
                              loss_rate=0.1, loss_until=rounds)
    sks, svs, _ = nemesis.stage_kafka_ops(spec, rounds, n_keys=k,
                                          max_sends=s, workload_seed=0,
                                          commits=False)
    sim = kafka.KafkaSim(n, k, cap, max_sends=s, device=device,
                         fault_plan=spec.compile(device), resync_every=4,
                         union_block=block)
    staged = [torch.from_numpy(x).to(device) for x in (sks, svs)]
    psp = PV.ProvenanceSpec("kafka")
    launches.start()
    plain, wall_off = event_ms(lambda: sim.run_rounds(sim.init_state(),
                                                      *staged))
    prov0 = sim.provenance_state(psp)
    (obs, prov), wall_on = event_ms(lambda: sim.run_observed(
        sim.init_state(), None, None, *staged, prov=prov0, prov_spec=psp))
    rec = {"phase": "kafka_sweep_point_provenance", "card": card, "n": n,
           "keys": k, "capacity": cap, "sends": s, "union_block": block,
           "rounds": rounds, "wall_ms_plain": wall_off,
           "wall_ms_observed": wall_on, "msgs": int(obs.msgs)}
    launches.stop(rec, ("kafka_merge", "kafka_nem_deliver"))
    ok_p, det = check_provenance(
        "kafka", PV.arrays_of(prov), spec=spec, n_nodes=n,
        resync_every=4, resync_mode="pull", witness=0)
    rec.update(same_state=same_kafka(plain, obs), provenance_ok=ok_p,
               n_allocated=det["n_allocated"],
               n_alloc_stamps=int((prov.alloc_round >= 1).sum()),
               n_first_present=int((prov.first_present >= 1).sum()),
               problems=det["problems"][:3])
    rec["ok"] = (rec["same_state"] and det["n_allocated"] > 0
                 and rec["n_alloc_stamps"] == allocated_slots(obs))
    b = n // MESH_RANKS
    MESH_PROV_ONE["kafka"] = {
        "blocks": [kafka_digests(obs, r * b, b) for r in range(MESH_RANKS)],
        "prov": array_digest(PV.arrays_of(prov))}
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"kafka_sweep_point_provenance: {rec}")
    del sim, plain, obs, prov
    torch.cuda.empty_cache()


def ids_echo(unique_ids, echo, device, launches: Launches,
             card: str) -> None:
    """Challenges 2 and 1 at 2^20 nodes: ``UniqueIdsSim(max_per_round=32)``
    for 4 rounds, every id distinct (checked on the card) and equal to
    the CPU path; ``EchoSim`` with 4 payload slots a node for 3 rounds,
    ``msgs == 2 valid`` and the replies equal to the CPU path.  No
    kernel: one pass of torch ops a step."""
    import numpy as np
    import torch

    n, g = IDS_ECHO_NODES, 32
    launches.start()
    rng = np.random.default_rng(0)
    sims = [unique_ids.UniqueIdsSim(n, max_per_round=g, device=d)
            for d in (device, "cpu")]
    st, cst = (s.init_state() for s in sims)
    keys, step_ms = [], []
    for _ in range(4):
        counts = rng.integers(0, g + 1, n).astype(np.int32)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        st, ids = sims[0].step(st, counts)
        ev[1].record()
        ev[1].synchronize()
        step_ms.append(ev[0].elapsed_time(ev[1]))
        cst, cids = sims[1].step(cst, counts)
        if not torch.equal(ids.cpu(), cids):
            raise AssertionError("ids_echo: GPU ids differ from the CPU "
                                 "path")
        valid = ids[..., 0] >= 0
        ids = ids.long()
        keys.append(((ids[..., 0] * n + ids[..., 1]) * g
                     + ids[..., 2])[valid])
    allk = torch.cat(keys)
    minted = int(st.minted.sum(dtype=torch.int64))
    distinct = torch.unique(allk).numel() == allk.numel() == minted
    sample = sims[0].format_ids(ids[:8].int())
    rec = {"phase": "ids_echo", "card": card, "n": n,
           "ids": {"max_per_round": g, "rounds": 4, "minted": minted,
                   "all_distinct": distinct, "step_ms": step_ms,
                   "sample": sample[:3]}}
    del keys, allk, ids, cids
    b = 4
    esims = [echo.EchoSim(n, device=d) for d in (device, "cpu")]
    es, ces = (s.init_state() for s in esims)
    n_valid = 0
    for _ in range(3):
        payload = rng.integers(-2**31, 2**31, (n, b)).astype(np.int32)
        valid = rng.random((n, b)) < 0.5
        es, rep = esims[0].step(es, payload, valid)
        ces, crep = esims[1].step(ces, payload, valid)
        if not torch.equal(rep.cpu(), crep):
            raise AssertionError("ids_echo: GPU echo replies differ from "
                                 "the CPU path")
        n_valid += int(valid.sum())
    ok = distinct and int(es.msgs) == 2 * n_valid % (1 << 32) \
        and int(es.msgs) == int(ces.msgs) and st.t == cst.t == 4
    rec["echo"] = {"slots": b, "rounds": 3, "msgs": int(es.msgs),
                   "valid": n_valid}
    rec["ok"] = ok
    launches.stop(rec, ())
    if not ok:
        raise AssertionError(f"ids_echo: {rec}")
    rec["cpu_match"] = True
    emit(rec)
    torch.cuda.empty_cache()


# -- open-loop serving (the traffic engine, its telemetry ring, the runner)

# benchmarks/serving_curve.py's full-size points on one card (:98-99,
# :113-200): (phase, workload, TrafficSpec kwargs at the lightest rate,
# the rates, sim_kw, the rates held to the CPU path)
SERVING_BIG, SERVING_SMALL = 65536, 1024
SERVING_TREE_NODES = 1 << 20
SERVING_PHASES = (
    ("serving_broadcast_64k", "broadcast",
     dict(n_nodes=SERVING_BIG, n_clients=512, ops_per_client=48, until=48,
          rate=0.1, seed=102), (0.1, 0.5),
     dict(topology="tree", structured=True, sync_every=4), (0.1,)),
    ("serving_counter_64k", "counter",
     dict(n_nodes=SERVING_BIG, n_clients=512, ops_per_client=16, until=32,
          rate=0.1, seed=104), (0.1, 0.3),
     dict(mode="allreduce", poll_every=2), (0.1, 0.3)),
    ("serving_kafka_64k", "kafka",
     dict(n_nodes=SERVING_BIG, n_clients=512, ops_per_client=16, until=32,
          rate=0.1, seed=106), (0.1, 0.3),
     dict(n_keys=64, max_sends=4), (0.1, 0.3)),
)
# the fault overlay (serving_curve.py :169-200): every fifth node down for
# the middle third of the 48-round horizon, loss 0.1 until four rounds
# after; and counter_small_1dev's cas queueing curve (:132-140)
OVERLAY_TRAFFIC = dict(n_nodes=SERVING_SMALL, n_clients=256,
                       ops_per_client=48, until=48, rate=0.2, seed=108)
OVERLAY_FAULT = dict(n_nodes=SERVING_SMALL, seed=107,
                     crash=((16, 32, tuple(range(0, SERVING_SMALL, 5))),),
                     loss_rate=0.1, loss_until=36)
OVERLAY_SIMS = (
    ("broadcast", dict(topology="grid", structured=True, sync_every=4)),
    ("kafka", dict(n_keys=64, max_sends=4, resync_every=4)),
    ("counter", dict(mode="allreduce", poll_every=2)))
CAS_CURVE_TRAFFIC = dict(n_nodes=SERVING_SMALL, n_clients=SERVING_SMALL,
                         ops_per_client=4, until=96, rate=0.001, seed=103)
CAS_CURVE_RATES = tuple(r / SERVING_SMALL for r in (0.5, 1.0, 2.0))
# the main path under load: the 2^20-node 4-ary tree, words-major, 512
# clients x 16 ops (8,192 values, W = 256), arrivals over rounds [0, 8)
# (depth: cut from 32, then 16, for the smoke's time limit), the expected
# arrivals an eighth of the op slots
SERVING_TREE = dict(n_nodes=SERVING_TREE_NODES, n_clients=512,
                    ops_per_client=16, until=8, rate=0.25, seed=101)


def and_fold_shape(kind: str, tkw: dict, rate_max: float,
                   sim_kw: dict) -> tuple:
    """(node_major, N, C): the bitset a serving sim folds with
    ``and_fold``, at the widths ``make_serving_sim`` gives it."""
    from gossip_glomers_tpu_torch.harness import serving
    from gossip_glomers_tpu_torch.tpu_sim import traffic

    n = tkw["n_nodes"]
    widths = serving.serving_widths(
        kind, traffic.TrafficSpec(**tkw).with_rate(rate_max), sim_kw)
    if kind == "broadcast":
        return (not sim_kw.get("structured", False), n,
                -(-widths["n_values"] // 32))
    return (True, n, widths["n_keys"] * -(-widths["capacity"] // 32))


def serving_fold_shapes() -> list:
    """Every shape the serving phases fold, and ragged ones: words-major
    W = 1, N not a multiple of 4; node-major one column, odd columns."""
    shapes = {(False, 5, 1), (False, 4097, 3), (False, 65539, 1),
              (True, 4097, 1), (True, 1000, 3), (True, 513, 33)}
    for _, kind, tkw, rates, sim_kw, _ in SERVING_PHASES:
        if kind != "counter":
            shapes.add(and_fold_shape(kind, tkw, max(rates), sim_kw))
    for kind, sim_kw in OVERLAY_SIMS:
        if kind != "counter":
            shapes.add(and_fold_shape(kind, OVERLAY_TRAFFIC,
                                      OVERLAY_TRAFFIC["rate"], sim_kw))
    tree_kw = dict(topology="tree", structured=True)
    shapes.add(and_fold_shape("broadcast", SERVING_TREE, 0.25, tree_kw))
    shapes.add(and_fold_shape("broadcast", SERVING_TREE, 0.25,
                              dict(topology="tree")))
    return sorted(shapes)


# traffic_fold.cu's launch geometry, mirrored so that the check's probes
# sit on its blocks' edges
FOLD_THREADS = 256
FOLD_ROW_BLOCK_WORDS = FOLD_THREADS * 4 * 4   # four 16-byte loads a thread
FOLD_COL_BLOCKS, FOLD_COL_MIN_ROWS, FOLD_MAX_GRID_Y = 132 * 16, 32, 65535
FOLD_PROBE_BITS = 28      # bits a line's probes clear; 4 stay set


def fold_ranges(shape: tuple, offset: int = 0) -> list:
    """Per line of ``shape`` (node_major, N, C) (a word row of the row
    form, a column of the column form), the node ranges [lo, hi) that
    ``and_fold``'s blocks read, the bitset laid ``offset`` words into a
    16-byte aligned allocation: a row's unaligned head and ragged tail
    are ranges of their own."""
    node_major, n, c = shape
    cdiv = lambda a, b: -(-a // b)                              # noqa: E731
    if node_major and c > 1:
        tx = 32
        while tx < 128 and tx < c:
            tx *= 2
        ty = FOLD_THREADS // tx
        rpb = max(cdiv(n, cdiv(FOLD_COL_BLOCKS, cdiv(c, tx))),
                  FOLD_COL_MIN_ROWS, cdiv(n, FOLD_MAX_GRID_Y))
        rpb = cdiv(rpb, ty) * ty
        return [[(lo, min(lo + rpb, n)) for lo in range(0, n, rpb)]] * c
    out = []
    for row in range(c):
        head = min(-(offset + row * n) % 4, n)
        body = (n - head) // 4 * 4
        r = [(0, head)] if head else []
        r += [(head + lo, head + min(lo + FOLD_ROW_BLOCK_WORDS, body))
              for lo in range(0, body, FOLD_ROW_BLOCK_WORDS)]
        out.append(r + ([(head + body, n)] if head + body < n else []))
    return out


def fold_probes(shape: tuple, seed: int, offset: int = 0):
    """(line, node, bit) int64 rows: the nodes at which each line clears
    one bit of its own.  Every line probes its first four and last four
    nodes (the head words of an offset view, the ragged tail, the first
    and last node), then its blocks' first nodes and then their last
    ones, from a block that moves on by the probes' room a line, then
    nodes spread over the axis, staggered from line to line, up to
    :data:`FOLD_PROBE_BITS` nodes.  A node range that the kernel skipped
    in one line then leaves that line a bit the AND would have cleared;
    every block index is probed in some line whenever the lines' room
    holds them all (it does at every shape the checks use:
    tests/test_torch_kernels.py)."""
    import numpy as np

    node_major, n, c = shape
    rng = np.random.default_rng(seed)
    room = FOLD_PROBE_BITS - 8
    rows = []
    for line, ranges in enumerate(fold_ranges(shape, offset)):
        k = len(ranges)
        turn = [ranges[(line * room + i) % k] for i in range(k)]
        spread = [(i * c + line) * n // (room * c) for i in range(room)]
        want = ([0, 1, 2, 3, n - 4, n - 3, n - 2, n - 1]
                + [lo for lo, _ in turn] + [hi - 1 for _, hi in turn]
                + spread)
        nodes = list(dict.fromkeys(x for x in want if 0 <= x < n))
        nodes = nodes[:FOLD_PROBE_BITS]
        bits = rng.permutation(32)[:len(nodes)]
        rows += [(line, x, b) for x, b in zip(nodes, bits)]
    return np.asarray(rows, np.int64).reshape(-1, 3)


def fold_input(shape: tuple, seed: int, device, offset: int = 0):
    """A bitset of ``shape`` (node_major, N, C), (N, C) node-major or
    (C, N) words-major, all ones but for the bits of
    :func:`fold_probes`."""
    import torch

    node_major, n, c = shape
    p = torch.from_numpy(fold_probes(shape, seed, offset)).to(device)
    x = torch.full((c, n), -1, dtype=torch.int32, device=device)
    x[p[:, 0], p[:, 1]] = ~(torch.ones_like(p[:, 2], dtype=torch.int32)
                            << p[:, 2].to(torch.int32))
    return x.t().contiguous() if node_major else x


def check_and_fold(kernels, note, device) -> None:
    """``and_fold`` against ``and_rows`` at every serving shape
    (:func:`serving_fold_shapes`), aligned and on 4-byte-offset views."""
    import torch

    for shape in serving_fold_shapes():
        for offset in (0, 1):
            x = fold_input(shape, sum(shape), device, offset)
            want = kernels.and_rows(x if shape[0] else x.t())
            view = at_offset(x, offset)
            note("and_fold", (kernels.and_fold(view, node_major=shape[0]),
                              want))
            del x, want, view
        torch.cuda.empty_cache()


def time_and_fold(kernels, device, out) -> None:
    """``and_fold`` at the serving phases' main shapes: the 64k
    broadcast's (768, 65536) words-major, the 64k Kafka presence (65536,
    384) node-major, the 2^20-node tree's (256, 2^20) words-major.  Each
    reads the state once and writes C words: bytes-bound at HBM's rate
    (every state is above the L2's 50 MB).  No PyTorch call folds with a
    bitwise AND (library_ms null)."""
    import torch

    mains = [and_fold_shape(kind, tkw, max(rates), sim_kw)
             for _, kind, tkw, rates, sim_kw, _ in SERVING_PHASES
             if kind != "counter"]
    mains.append(and_fold_shape("broadcast", SERVING_TREE, 0.25,
                                dict(structured=True)))
    for shape in mains:
        node_major, n, c = shape
        x = fold_input(shape, n + c, device)
        moved = 4 * n * c + 4 * c
        b = bound(moved, n * c, HBM_BYTES_PER_S if moved > L2_BYTES
                  else L2_BYTES_PER_S)
        out["and_fold"][(c, n)] = _timed(
            "and_fold", lambda: kernels.and_fold(x, node_major),
            lambda: kernels.and_fold_plain(x, node_major), b)
        out["and_fold"][(c, n)]["layout"] = ("node-major" if node_major
                                             else "words-major")
        del x
        torch.cuda.empty_cache()


SERVING_EXPECT = {"broadcast": ("and_fold", "col_popcount"),
                  "counter": ("counter_select", "counter_apply"),
                  "kafka": ("and_fold", "kafka_merge")}


def fold_of(sim, state) -> tuple:
    """(node_major, N, C) and the bitset that ``sim``'s traffic driver
    folds for ``state``."""
    if hasattr(state, "present"):
        n = state.present.shape[0]
        x = state.present.view(n, -1)
        return (True,) + tuple(x.shape), x
    x = state.received
    return ((not sim.words_major,) + tuple(
        x.shape if not sim.words_major else x.shape[::-1]), x)


def serving_row(row: dict) -> dict:
    """The reported keys of one run_serving row."""
    wall_ms = row["total_s"] * 1e3
    return {"rate": row["traffic"]["rate"], "ok": row["ok"],
            "n_lost_writes": row["n_lost_writes"],
            "lat_p50": row["lat_p50"], "lat_p99": row["lat_p99"],
            "lat_max": row["lat_max"], "arrived": row["arrived"],
            "issued": row["issued"], "deferred": row["deferred"],
            "completed": row["completed"], "in_flight": row["in_flight"],
            "conserved": row["conserved"],
            "offered_per_round": row["offered_per_round"],
            "sustained_per_round": row["sustained_per_round"],
            "total_rounds": row["total_rounds"],
            "recovery_rounds": row["recovery_rounds"],
            "wall_ms": wall_ms,
            "wall_ms_per_round": wall_ms / max(1, row["total_rounds"]),
            "completed_ops_per_s": row["ops_per_sec"],
            "msgs_total": row["msgs_total"]}


def device_clone(x):
    """``x`` with every tensor in it cloned where it lies (dataclasses,
    named tuples, tuples and lists)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: device_clone(getattr(x, f.name))
            for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(device_clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(device_clone(v) for v in x)
    return x


def replay(sim, kind: str, serving, telemetry, tspec, rounds: int, tsp,
           fresh=None):
    """``rounds`` rounds of ``tspec`` from a fresh state in one
    ``run_traffic`` call with the ring on: the state a serving run of
    that many rounds ends in (its drive calls are the same rounds).
    ``fresh``: the sim's fresh state, staged once (cloned here)."""
    st = (serving._fresh_state(kind, sim) if fresh is None
          else device_clone(fresh))
    return sim.run_traffic(st, sim.traffic_state(tspec), tspec, rounds,
                           donate=True, tel=telemetry.init_state(
                               tsp, device=sim.device), tel_spec=tsp)


def same_serving(kernels, a, b) -> bool:
    """Two serving ends (state, tracker, ring) agree, on any devices and
    layouts: every tracker leaf, the ring, the round, the ledger and the
    sim's node state (received / pending, cached, kv / the Kafka
    fields)."""
    import torch

    (sa, ta, la), (sb, tb, lb) = a, b

    def eq(x, y):
        return x.shape == y.shape and bool(torch.equal(x.cpu(), y.cpu()))

    ok = (all(eq(x, y) for x, y in zip(ta, tb)) and eq(la.ring, lb.ring)
          and la.wrote == lb.wrote and sa.t == sb.t
          and int(sa.msgs) == int(sb.msgs))
    if not ok:
        return False
    if hasattr(sa, "present"):
        return same_kafka(sa, sb)
    if hasattr(sa, "pending"):
        return all(eq(getattr(sa, f), getattr(sb, f))
                   for f in ("pending", "cached", "kv"))
    def lay(x):                      # words-major against node-major
        return x if x.shape == sa.received.shape else x.t()

    return all(bool(torch.equal(getattr(sa, f),
                                lay(getattr(sb, f)).to(sa.received.device)))
               for f in ("received", "frontier"))


def top_spans(spans: list, rounds: int, k: int = 6) -> list:
    """The ``k`` device span kinds that took the most time in a run:
    [name (its first 90 characters), device us a round, spans a round]."""
    by: dict = {}
    for x in spans:
        name = x["name"][:90]
        us, n = by.get(name, (0.0, 0))
        by[name] = (us + x["us"], n + 1)
    return [[name, us / rounds, n / rounds] for name, (us, n) in
            sorted(by.items(), key=lambda kv: -kv[1][0])[:k]]


def serving_timed(kernels, serving, sim, kind: str, tspec, fresh) -> dict:
    """The driven phase (``until`` rounds from a fresh state, no ring) on
    the card: CUDA-event wall (median of 2 after a warm-up), device busy
    time and spans under the profiler with the span kinds that took the
    most of it (:func:`top_spans`), port launches of one trip
    (:data:`TRIP_LAUNCHES`; ``trip_launches`` by kernel), and whether it
    runs with no host sync.  ``fresh``: the sim's fresh state, staged
    once and cloned on the card for each trip (a 2^20-node, W = 256
    state is 1 GiB a bitset, seconds to stage from the host)."""
    def stage():
        st = device_clone(fresh)
        ts = sim.traffic_state(tspec)
        return lambda: sim.run_traffic(st, ts, tspec, tspec.until,
                                       donate=True)

    rounds = tspec.until
    wall = statistics.median([event_ms(stage())[1] for _ in range(3)][1:])
    found = device_spans(stage)
    busy = spans = top = None
    if found is not None:
        busy, spans = sum(x["us"] for x in found) / 1e3, len(found)
        top = top_spans(found, rounds)
    before = dict(kernels.LAUNCHES)
    port = launches_of(kernels, stage())
    trip = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
            if v > before[k]}
    try:
        no_host_sync(stage())
        sync_free = True
    except RuntimeError as e:
        sync_free = False
        print(f"chip_smoke: {kind} run_traffic syncs with the host: {e}",
              file=sys.stderr, flush=True)
    return {"rounds": rounds, "wall_ms": wall, "ms_per_round": wall / rounds,
            "device_busy_ms": busy,
            "device_idle_share": idle_share(busy, wall),
            "launches_per_round": port / rounds, "trip_launches": trip,
            "device_spans_per_round": None if spans is None
            else spans / rounds, "top_spans": top,
            "no_host_sync": sync_free}


# the threads of a background CPU twin: it shares the host's cores with
# the phases that run meanwhile (the serving twin's; the shorter twins of
# the circulant, Kafka and txn phases take one, to crowd those phases
# less: they finish long before their lines are due)
TWIN_THREADS = 2
SMALL_TWIN_THREADS = 1
TWIN_TIMEOUT_S = 900.0


def host_copy(x):
    """``x`` with every tensor in it copied to the host (dataclasses,
    named tuples, tuples and lists)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: host_copy(getattr(x, f.name))
            for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(host_copy(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(host_copy(v) for v in x)
    return x


def cpu_serving_ends(kind: str, tkw: dict, max_rate: float, sim_kw: dict,
                     rates_rounds: list) -> list:
    """The port's CPU path at a serving phase's spec (its sim built at the
    heaviest rate, as the card's is): each ``(rate, rounds)`` replayed
    with the ring on (:func:`replay`), the ends as they come out."""
    import torch

    from gossip_glomers_tpu_torch.harness import serving
    from gossip_glomers_tpu_torch.tpu_sim import telemetry, traffic

    torch.set_num_threads(TWIN_THREADS)
    spec0 = traffic.TrafficSpec(**tkw)
    csim, _ = serving.make_serving_sim(kind, spec0.with_rate(max_rate),
                                       device="cpu", **dict(sim_kw))
    out = []
    for rate, rounds in rates_rounds:
        tsp = telemetry.TelemetrySpec(kind, rounds=rounds, traffic=True)
        out.append(replay(csim, kind, serving, telemetry,
                          spec0.with_rate(rate), rounds, tsp))
    return out


def _twin_body(fn, args, path: str) -> None:
    try:
        t0 = time.perf_counter()
        res = fn(*args)
        with open(path + ".tmp", "wb") as fh:
            pickle.dump((time.perf_counter() - t0, res), fh, protocol=5)
        os.replace(path + ".tmp", path)
    except BaseException:
        with open(path + ".err", "w") as fh:
            fh.write(traceback.format_exc())
        raise


class BackgroundTwin:
    """``fn(*args)`` in a spawned process of its own (a CPU twin, which
    needs no card), its result pickled to a temporary file: the smoke
    goes on meanwhile.  :meth:`result` joins it (killing it past
    ``timeout`` seconds from its start) and raises with its traceback if
    it failed.  The process is a daemon: it ends with the smoke."""

    def __init__(self, fn, args: tuple, timeout: float = TWIN_TIMEOUT_S):
        import multiprocessing

        self.dir = tempfile.mkdtemp(prefix="gg_twin_")
        self.path = os.path.join(self.dir, "out.pkl")
        self.proc = multiprocessing.get_context("spawn").Process(
            target=_twin_body, args=(fn, args, self.path), daemon=True)
        self.proc.start()
        self.deadline = time.monotonic() + timeout
        self.seconds = None

    def result(self):
        try:
            self.proc.join(max(0.1, self.deadline - time.monotonic()))
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join()
                raise AssertionError("a background CPU twin was still "
                                     "running at its timeout (killed)")
            if os.path.exists(self.path + ".err"):
                with open(self.path + ".err") as fh:
                    raise AssertionError("a background CPU twin failed:\n"
                                         + fh.read()[-3000:])
            if self.proc.exitcode != 0:
                raise AssertionError("a background CPU twin exited "
                                     f"{self.proc.exitcode}")
            with open(self.path, "rb") as fh:
                self.seconds, res = pickle.load(fh)
            return res
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)


# records whose CPU twin still runs in the background: (record, twin,
# hold), ``hold(record, the twin's result)`` filling in the verdict
PENDING: list = []


def finish_pending() -> None:
    """Hold each pending record against its background CPU twin, then
    emit it (the records' phases ran earlier: their lines come last)."""
    for rec, twin, hold in PENDING:
        t0 = time.perf_counter()
        out = twin.result()
        rec.update(twin="cpu, in a background process",
                   twin_wait_s=time.perf_counter() - t0,
                   twin_s=twin.seconds)
        hold(rec, out)
        emit(rec)
        if not rec["ok"]:
            raise AssertionError(f"{rec['phase']}: {rec}")
    PENDING.clear()


def serve_and_check(name: str, kind: str, tkw: dict, rates, sim_kw: dict,
                    twin_rates, modules, device, launches: Launches,
                    card: str, *, nemesis_kw=None, max_recovery_rounds=96,
                    twin=None, background: bool = False) -> dict:
    """One serving phase: ``run_serving`` on the card at each rate (one
    sim, built at the heaviest rate, as ``run_serving_curve`` builds it),
    the driven phase timed and profiled at the first rate (one trip must
    launch the phase's kernels), each of ``twin_rates`` replayed with the
    ring on; then, off the launch counts, ``and_fold`` timed on the final
    state and each replay held against its twin: the port's CPU path at
    the same spec, or ``twin(device)``'s sim on the card.  With
    ``background`` the CPU twin runs in a process of its own
    (:class:`BackgroundTwin`, started once the rows' round counts are
    known) while the smoke goes on: the record comes back with
    ``twin_match`` None and ``rec["_pending"]``, which
    :func:`finish_serving_twins` holds against the replays' host copies."""
    import torch

    serving, telemetry, traffic, kernels, faults = modules
    launches.start()
    spec0 = traffic.TrafficSpec(**tkw)
    nem = None if nemesis_kw is None else faults.NemesisSpec(**nemesis_kw)
    sim, _ = serving.make_serving_sim(
        kind, spec0.with_rate(float(max(rates))), nemesis=nem,
        device=device, **dict(sim_kw))
    rec = {"phase": name, "card": card, "workload": kind,
           "traffic": spec0.to_meta(), "sim_kw": sim_kw,
           "nemesis": None if nem is None else {
               "crash": [[a, b, len(ns)] for a, b, ns in nem.crash],
               "loss_rate": nem.loss_rate, "loss_until": nem.loss_until,
               "seed": nem.seed},
           "max_recovery_rounds": max_recovery_rounds, "rates": []}
    rows = {}
    for r in rates:
        row = serving.run_serving(kind, spec0.with_rate(float(r)),
                                  nemesis=nem, sim=sim, series=nem is not None,
                                  max_recovery_rounds=max_recovery_rounds)
        rows[r] = row
        rep = serving_row(row)
        if "cliff" in row:
            rep["cliff"] = row["cliff"]
        rec["rates"].append(rep)
    pending = None
    if background:
        pending = BackgroundTwin(cpu_serving_ends, (
            kind, tkw, float(max(rates)), sim_kw,
            [(float(r), rows[r]["total_rounds"]) for r in twin_rates]))
    fresh = serving._fresh_state(kind, sim)
    rec["timed"] = serving_timed(kernels, serving, sim, kind,
                                 spec0.with_rate(float(rates[0])), fresh)
    missing = [k for k in SERVING_EXPECT[kind]
               if k not in rec["timed"]["trip_launches"]]
    if missing:
        raise AssertionError(f"{name}: one driven trip never launched "
                             f"{missing}")
    ends = {}
    for r in twin_rates:
        tspec = spec0.with_rate(float(r))
        tsp = telemetry.TelemetrySpec(kind, rounds=rows[r]["total_rounds"],
                                      traffic=True)
        ends[r] = replay(sim, kind, serving, telemetry, tspec,
                         rows[r]["total_rounds"], tsp, fresh)
        got = traffic.latency_summary(ends[r][1])
        if any(got[k] != rows[r][k] for k in got):
            raise AssertionError(f"{name}: the replay of rate {r} ends "
                                 f"elsewhere than its serving run: {got}")
        # what mesh_txn_serving's ranks are held against
        SERVING_ONE[(name, r)] = {
            "fields": serving_fields(rows[r]),
            "series": telemetry.series_arrays(ends[r][2], tsp)}
    launches.stop(rec, SERVING_EXPECT[kind])
    # the fold timed on the final state, and the twins, off the counts
    if kind != "counter":
        shape, x = fold_of(sim, ends[twin_rates[0]][0])
        rec["and_fold_shape"] = list(shape)
        if shape not in serving_fold_shapes():
            raise AssertionError(f"{name}: kernel_check never held and_fold "
                                 f"at {shape}")
        rec["and_fold_device_ms"] = device_ms(
            lambda: kernels.and_fold(x, shape[0]), "and_fold_kernel",
            calls=5)
        del x
    if pending is not None:
        rec["twin"] = "cpu, in a background process"
        rec["twin_rates"] = list(twin_rates)
        rec["twin_match"] = None
        rec["_pending"] = (pending, [host_copy(ends[r]) for r in twin_rates])
        del sim, ends, fresh
        torch.cuda.empty_cache()
        return rec
    if twin is None:
        csim, _ = serving.make_serving_sim(
            kind, spec0.with_rate(float(max(rates))), nemesis=nem,
            device="cpu", **dict(sim_kw))
    else:
        csim = twin(device)
    rec["twin"] = "cpu" if twin is None else "card"
    rec["twin_rates"] = list(twin_rates)
    matches = []
    for r in twin_rates:
        tspec = spec0.with_rate(float(r))
        tsp = telemetry.TelemetrySpec(kind, rounds=rows[r]["total_rounds"],
                                      traffic=True)
        other = replay(csim, kind, serving, telemetry, tspec,
                       rows[r]["total_rounds"], tsp)
        matches.append(same_serving(kernels, ends[r], other))
        del other
    rec["twin_match"] = all(matches)
    if twin is None and nem is not None:
        # the verdict the CPU path's runner reaches at the same spec
        cpu_rows = [serving.run_serving(
            kind, spec0.with_rate(float(r)), nemesis=nem, sim=csim,
            max_recovery_rounds=max_recovery_rounds) for r in twin_rates]
        rec["cpu_verdicts"] = [[cr["ok"], cr["n_lost_writes"]]
                               for cr in cpu_rows]
        rec["verdicts_match"] = all(
            [cr["ok"], cr["n_lost_writes"]]
            == [rows[r]["ok"], rows[r]["n_lost_writes"]]
            for cr, r in zip(cpu_rows, twin_rates))
    del sim, csim, ends, fresh
    torch.cuda.empty_cache()
    return rec


def serving_phases(modules, topology, structured, broadcast, device,
                   launches: Launches, card: str) -> list:
    """benchmarks/serving_curve.py's points on one card and the main path
    under load (module docstring, phases 31-33).  Returns the records
    whose CPU twin still runs in the background
    (:func:`finish_serving_twins` emits them)."""
    pending = []
    for name, kind, tkw, rates, sim_kw, twin_rates in SERVING_PHASES:
        rec = serve_and_check(name, kind, tkw, rates, sim_kw, twin_rates,
                              modules, device, launches, card,
                              background=kind == "broadcast")
        if rec["twin_match"] is None:
            pending.append(rec)
            continue
        rec["ok"] = (rec["twin_match"] and all(
            r["ok"] and r["n_lost_writes"] == 0 for r in rec["rates"]))
        emit(rec)
        if not rec["ok"]:
            raise AssertionError(f"{name}: {rec}")
    overlay = {"phase": "serving_overlay_1k", "card": card, "runs": []}
    for kind, sim_kw in OVERLAY_SIMS:
        rec = serve_and_check(f"overlay_{kind}", kind, OVERLAY_TRAFFIC,
                              (OVERLAY_TRAFFIC["rate"],), sim_kw,
                              (OVERLAY_TRAFFIC["rate"],), modules, device,
                              launches, card, nemesis_kw=OVERLAY_FAULT,
                              max_recovery_rounds=192)
        rec["ok"] = rec["twin_match"] and rec["verdicts_match"]
        overlay["runs"].append(rec)
    rec = serve_and_check("cas_queueing_curve", "counter", CAS_CURVE_TRAFFIC,
                          CAS_CURVE_RATES, dict(mode="cas", poll_every=2),
                          CAS_CURVE_RATES, modules, device, launches, card,
                          max_recovery_rounds=384)
    rec["ok"] = rec["twin_match"] and all(
        r["ok"] and r["n_lost_writes"] == 0 for r in rec["rates"])
    overlay["runs"].append(rec)
    overlay["ok"] = all(r["ok"] for r in overlay["runs"])
    emit(overlay)
    if not overlay["ok"]:
        raise AssertionError(f"serving_overlay_1k: {overlay}")
    # the main path under load, held to the card's gather path
    n = SERVING_TREE_NODES
    nbrs = topology.to_padded_neighbors(topology.tree(n))

    def gather_twin(dev):
        return broadcast.BroadcastSim(
            nbrs, n_values=SERVING_TREE["n_clients"]
            * SERVING_TREE["ops_per_client"], sync_every=4,
            srv_ledger=False, device=dev)

    rec = serve_and_check("serving_tree_1m", "broadcast", SERVING_TREE,
                          (SERVING_TREE["rate"],),
                          dict(topology="tree", structured=True,
                               sync_every=4),
                          (SERVING_TREE["rate"],), modules, device,
                          launches, card, twin=gather_twin)
    rec["ok"] = rec["twin_match"] and all(
        r["ok"] and r["n_lost_writes"] == 0 for r in rec["rates"])
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"serving_tree_1m: {rec}")
    return pending


def finish_serving_twins(kernels, pending: list) -> None:
    """Hold each pending serving record's replays against its CPU twin
    from the background process (:func:`same_serving`), then emit it."""
    for rec in pending:
        twin, ends = rec.pop("_pending")
        t0 = time.perf_counter()
        others = twin.result()
        rec["twin_wait_s"] = time.perf_counter() - t0
        rec["twin_s"] = twin.seconds
        rec["twin_match"] = len(others) == len(ends) and all(
            same_serving(kernels, end, other)
            for end, other in zip(ends, others))
        rec["ok"] = (rec["twin_match"] and all(
            r["ok"] and r["n_lost_writes"] == 0 for r in rec["rates"]))
        emit(rec)
        if not rec["ok"]:
            raise AssertionError(f"{rec['phase']}: {rec}")


# -- txn-rw-register (txn_round.cu) -----------------------------------------

# the txn kernels' checked cases (kernel_check): nodes (a ragged warp, odd
# counts whose wrapped priorities can collide, a power of two whose cannot),
# ops a transaction, keys, and who is active
TXN_NS = (1, 31, 65_537, 131_072)
TXN_OS = (1, 2, 4, 8)
TXN_KS = (1, 5, 4099, 1 << 18)
TXN_ACTIVE = ("all", "none", "random")
TXN_CHECK_SLOTS = 3
# txn_64k: the JAX package's own txn/fused-donated contract
# (gossip_glomers_tpu/tpu_sim/txn.py:535-540: 1,024 nodes, 256 keys, T 8,
# O 2, rate 0.5, until 24) at 65,536 nodes, the same key ratio, its
# arrivals cut to rounds [0, 6) (depth, for the smoke's time limit: the
# host certificate and the CPU twin scale with the transactions offered)
TXN_NODES = 1 << 16
TXN_KEYS = TXN_NODES // 4
TXN_T, TXN_O, TXN_RATE, TXN_UNTIL = 8, 2, 0.5, 6
# the txn_64k round whose kernel inputs are captured, checked and timed
TXN_CAPTURE_ROUND = 4
# the rounds past the arrivals' end (txn_64k) or the clear round
# (txn_nemesis_64k) that the backlog may take to drain, from the runs at
# this size, whose rounds equal the port's CPU path's: txn_64k drains 99
# rounds past round 6, txn_nemesis_64k converges 82 past its clear round
# 16 (PERF.md); the larger with 6% over it
TXN_MAX_RECOVERY = 106
TXN_EXPECT = ("txn_claim", "txn_commit")


def txn_case(n: int, o: int, k: int, mode: str, seed: int, device,
             wrap: bool) -> dict:
    """A txn round's kernel operands from ``seed`` (numpy, then the card):
    keys in [0, k), cur in [0, T] (T: past the last slot, clamped), issue
    -1 (a first attempt) at a quarter of the nodes, else in [0, 64) or,
    with ``wrap``, where ``issue * n`` passes 2^31; with ``wrap`` and an
    odd ``n > 1`` up to 8 node pairs share a wrapped priority near
    -2^31 and their open slot's keys (both can win a key); random rows,
    records and the store's (owner, slot) of every key."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t_dim = TXN_CHECK_SLOTS
    keys = rng.integers(0, k, (n, t_dim, o)).astype(np.int32)
    write = rng.random((n, t_dim, o)) < 0.5
    wval = rng.integers(-(1 << 31), 1 << 31, (n, t_dim, o)).astype(np.int32)
    cur = rng.integers(0, t_dim + 1, n).astype(np.int32)
    lo = min(-(-(1 << 31) // n), (1 << 31) - 2) if wrap and n > 1 else 0
    hi = (1 << 31) - 1 if wrap and n > 1 else 64
    issue = rng.integers(lo, hi, n).astype(np.int32)
    issue[rng.random(n) < 0.25] = -1
    active = {"all": np.ones(n, bool), "none": np.zeros(n, bool),
              "random": rng.random(n) < 0.5}[mode]
    pairs = 0
    if wrap and n % 2 == 1 and n > 1:
        inv = pow(n, -1, 1 << 32)
        for j in range(64):
            if pairs == min(8, n // 2):
                break
            a, b = (int(x) for x in rng.choice(n, 2, replace=False))
            target = (1 << 31) + j           # the int32 priority -2^31 + j
            ia = (target - a) * inv % (1 << 32)
            ib = (target - b) * inv % (1 << 32)
            if ia < 1 << 31 and ib < 1 << 31:
                issue[a], issue[b] = ia, ib
                cur[a] = cur[b] = rng.integers(0, t_dim)
                keys[b, cur[b]] = keys[a, cur[a]]
                if mode != "none":
                    active[a] = active[b] = True
                pairs += 1
    cap = max(1, -(-k // n) + 1)
    dev = device

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return {"keys": put(keys), "write": put(write), "wval": put(wval),
            "cur": put(cur), "issue": put(issue), "active": put(active),
            "owner": put(rng.integers(0, n, k).astype(np.int64)),
            "slot": put(rng.integers(0, cap, k).astype(np.int64)),
            "vals": put(rng.integers(-(1 << 31), 1 << 31, (n, cap))
                        .astype(np.int32)),
            "vers": put(rng.integers(-(1 << 31), 1 << 31, (n, cap))
                        .astype(np.int32)),
            "op_ver": put(rng.integers(-9, 9, (n, t_dim, o))
                          .astype(np.int32)),
            "op_val": put(rng.integers(-9, 9, (n, t_dim, o))
                          .astype(np.int32)),
            "commit_round": put(rng.integers(-1, 9, (n, t_dim))
                                .astype(np.int32)),
            "issue_round": put(rng.integers(-1, 9, (n, t_dim))
                               .astype(np.int32)),
            "t": int(rng.integers(0, 1 << 12)), "n_keys": k,
            "pairs": pairs}


TXN_INPLACE = ("cur", "issue", "op_ver", "op_val", "commit_round",
               "issue_round")
TXN_COMMIT_ARGS = ("keys", "write", "wval", "cur", "issue", "active",
                   "owner", "slot", "vals", "vers", "op_ver", "op_val",
                   "commit_round", "issue_round")


def txn_pairs(kernels, case: dict) -> list:
    """(kernel, plain) output pairs of both txn kernels on ``case``: best,
    attempts, the write requests and every in-place tensor (the kernel's
    on copies)."""
    c = case
    claim_args = (c["keys"], c["cur"], c["issue"], c["active"])
    best, att = kernels.txn_claim(*claim_args, t=c["t"],
                                  n_keys=c["n_keys"])
    best_p, att_p = kernels.txn_claim_plain(*claim_args, t=c["t"],
                                            n_keys=c["n_keys"])
    mine = {k: (v.clone() if k in TXN_INPLACE else v) for k, v in c.items()}
    req = kernels.txn_commit(best, *(mine[k] for k in TXN_COMMIT_ARGS),
                             t=c["t"])
    want = kernels.txn_commit_plain(best_p, *(c[k] for k in
                                              TXN_COMMIT_ARGS), t=c["t"])
    return ([("txn_claim", best, best_p), ("txn_claim", att, att_p),
             ("txn_commit", req, want[0])]
            + [("txn_commit", mine[k], w)
               for k, w in zip(TXN_INPLACE, want[1:])])


def check_txn(kernels, note, device) -> None:
    """``txn_claim`` and ``txn_commit`` against their plain versions at
    every (:data:`TXN_NS`, :data:`TXN_OS`) with the key counts
    :data:`TXN_KS` in turn, every :data:`TXN_ACTIVE` mode, issue stamps
    small and near the wrap (with colliding priority pairs at the odd
    node counts); the commit on copies of its in-place operands."""
    import torch

    i = 0
    planted = 0
    for n in TXN_NS:
        for o in TXN_OS:
            for wrap in (False, True):
                for k in (TXN_KS[i % 4], TXN_KS[(i + 2) % 4]):
                    case = txn_case(n, o, k, TXN_ACTIVE[i % 3], i, device,
                                    wrap)
                    planted += case["pairs"]
                    for name, a, b in txn_pairs(kernels, case):
                        note(name, (a, b))
                    i += 1
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    if planted == 0:
        raise AssertionError("check_txn planted no colliding priorities")


def txn_work(case: dict, t_dim: int) -> dict:
    """What the captured round's two kernels need on these inputs: the
    active nodes, winners, first attempts and winners' write ops; the
    bytes each must move (each input read once, each output written
    once) and the random 32-byte sectors it touches."""
    import torch

    n, _, o = case["keys"].shape
    k = case["n_keys"]
    act = case["active"]
    n_act = int(act.sum())
    out = txn_pairs_plain(case)
    cur_new = out[1]
    win = (cur_new - case["cur"]) > 0
    n_win = int(win.sum())
    first = act & (case["issue"] < 0)
    n_first = int(first.sum())
    wr = torch.gather(case["write"], 1, case["cur"].clamp(0, t_dim - 1)
                      .long()[:, None, None].expand(n, 1, o))[:, 0]
    n_wops = int((wr & win[:, None]).sum())
    claim_bytes = 9 * n + 4 * o * n_act + 4 * k + 4
    commit_bytes = (17 * n + 8 * o * n_act + 29 * o * n_win
                    + 8 * o * n_win + 4 * n_win + 4 * n_first + 12 * k)
    return {"active": n_act, "winners": n_win, "first": n_first,
            "write_ops": n_wops, "claim_bytes": claim_bytes,
            "claim_sectors": o * n_act, "commit_bytes": commit_bytes,
            "commit_sectors": o * n_act + 4 * o * n_win + 3 * n_wops}


def txn_pairs_plain(case: dict):
    """The plain commit on ``case`` after the plain claim."""
    from gossip_glomers_tpu_torch.tpu_sim import kernels

    c = case
    best, _ = kernels.txn_claim_plain(c["keys"], c["cur"], c["issue"],
                                      c["active"], t=c["t"],
                                      n_keys=c["n_keys"])
    return kernels.txn_commit_plain(best, *(c[k] for k in TXN_COMMIT_ARGS),
                                    t=c["t"])


def txn_bound(moved: int, sectors: int) -> tuple[float, str, float]:
    """(bound ms, "bytes", sector ms): the larger of the bytes at HBM's
    rate and the random sectors at the L2's rate."""
    by, _ = bound(moved, 0)
    sector_ms = sectors * 32 / L2_BYTES_PER_S * 1e3
    return max(by, sector_ms), "bytes", sector_ms


def time_txn(kernels, case: dict, t_dim: int) -> dict:
    """Both txn kernels on one captured round: device time (the profiler's
    spans of the kernel alone), CUDA-event time (the commit's less that of
    the copies restoring its in-place operands before each call), the
    plain versions' times, the bounds of :func:`txn_work` and, for the
    claim, ``Tensor.scatter_reduce_(0, idx, src, "amin")`` over the same
    claims (the library call that computes the per-key minimum)."""
    import torch

    c = case
    work = txn_work(c, t_dim)
    claim_args = (c["keys"], c["cur"], c["issue"], c["active"])
    best, _ = kernels.txn_claim(*claim_args, t=c["t"], n_keys=c["n_keys"])
    n, _, o = c["keys"].shape
    _, prio = kernels._txn_issue_prio(c["issue"], c["active"], c["t"])
    k_n = kernels._txn_open(c["keys"], c["cur"]).reshape(-1).long()
    src = torch.where(c["active"][:, None], prio[:, None].expand(n, o),
                      kernels.TXN_INF).reshape(-1).contiguous()
    lib_best = torch.empty_like(best)

    def library():
        lib_best.fill_(kernels.TXN_INF)
        lib_best.scatter_reduce_(0, k_n, src, "amin")

    library()
    if not torch.equal(lib_best, best):
        raise AssertionError("scatter_reduce_ amin disagrees with txn_claim")
    saved = {k: c[k].clone() for k in TXN_INPLACE}
    live = {k: c[k].clone() for k in TXN_INPLACE}

    def restore():
        for k in TXN_INPLACE:
            live[k].copy_(saved[k])

    def commit():
        restore()
        kernels.txn_commit(best, *(live.get(k, c[k])
                                   for k in TXN_COMMIT_ARGS), t=c["t"])

    def commit_plain():
        kernels.txn_commit_plain(best, *(c[k] for k in TXN_COMMIT_ARGS),
                                 t=c["t"])

    out = {}
    for name, kern, plain, moved, sectors, ms_less in (
            ("txn_claim",
             lambda: kernels.txn_claim(*claim_args, t=c["t"],
                                       n_keys=c["n_keys"]),
             lambda: kernels.txn_claim_plain(*claim_args, t=c["t"],
                                             n_keys=c["n_keys"]),
             work["claim_bytes"], work["claim_sectors"], None),
            ("txn_commit", commit, commit_plain, work["commit_bytes"],
             work["commit_sectors"], restore)):
        b_ms, b_by, sector_ms = txn_bound(moved, sectors)
        dev = device_ms(kern, KERNELS[name][2], calls=10)
        ms = cuda_ms(kern) - (cuda_ms(ms_less) if ms_less else 0.0)
        out[name] = {"ms": ms, "device_ms": dev,
                     "plain_ms": cuda_ms(plain, inner=3),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "sector_ms": sector_ms,
                     "bound_share": None if dev is None else b_ms / dev,
                     "library_ms": (cuda_ms(library) if name == "txn_claim"
                                    else None), **work}
    return out


# the block forms' checked cases (a mesh rank's rows): nodes (odd counts
# whose wrapped priorities collide, split into uneven blocks; a power of
# two), ops a transaction, keys
TXN_BLOCK_CASES = ((31, 2, 5), (4097, 2, 1024), (65_537, 4, 4099),
                   (131_072, 1, 1 << 14))


def txn_block_bounds(n: int, shards: int) -> list:
    """The first row of each of ``shards`` blocks of ``n`` rows, and n."""
    return [round(i * n / shards) for i in range(shards + 1)]


def txn_view(case: dict):
    """The (2, K) (value, version) view of every key, as the mesh's one
    all-reduce of the owners' rows makes it."""
    import torch

    at = (case["owner"], case["slot"])
    return torch.stack([case["vals"][at], case["vers"][at]]).contiguous()


def check_txn_blocks(kernels, note, device) -> None:
    """The txn kernels' block forms (a mesh rank's rows: ``row0``,
    ``n_total``, the commit's ``view``) against their plain versions on
    each block, and the blocks combined as the mesh combines them (the
    minimum of the ``best`` partials, the sum of the attempts and of the
    write requests, each block's records in row order) against the whole
    problem's plain result, at 2 and 4 blocks of each of
    :data:`TXN_BLOCK_CASES`, wrapped priorities and colliding pairs
    planted."""
    import torch

    planted = 0
    for i, (n, o, k) in enumerate(TXN_BLOCK_CASES):
        c = txn_case(n, o, k, "all" if i % 2 else "random", 300 + i, device,
                     True)
        planted += c["pairs"]
        t = c["t"]
        whole = txn_pairs_plain(c)
        best_w, att_w = kernels.txn_claim_plain(
            c["keys"], c["cur"], c["issue"], c["active"], t=t, n_keys=k)
        view = txn_view(c)
        for shards in (2, 4):
            b = txn_block_bounds(n, shards)
            blocks = [slice(b[p], b[p + 1]) for p in range(shards)]
            bests, atts = [], []
            for p, sl in enumerate(blocks):
                args = (c["keys"][sl], c["cur"][sl], c["issue"][sl],
                        c["active"][sl])
                kw = dict(t=t, n_keys=k, row0=b[p], n_total=n)
                kb, ka = kernels.txn_claim(*args, **kw)
                pb, pa = kernels.txn_claim_plain(*args, **kw)
                note("txn_claim", (kb, pb), (ka, pa))
                bests.append(kb)
                atts.append(ka)
            best = torch.stack(bests).min(0).values
            note("txn_claim", (best, best_w), (sum(atts), att_w))
            reqs, recs = [], {f: [] for f in TXN_INPLACE}
            for p, sl in enumerate(blocks):
                mine = {f: c[f][sl].clone() for f in TXN_INPLACE}
                kw = dict(t=t, view=view, row0=b[p], n_total=n)
                req = kernels.txn_commit(
                    best, c["keys"][sl], c["write"][sl], c["wval"][sl],
                    mine["cur"], mine["issue"], c["active"][sl], None, None,
                    None, None, mine["op_ver"], mine["op_val"],
                    mine["commit_round"], mine["issue_round"], **kw)
                want = kernels.txn_commit_plain(
                    best, c["keys"][sl], c["write"][sl], c["wval"][sl],
                    c["cur"][sl], c["issue"][sl], c["active"][sl], None,
                    None, None, None, c["op_ver"][sl], c["op_val"][sl],
                    c["commit_round"][sl], c["issue_round"][sl], **kw)
                note("txn_commit", (req, want[0]),
                     *((mine[f], w) for f, w in zip(TXN_INPLACE, want[1:])))
                reqs.append(req)
                for f in TXN_INPLACE:
                    recs[f].append(mine[f])
            note("txn_commit", (sum(reqs), whole[0]),
                 *((torch.cat(recs[f]), w)
                   for f, w in zip(TXN_INPLACE, whole[1:])))
        del c, whole, view
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    if planted == 0:
        raise AssertionError("check_txn_blocks planted no colliding "
                             "priorities")


def time_txn_blocks(kernels, case: dict, t_dim: int, times: dict) -> None:
    """The block forms on rank 3's rows of a captured whole round (4
    ranks, mesh_txn_serving's shapes), keyed (O, rows) under
    ``times["<kernel>_block"]``: the claim with ``row0`` / ``n_total``
    (beside ``scatter_reduce_(amin)`` over the block's claims), the
    commit with the view, on the whole round's minimum; bounds counted
    from this block's data as :func:`txn_work` counts the whole forms'
    (the view's value and version a read op in place of the owner, slot,
    value and version)."""
    import torch

    n, _, o = case["keys"].shape
    k = case["n_keys"]
    b = n // MESH_RANKS
    lo = (MESH_RANKS - 1) * b
    sl = slice(lo, lo + b)
    blk = {f: (v[sl] if isinstance(v, torch.Tensor) and v.shape[:1] == (n,)
               and f not in ("owner", "slot") else v)
           for f, v in case.items()}
    t = case["t"]
    best, _ = kernels.txn_claim(case["keys"], case["cur"], case["issue"],
                                case["active"], t=t, n_keys=k)
    view = txn_view(case)
    claim_args = (blk["keys"], blk["cur"], blk["issue"], blk["active"])
    ckw = dict(t=t, n_keys=k, row0=lo, n_total=n)
    _, prio = kernels._txn_issue_prio(blk["issue"], blk["active"], t, lo, n)
    k_n = kernels._txn_open(blk["keys"], blk["cur"]).reshape(-1).long()
    src = torch.where(blk["active"][:, None], prio[:, None].expand(b, o),
                      kernels.TXN_INF).reshape(-1).contiguous()
    lib_best = torch.empty_like(best)

    def library():
        lib_best.fill_(kernels.TXN_INF)
        lib_best.scatter_reduce_(0, k_n, src, "amin")

    library()
    if not torch.equal(lib_best, kernels.txn_claim(*claim_args, **ckw)[0]):
        raise AssertionError("scatter_reduce_ amin disagrees with the "
                             "txn_claim block")
    mkw = dict(t=t, view=view, row0=lo, n_total=n)
    plain_out = kernels.txn_commit_plain(
        best, blk["keys"], blk["write"], blk["wval"], blk["cur"],
        blk["issue"], blk["active"], None, None, None, None, blk["op_ver"],
        blk["op_val"], blk["commit_round"], blk["issue_round"], **mkw)
    act = blk["active"]
    n_act = int(act.sum())
    win = (plain_out[1] - blk["cur"]) > 0
    n_win = int(win.sum())
    n_first = int((act & (blk["issue"] < 0)).sum())
    wr = torch.gather(blk["write"], 1, blk["cur"].clamp(0, t_dim - 1)
                      .long()[:, None, None].expand(b, 1, o))[:, 0]
    n_wops = int((wr & win[:, None]).sum())
    saved = {f: blk[f].clone() for f in TXN_INPLACE}
    live = {f: blk[f].clone() for f in TXN_INPLACE}

    def restore():
        for f in TXN_INPLACE:
            live[f].copy_(saved[f])

    def commit():
        restore()
        kernels.txn_commit(
            best, blk["keys"], blk["write"], blk["wval"], live["cur"],
            live["issue"], act, None, None, None, None, live["op_ver"],
            live["op_val"], live["commit_round"], live["issue_round"], **mkw)

    def commit_plain():
        kernels.txn_commit_plain(
            best, blk["keys"], blk["write"], blk["wval"], blk["cur"],
            blk["issue"], act, None, None, None, None, blk["op_ver"],
            blk["op_val"], blk["commit_round"], blk["issue_round"], **mkw)

    work = {"rows": b, "row0": lo, "active": n_act, "winners": n_win,
            "first": n_first, "write_ops": n_wops}
    for name, kern, plain, moved, sectors, ms_less, lib in (
            ("txn_claim", lambda: kernels.txn_claim(*claim_args, **ckw),
             lambda: kernels.txn_claim_plain(*claim_args, **ckw),
             9 * b + 4 * o * n_act + 4 * k + 4, o * n_act, None, library),
            ("txn_commit", commit, commit_plain,
             17 * b + 8 * o * n_act + 13 * o * n_win + 8 * o * n_win
             + 4 * n_win + 4 * n_first + 12 * k,
             o * n_act + 2 * o * n_win + 3 * n_wops, restore, None)):
        b_ms, b_by, sector_ms = txn_bound(moved, sectors)
        dev = device_ms(kern, KERNELS[name][2], calls=10)
        ms = cuda_ms(kern) - (cuda_ms(ms_less) if ms_less else 0.0)
        times.setdefault(f"{name}_block", {})[(o, b)] = {
            "ms": ms, "device_ms": dev, "plain_ms": cuda_ms(plain, inner=3),
            "bound_ms": b_ms, "bound_by": b_by, "sector_ms": sector_ms,
            "bound_share": None if dev is None else b_ms / dev,
            "library_ms": None if lib is None else cuda_ms(lib),
            "mode": ("claim, row0 of rank 3 of 4" if name == "txn_claim"
                     else "commit over the view, row0 of rank 3 of 4"),
            "bytes": moved, "sectors": sectors, **work}


def same_txn(a, b) -> bool:
    """Two txn states agree: t, msgs, the node counters, the records and
    the KV rows."""
    import torch

    def eq(x, y):
        return bool(torch.equal(x.cpu(), y.cpu()))

    return (a.t == b.t and int(a.msgs) == int(b.msgs)
            and all(eq(getattr(a, f), getattr(b, f))
                    for f in ("arrived", "cur", "issue", "issue_round",
                              "commit_round", "op_ver", "op_val"))
            and eq(a.rows.vals, b.rows.vals)
            and eq(a.rows.vers, b.rows.vers))


class _PlainTxn:
    """The txn round with the kernels' plain versions in their place (the
    plain round, timed beside the kernels' own)."""

    def __init__(self, kernels):
        self.kernels = kernels

    def claim(self, *args, **kw):
        return self.kernels.txn_claim_plain(*args, **kw)

    def commit(self, best, *xs, t, **blk):
        out = self.kernels.txn_commit_plain(best, *xs, t=t, **blk)
        for dst, src in zip((xs[3], xs[4], xs[10], xs[11], xs[12], xs[13]),
                            out[1:]):
            dst.copy_(src)
        return out[0]

    def __enter__(self):
        self.real = (self.kernels.txn_claim, self.kernels.txn_commit)
        self.kernels.txn_claim, self.kernels.txn_commit = (self.claim,
                                                           self.commit)
        return self

    def __exit__(self, *exc):
        self.kernels.txn_claim, self.kernels.txn_commit = self.real


def txn_capture(kernels, rnd: int):
    """A wrapper of ``kernels.txn_claim`` that keeps clones of round
    ``rnd``'s claim and commit operands (from the sim's ``_round``)."""
    kept = {}
    real_claim, real_commit = kernels.txn_claim, kernels.txn_commit

    def claim(keys, cur, issue, active, *, t, n_keys, **blk):
        if t == rnd:
            kept.update(keys=keys, cur=cur.clone(), issue=issue.clone(),
                        active=active.clone(), t=t, n_keys=n_keys)
        return real_claim(keys, cur, issue, active, t=t, n_keys=n_keys,
                          **blk)

    def commit(best, *xs, t, **blk):
        if t == rnd:
            for k, x in zip(TXN_COMMIT_ARGS, xs):
                kept.setdefault(k, x.clone())
        return real_commit(best, *xs, t=t, **blk)

    return claim, commit, kept


def txn_64k(txn, checkers, kernels, device, launches: Launches, card: str,
            times: dict) -> None:
    """The JAX package's txn/fused-donated contract (txn.py:535-540) at
    65,536 nodes and 16,384 keys, T 8, O 2, rate 0.5, until 6,
    ``workload_seed=0``: stepped to convergence (every offered transaction
    committed, at or past ``until``), equal to the port's CPU path after
    every round; the history certified by ``check_txn_serializable``; the
    rounds as a fixed trip (``run_fused`` on fresh states) timed with CUDA
    events, profiled, and with the kernels' plain versions in their
    place; no host sync; both kernels checked and timed on the captured
    inputs of round :data:`TXN_CAPTURE_ROUND`."""
    import torch

    kw = dict(txns_per_node=TXN_T, ops_per_txn=TXN_O, rate=TXN_RATE,
              until=TXN_UNTIL, workload_seed=0)
    t0 = time.perf_counter()
    sim = txn.TxnSim(TXN_NODES, TXN_KEYS, device=device, **kw)
    stage_s = time.perf_counter() - t0
    cpu = txn.TxnSim(TXN_NODES, TXN_KEYS, device="cpu", **kw)
    rec = {"phase": "txn_64k", "card": card, "n": TXN_NODES,
           "keys": TXN_KEYS, "txns_per_node": TXN_T, "ops_per_txn": TXN_O,
           "rate": TXN_RATE, "until": TXN_UNTIL, "stage_s": stage_s}
    launches.start()
    g, c = sim.init_state(), cpu.init_state()
    same = True
    while not (g.t >= TXN_UNTIL and bool((g.cur >= g.arrived).all())) \
            and g.t < TXN_UNTIL + TXN_MAX_RECOVERY:
        g, c = sim.run_fused(g, 1), cpu.run_fused(c, 1)
        same = same and same_txn(g, c)
    rounds = g.t
    launches.stop(rec, TXN_EXPECT)
    # the state mesh_txn_serving's ranks are held against
    b = TXN_NODES // MESH_RANKS
    TXN_ONE.update(rounds=rounds, whole=txn_digests(g, 0),
                   blocks=[txn_digests(g, r * b, b)
                           for r in range(MESH_RANKS)])
    hist = txn.history_of(g, sim.ops)
    ok_ser, det = checkers.check_txn_serializable(
        hist, final=txn.final_registers(g, sim.layout))
    committed = det["n_committed"]

    def stage():
        st = sim.init_state()
        return lambda: sim.run_fused(st, rounds)

    wall = statistics.median([event_ms(stage())[1] for _ in range(4)][1:])
    busy, spans = busy_and_spans(stage)
    port = launches_of(kernels, stage())
    with _PlainTxn(kernels):
        plain = statistics.median([event_ms(stage())[1]
                                   for _ in range(3)][1:])
    fresh = sim.init_state()
    no_sync = True
    try:
        no_host_sync(lambda: sim.run_fused(fresh, rounds))
    except RuntimeError as e:
        no_sync = False
        rec["host_sync"] = str(e)[:200]
    claim, commit, kept = txn_capture(kernels, TXN_CAPTURE_ROUND)
    real = kernels.txn_claim, kernels.txn_commit
    kernels.txn_claim, kernels.txn_commit = claim, commit
    try:
        sim.run_fused(sim.init_state(), TXN_CAPTURE_ROUND + 1)
    finally:
        kernels.txn_claim, kernels.txn_commit = real
    err = max(max_abs_err(a, b) for _, a, b in txn_pairs(kernels, kept))
    timed = time_txn(kernels, kept, TXN_T)
    time_txn_blocks(kernels, kept, TXN_T, times)
    for name in TXN_EXPECT:
        timed[name]["max_abs_err"] = err
        times[name][(TXN_O, TXN_NODES)] = timed[name]
    rec.update(
        rounds=rounds, committed=committed, offered=int(g.arrived.sum()),
        msgs=int(g.msgs), serializable=ok_ser, by_kind=det["by_kind"],
        same_as_cpu=same, wall_ms=wall, ms_per_round=wall / rounds,
        committed_per_s=committed / (wall / 1e3),
        device_busy_ms=busy, device_idle_share=idle_share(busy, wall),
        launches_per_round=port / rounds,
        device_spans_per_round=None if spans is None else spans / rounds,
        plain_round_ms=plain / rounds, no_host_sync=no_sync,
        kernel=timed, kernel_err=err)
    rec["ok"] = bool(same and ok_ser and no_sync and err == 0
                     and committed == rec["offered"] > 0)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"txn_64k: {rec}")
    del sim, cpu, g, c, kept
    torch.cuda.empty_cache()


def txn_nemesis_spec(faults, kvstore, n: int, amnesia: bool):
    """:func:`counter_nemesis_spec` at ``n`` nodes (txn refuses dup); with
    ``amnesia`` the owner of key 0 also crashes over rounds [3, 6) (the
    reference's kv_amnesia test plan, tests/test_txn.py:120-152)."""
    import numpy as np

    spec = counter_nemesis_spec(faults, n)
    if not amnesia:
        return spec
    own = int(kvstore.host_owner_of(np.zeros(1, np.int32), n, 0)[0])
    meta = spec.to_meta()
    meta["crash"] = meta["crash"] + [[3, 6, [own]]]
    return faults.NemesisSpec.from_meta(meta)


def txn_campaign_twin(txn, htxn, spec, kv_amnesia: bool) -> tuple:
    """``run_txn_nemesis``'s rounds on the port's CPU path (the faulted
    phase to the clear round, then a round at a time to convergence): the
    converged round, the ledger, the final registers and the
    per-transaction stamps (the result's record of the whole state but
    the per-op records, which the verdict certifies)."""
    sim = txn.TxnSim(spec.n_nodes, TXN_KEYS, txns_per_node=TXN_T,
                     ops_per_txn=TXN_O, rate=TXN_RATE, until=TXN_UNTIL,
                     fault_plan=spec.compile(device="cpu"),
                     kv_amnesia=kv_amnesia, device="cpu")
    clear = max(spec.clear_round, TXN_UNTIL)
    st = sim.run_fused(sim.init_state(), clear)
    conv = clear if bool((st.cur >= st.arrived).all()) else None
    while conv is None and st.t < clear + TXN_MAX_RECOVERY:
        st = sim.run_fused(st, 1)
        if bool((st.cur >= st.arrived).all()):
            conv = st.t
    final = {str(k): list(v)
             for k, v in txn.final_registers(st, sim.layout).items()}
    return conv, int(st.msgs), final, htxn.txn_provenance_arrays(st)


def cpu_txn_campaigns() -> list:
    """txn_nemesis_64k's CPU twins (a background process): the plain and
    the ``kv_amnesia`` campaign's :func:`txn_campaign_twin`."""
    import torch

    from gossip_glomers_tpu_torch.harness import txn as htxn
    from gossip_glomers_tpu_torch.tpu_sim import faults, kvstore, txn

    torch.set_num_threads(SMALL_TWIN_THREADS)
    return [txn_campaign_twin(txn, htxn, txn_nemesis_spec(
        faults, kvstore, TXN_NODES, amnesia), amnesia)
        for amnesia in (False, True)]


def same_txn_campaign(twin: tuple, result: dict) -> bool:
    """A CPU twin's campaign (:func:`txn_campaign_twin`) equals the card's
    ``run_txn_nemesis`` result."""
    conv, msgs, final, prov = twin
    return (conv == result["converged_round"]
            and msgs == result["msgs_total"]
            and final == result["final_registers"]
            and prov == result["provenance"]["arrays"])


def txn_nemesis_64k(txn, htxn, observe, faults, kvstore, kernels, device,
                    launches: Launches, card: str) -> None:
    """``run_txn_nemesis`` at 65,536 nodes, 16,384 keys, T 8, O 2 (rate
    0.5, until 6) under :func:`txn_nemesis_spec`, three ways: the plain
    campaign (``ok``, serializable, no lost write); ``kv_amnesia`` with
    the owner of key 0 crashed (must fail, naming lost updates with their
    transaction ids, and write its flight bundle into a temporary
    directory); and that bundle replayed on the card (the same
    ``by_kind``, ``first_divergence_round`` None).  The first two each
    equal their rounds on the port's CPU path (:func:`cpu_txn_campaigns`,
    in a background process; the line comes at the end)."""
    import tempfile

    twin = BackgroundTwin(cpu_txn_campaigns, ())
    kw = dict(n_keys=TXN_KEYS, txns_per_node=TXN_T, ops_per_txn=TXN_O,
              rate=TXN_RATE, until=TXN_UNTIL,
              max_recovery_rounds=TXN_MAX_RECOVERY)
    spec = txn_nemesis_spec(faults, kvstore, TXN_NODES, False)
    bad_spec = txn_nemesis_spec(faults, kvstore, TXN_NODES, True)
    rec = {"phase": "txn_nemesis_64k", "card": card, "n": TXN_NODES,
           "keys": TXN_KEYS, "max_recovery_rounds": TXN_MAX_RECOVERY,
           "spec": {"crash": [[s, e, len(ns)] for s, e, ns in spec.crash],
                    "loss_rate": spec.loss_rate,
                    "loss_until": spec.loss_until, "seed": spec.seed}}
    with tempfile.TemporaryDirectory() as out:
        launches.start()
        good, wall = event_ms(lambda: htxn.run_txn_nemesis(
            spec, device=device, **kw))
        bad, wall_bad = event_ms(lambda: htxn.run_txn_nemesis(
            bad_spec, kv_amnesia=True, observe_dir=out, device=device,
            **kw))
        launches.stop(rec, TXN_EXPECT)
        replay, wall_replay = event_ms(lambda: observe.replay_bundle(
            bad["flight_bundle"], device=device))
        lost = [p for p in bad["serializability"]["problems"]
                if p["kind"] in ("lost-update", "lost-acked-commit")]
        rec.update(
            clear_round=good["clear_round"],
            converged_round=good["converged_round"],
            recovery_rounds=good["recovery_rounds"],
            n_committed=good["n_committed"], msgs_total=good["msgs_total"],
            n_lost_writes=good["n_lost_writes"], wall_ms=wall,
            amnesia_ok=bad["ok"], amnesia_by_kind=bad["serializability"][
                "by_kind"], amnesia_lost_named=lost[:2],
            bundle_bytes=os.path.getsize(bad["flight_bundle"]),
            wall_ms_amnesia=wall_bad, wall_ms_replay=wall_replay,
            replay_by_kind=replay["serializability"]["by_kind"],
            replay_first_divergence_round=replay["first_divergence_round"])
    card_ok = bool(
        good["ok"] and good["serializable"] and good["n_lost_writes"] == 0
        and not bad["ok"] and lost and all(p["txns"] for p in lost)
        and rec["replay_by_kind"] == rec["amnesia_by_kind"]
        and not replay["ok"] and replay["first_divergence_round"] is None)
    if not card_ok:
        raise AssertionError(f"txn_nemesis_64k: {rec}")
    results = [{k: r[k] for k in ("converged_round", "msgs_total",
                                  "final_registers", "provenance")}
               for r in (good, bad)]

    def hold(rec, cpu):
        rec["same_as_cpu"] = all(same_txn_campaign(c, r)
                                 for c, r in zip(cpu, results))
        rec["ok"] = rec["same_as_cpu"]

    PENDING.append((rec, twin, hold))


# flight_bundles: small failing campaigns, one a runner (a recovery budget
# too small to converge), each with a recorded series or stamps
BUNDLE_NODES = 64


def bundle_cases(faults, traffic):
    """(name, runner kind, NemesisSpec, kwargs) of the flight_bundles
    phase."""
    spec = faults.NemesisSpec(n_nodes=BUNDLE_NODES, seed=5,
                              crash=((2, 6, (1, 9, 33)),), loss_rate=0.15,
                              loss_until=8)
    tspec = traffic.TrafficSpec(n_nodes=BUNDLE_NODES, n_clients=BUNDLE_NODES,
                                ops_per_client=6, until=10, rate=0.3, seed=9)
    return (
        ("broadcast_gather_provenance", "broadcast", spec,
         dict(topology="grid", telemetry=True, provenance=True,
              max_recovery_rounds=0)),
        ("broadcast_structured", "broadcast", spec,
         dict(topology="tree", structured=True, telemetry=True,
              max_recovery_rounds=0)),
        ("counter", "counter", spec,
         dict(telemetry=True, provenance=True, max_recovery_rounds=0)),
        ("kafka", "kafka", spec,
         dict(telemetry=True, provenance=True, max_recovery_rounds=0)),
        ("serving_counter", "serving", spec,
         dict(tspec=tspec, sim_kw={"mode": "allreduce"}, telemetry=True,
              max_recovery_rounds=0)),
    )


def same_replay(a: dict, b: dict) -> bool:
    """Two replays agree on the verdict and the recorded stamps and
    series."""
    def rec(r):
        out = {k: r.get(k) for k in ("ok", "converged_round",
                                     "n_lost_writes", "msgs_total",
                                     "first_divergence_round")}
        out["series"] = (r.get("telemetry") or {}).get("series")
        out["stamps"] = (r.get("provenance") or {}).get("arrays")
        return json.loads(json.dumps(out, default=lambda o: o.tolist()))

    return rec(a) == rec(b)


def flight_bundles(nemesis, serving, observe, faults, traffic, device,
                   launches: Launches, card: str) -> None:
    """Each runner of the port (``run_broadcast_nemesis`` on the gather
    path with provenance and on the structured path, ``run_counter_
    nemesis``, ``run_kafka_nemesis``, ``run_serving``) fails a small
    campaign on the card and writes its flight bundle; each bundle
    replays on the card with ``first_divergence_round`` None and on the
    CPU to the same verdict, series and stamps; ``run_timeline`` and
    ``run_manifest`` of each result pass their validators; with
    ``GG_PROFILE_DIR`` set, one serving run leaves a ``torch.profiler``
    trace there."""
    import tempfile

    runners = {"broadcast": nemesis.run_broadcast_nemesis,
               "counter": nemesis.run_counter_nemesis,
               "kafka": nemesis.run_kafka_nemesis}
    rec = {"phase": "flight_bundles", "card": card, "n": BUNDLE_NODES,
           "cases": {}}
    ok = True
    with tempfile.TemporaryDirectory() as out:
        launches.start()
        results = {}
        for name, kind, spec, kw in bundle_cases(faults, traffic):
            kw = dict(kw)
            if kind == "serving":
                tspec = kw.pop("tspec")
                res = serving.run_serving("counter", tspec, nemesis=spec,
                                          observe_dir=out, device=device,
                                          **kw)
            else:
                res = runners[kind](spec, observe_dir=out, device=device,
                                    **kw)
            results[name] = res
        launches.stop(rec, ("counter_select", "counter_apply",
                            "kafka_merge", "prov_attribute"))
        for name, res in results.items():
            path = res.get("flight_bundle")
            case = {"ok": res["ok"], "bundle": path is not None}
            if path is not None:
                on_card = observe.replay_bundle(path, device=device)
                on_cpu = observe.replay_bundle(path, device="cpu")
                case.update(
                    replay_ok=on_card["ok"],
                    first_divergence_round=on_card.get(
                        "first_divergence_round", "missing"),
                    cpu_first_divergence_round=on_cpu.get(
                        "first_divergence_round", "missing"),
                    same_on_cpu=same_replay(on_card, on_cpu))
            tl = observe.run_timeline(res)
            observe.validate_timeline(tl)
            man = observe.run_manifest(res)
            observe.validate_manifest(man)
            case.update(timeline_events=len(tl["traceEvents"]),
                        flows=sum(1 for e in tl["traceEvents"]
                                  if e["ph"] == "s"),
                        manifest_env=man["env"])
            case["pass"] = bool(
                not res["ok"] and path is not None
                and not case["replay_ok"]
                and case["first_divergence_round"] is None
                and case["cpu_first_divergence_round"] is None
                and case["same_on_cpu"])
            ok = ok and case["pass"]
            rec["cases"][name] = case
        prof_dir = os.path.join(out, "profile")
        os.environ["GG_PROFILE_DIR"] = prof_dir
        try:
            spec = bundle_cases(faults, traffic)[-1][2]
            tspec = bundle_cases(faults, traffic)[-1][3]["tspec"]
            serving.run_serving("counter", tspec, nemesis=spec,
                                sim_kw={"mode": "allreduce"},
                                device=device)
        finally:
            del os.environ["GG_PROFILE_DIR"]
        traces = (sorted(os.listdir(prof_dir)) if os.path.isdir(prof_dir)
                  else [])
        rec["profile_traces"] = traces
        rec["profile_bytes"] = sum(os.path.getsize(os.path.join(prof_dir, f))
                                   for f in traces)
        ok = ok and bool(traces) and rec["profile_bytes"] > 0
    rec["ok"] = ok
    emit(rec)
    if not ok:
        raise AssertionError(f"flight_bundles: {rec}")


# -- scenario batches ----------------------------------------------------

# benchmarks/fault_sweep.py:644-687's broadcast campaign: 1,152 scenarios
# of a 24-node grid in batches of 128, 48 values, sync every 4, horizon 8,
# 32 recovery rounds; per-edge delays 1-2 on every other batch
# (fuzz_run's delay_axis="alternate"), batch b drawn by the port's
# sample_scenarios with seed FUZZ_SEED * 1000 + b, as fuzz_run draws it
FUZZ_N, FUZZ_BATCHES, FUZZ_BATCH, FUZZ_NV = 24, 9, 128, 48
FUZZ_HORIZON, FUZZ_MRR, FUZZ_SEQ_HELD, FUZZ_SEED = 8, 32, 8, 1
# the wide folded batch: 256 scenarios of a 1,024-node grid, W = 64; 4
# of its delayed and 2 of its one-hop scenarios held to sequential runs
WIDE_S, WIDE_N, WIDE_NV, WIDE_HORIZON, WIDE_MRR, WIDE_HELD = \
    256, 1024, 2048, 16, 96, 4
WIDE_HELD_ONE_HOP = 2
# the round whose inputs the batched kernels are checked and timed on
BATCH_CAPTURE_ROUND = 5
# fault_sweep.py:699-706: the counter / Kafka breadth batches
LOOP_S, LOOP_N, LOOP_HORIZON = 64, 16, 8
KAFKA_FUZZ_KW = {"n_keys": 4, "capacity": 64, "max_sends": 2,
                 "resync_every": 4, "send_prob": 0.7}
TXN_FUZZ_S, TXN_FUZZ_N = 64, 64
# benchmarks/frontier_cartography.py:55-71's grid (its GRID_KW, through
# harness/frontier.py's frontier_grid): 16 rates x 8 fault levels x 2
# topologies at 8 nodes, until 6, seed 3; MRR 12, drain 4
FRONTIER_RATES = tuple(round(0.05 + 0.9 * i / 15, 4) for i in range(16))
FRONTIER_LEVELS = (None, {"loss_rate": 0.05}, {"loss_rate": 0.15},
                   {"n_crash_windows": 1},
                   {"n_crash_windows": 1, "loss_rate": 0.1},
                   {"n_crash_windows": 2},
                   {"n_crash_windows": 2, "loss_rate": 0.1},
                   {"n_crash_windows": 1, "loss_rate": 0.1,
                    "dup_rate": 0.05})
FRONTIER_GRID = dict(n_nodes=8, rates=FRONTIER_RATES,
                     fault_levels=FRONTIER_LEVELS,
                     topologies=("grid", "tree"), until=6, seed=3)
FRONTIER_PARITY_KEYS = ("arrived", "issued", "deferred", "completed",
                        "in_flight", "conserved", "lat_p50", "lat_p99",
                        "lat_max", "msgs_total", "total_rounds",
                        "converged_round", "recovery_rounds", "ok")
FRONTIER_CPU_CELLS = 32
BATCH_EXPECT = ("fault_coins_batched", "fold_freeze", "col_popcount_nm")
# kernel_check's batched cases: (S, N) x (W, D)
BATCH_CHECK_SN = [(s, n) for s in (1, 3, 128) for n in (1, 24, 1024)]
BATCH_CHECK_WD = ((1, 4), (2, 3), (64, 4))


def batched_case(s: int, n: int, w: int, d: int, seed: int, device,
                 offset: int = 0) -> dict:
    """A folded batch's kernel operands from ``seed``: an (S N, D) table
    of scenario-offset indices with -1 pads, up, a live mask, an (S, 5)
    coin table mixing every loss / dup state, payload, dup rows and
    receivers; every operand ``offset`` words into its allocation."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    nb = rng.integers(-1, n, (s, n, d)).astype(np.int32)
    off = (np.arange(s) * n)[:, None, None]
    fold = np.where(nb >= 0, nb + off, -1).reshape(s * n, d).astype(
        np.int32)
    tab = np.stack([rng.integers(0, 2**32, s), rng.integers(0, 2**32, s) // 3,
                    rng.integers(0, 2**32, s) // 4, np.arange(s) % 2,
                    (np.arange(s) // 2) % 2], axis=1).astype(np.int64)

    def dev(x, words=1):
        return at_offset(torch.from_numpy(np.ascontiguousarray(x)).to(device),
                         offset * words)

    def bits():
        return dev(rng.integers(-2**31, 2**31, (s * n, w)).astype(np.int32))

    return {"fold": dev(fold), "nb": torch.from_numpy(nb).to(device),
            "up": dev(rng.random(s * n) >= 0.1, 4),
            "live": dev((rng.random((s * n, d)) < 0.7) & (fold >= 0), 4),
            "table": dev(tab), "payload": bits(), "received": bits(),
            "rec": bits()}


def check_batched_faults(kernels, note, device) -> None:
    """The batched ``fault_coins`` and ``faulted_gather_round`` against
    their plain forms on the card: every (S, N) of
    :data:`BATCH_CHECK_SN` (blocks that straddle scenarios at N = 1 and
    24), W and D of :data:`BATCH_CHECK_WD` with -1 pads, per-scenario
    mixes of every loss / dup state, with and without a live mask and
    OUT_OK, with and without dup rows, on 4-byte-offset views; at S = 1
    each equals the one-scenario kernel; ``fold_freeze`` with one and two
    pairs under a random active mask."""
    import numpy as np
    import torch

    for s, n in BATCH_CHECK_SN:
        for w, d in BATCH_CHECK_WD:
            for offset in (0, 1):
                c = batched_case(s, n, w, d, s * 7919 + n * 31 + w + d,
                                 device, offset)
                for masked in (False, True):
                    kw = dict(t=9, out_ok=masked, table=c["table"], block=n,
                              live=c["live"] if masked else None)
                    flags = kernels.fault_coins(c["fold"], c["up"], **kw)
                    want = kernels.fault_coins_plain(c["fold"], c["up"], **kw)
                    note("fault_coins_batched", (flags, want))
                    for dup in (False, True):
                        args = (c["payload"], c["received"] if dup else None,
                                c["rec"], c["fold"], want)
                        note("faulted_gather_round_batched", *zip(
                            kernels.faulted_gather_round(*args, block=n),
                            kernels.faulted_gather_round_plain(*args,
                                                               block=n)))
                if s == 1:
                    t = c["table"][0].tolist()
                    one = kernels.fault_coins(
                        c["nb"][0], c["up"].clone(), t=9, seed=t[0],
                        loss_num=t[1], dup_num=t[2], loss=bool(t[3]),
                        dup=bool(t[4]), out_ok=True)
                    flags = kernels.fault_coins(
                        c["fold"], c["up"], t=9, out_ok=True,
                        table=c["table"], block=n)
                    note("fault_coins_batched", (one, flags))
                    a = kernels.faulted_gather_round(
                        c["payload"], c["received"], c["rec"], c["fold"],
                        flags)
                    b = kernels.faulted_gather_round(
                        c["payload"], c["received"], c["rec"], c["fold"],
                        flags, block=n)
                    note("faulted_gather_round_batched", (a[0], b[0]),
                         (a[1], b[1]), (a[2].reshape(1), b[2]))
                active = torch.from_numpy(
                    np.random.default_rng(s + n + w).random(s) < 0.6).to(
                        device)
                for pairs in (1, 2):
                    got = (c["rec"].clone(), c["payload"].clone())
                    want = (c["rec"].clone(), c["payload"].clone())
                    two = pairs == 2
                    kernels.fold_freeze(
                        got[0], c["received"], active, n,
                        got[1] if two else None,
                        c["received"] if two else None)
                    kernels.fold_freeze_plain(
                        want[0], c["received"], active, n,
                        want[1] if two else None,
                        c["received"] if two else None)
                    note("fold_freeze", (got[0], want[0]), (got[1], want[1]))
                del c
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def broadcast_fuzz_batch(scenario, fuzz, topology, b: int) -> object:
    """Batch ``b`` of the 1,152-scenario broadcast campaign, drawn by
    harness/fuzz.py's ``sample_scenarios`` as ``fuzz_run("broadcast",
    1152, seed=FUZZ_SEED)`` draws it (seed ``FUZZ_SEED * 1000 + b``, the
    partition axis on, per-edge delays 1-2 on odd batches)."""
    nbrs = topology.to_padded_neighbors(topology.grid(FUZZ_N))
    cells = fuzz.sample_scenarios(
        "broadcast", FUZZ_BATCH, n_nodes=FUZZ_N, seed=FUZZ_SEED * 1000 + b,
        horizon=FUZZ_HORIZON, nbrs_shape=nbrs.shape, delay_axis=bool(b % 2))
    return scenario.ScenarioBatch(
        workload="broadcast", scenarios=tuple(cells),
        runner_kw={"n_values": FUZZ_NV, "topology": "grid",
                   "sync_every": 4},
        max_recovery_rounds=FUZZ_MRR)


def timed_trip(scenario, kernels, batch, device, tel=None) -> tuple:
    """(collected result, record): one folded batch staged, its trip run
    under torch's sync debug mode (``no_host_sync``), collected; the
    stage / trip / collect walls (the trip's ends at a synchronize), the
    trip's rounds and port launches a round."""
    import torch

    t0 = time.perf_counter()
    staged = scenario.stage_broadcast_batch(batch, telemetry_spec=tel,
                                            device=device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    before = dict(kernels.LAUNCHES)
    handle = no_host_sync(lambda: scenario.broadcast_trip(staged))
    enqueue = time.perf_counter() - t1
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    trip = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
            if v > before[k]}
    port = sum(trip.values())
    handle["n_real"] = len(batch.scenarios)
    res = scenario.collect_scenario_batch(handle)
    t3 = time.perf_counter()
    rounds = res["rounds"]
    want = fold_launches(staged["fb"].classes, rounds)
    got = {k: trip.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"folded trip launched {got}, not {want}: its "
                             "launches a round must not grow with S")
    return res, {"stage_s": t1 - t0, "trip_s": t2 - t1,
                 "trip_launches": trip,
                 "trip_enqueue_s": enqueue, "collect_s": t3 - t2,
                 "wall_s": t3 - t0, "rounds": rounds,
                 "ms_per_round": (t2 - t1) * 1e3 / rounds,
                 "launches_per_round": port / rounds,
                 "scenarios_per_s": len(batch.scenarios) / (t3 - t0),
                 "no_host_sync": True}


def fold_launches(classes, rounds: int) -> dict:
    """The batched launches a folded trip of ``rounds`` rounds makes,
    whatever S is: a one-hop round (``classes`` None) one
    ``fault_coins_batched`` and one ``faulted_gather_round_batched``; a
    delayed round one ``fault_coins_batched``, and per delay class v
    whose send round t - (v - 1) is >= 0 one more (its send round's
    liveness) and one ``gather_or``; a ``fold_freeze`` of the state a
    round (and of the ring slot under delays); no one-scenario coin or
    round launch."""
    if classes is None:
        return {"fault_coins_batched": rounds,
                "faulted_gather_round_batched": rounds, "gather_or": 0,
                "fold_freeze": rounds, "fault_coins": 0,
                "faulted_gather_round": 0}
    terms = sum(1 for t in range(rounds) for v in classes if t >= v - 1)
    return {"fault_coins_batched": rounds + terms,
            "faulted_gather_round_batched": 0, "gather_or": terms,
            "fold_freeze": 2 * rounds, "fault_coins": 0,
            "faulted_gather_round": 0}


def trip_busy(scenario, batch, device) -> tuple:
    """(device busy ms, spans) of one staged trip under the profiler."""
    def make_run():
        staged = scenario.stage_broadcast_batch(batch, device=device)
        return lambda: scenario.broadcast_trip(staged)

    return busy_and_spans(make_run)


def seq_state(broadcast, topology, batch, k: int, rounds: int, device):
    """Scenario ``k`` of a broadcast batch stepped alone on a
    BroadcastSim (the sequential runner's sim) for ``rounds`` rounds: its
    received set, (N, W) uint32."""
    import numpy as np

    sc = batch.scenarios[k]
    kw = batch.runner_kw
    n = batch.n_nodes
    sim = broadcast.BroadcastSim(
        topology.to_padded_neighbors(topology.grid(n)),
        n_values=kw["n_values"], sync_every=kw["sync_every"],
        parts=(None if sc.parts is None
               else broadcast.Partitions.from_meta(sc.parts)),
        delays=None if sc.delays is None else np.asarray(sc.delays),
        fault_plan=sc.spec.compile(device=device), srv_ledger=False,
        device=device)
    inject = broadcast.make_inject(n, kw["n_values"])
    state = sim.init_state(inject)
    for _ in range(rounds):
        state = sim.step(state)
    return sim.received_node_major(state)


def seq_nemesis(nemesis, batch, k: int, device, tel=None) -> dict:
    """Scenario ``k`` through the port's ``run_broadcast_nemesis``."""
    import numpy as np

    sc = batch.scenarios[k]
    kw = batch.runner_kw
    return nemesis.run_broadcast_nemesis(
        sc.spec, n_values=kw["n_values"], topology=kw["topology"],
        sync_every=kw["sync_every"],
        max_recovery_rounds=batch.max_recovery_rounds, parts=sc.parts,
        delays=None if sc.delays is None else np.asarray(sc.delays),
        telemetry=tel, device=device)


def held_to_sequential(modules, batch, res, ks, device, tel=None) -> bool:
    """Scenarios ``ks`` of a collected batch against their sequential
    runs on the card: the verdict rows, the telemetry series, and the
    received set of the scenario's BroadcastSim stepped to its final
    round."""
    import numpy as np

    broadcast, nemesis, topology = modules
    keys = ("converged_round", "recovery_rounds", "msgs_total", "ok",
            "lost_writes")
    final = res["final"].received.cpu().numpy().view(np.uint32)
    ok = True
    for k in ks:
        seq = seq_nemesis(nemesis, batch, k, device, tel)
        row = res["scenarios"][k]
        ok = ok and all(row[key] == seq[key] for key in keys)
        if tel is not None:
            series = {x: v for x, v in seq["telemetry"]["series"].items()
                      if not x.startswith("_")}
            ok = ok and all(res["telemetry"][k][x] == v
                            for x, v in series.items())
        t_final = (row["converged_round"] if row["converged_round"]
                   is not None else batch.scenarios[k].spec.clear_round
                   + batch.max_recovery_rounds)
        ok = ok and np.array_equal(
            seq_state(broadcast, topology, batch, k, t_final, device),
            final[k])
    return ok


def same_batch_rows(a: dict, b: dict) -> bool:
    return a["scenarios"] == b["scenarios"] and a["ok"] == b["ok"]


def batched_kernel_times(scenario, kernels, broadcast, batch, device) -> dict:
    """The batched kernels on a staged batch's own inputs at round
    :data:`BATCH_CAPTURE_ROUND` (the trip run that far): checked against
    their plain forms and timed ({name: record}), ``fold_freeze`` on the
    round's rows (its plain form the two ``torch.where`` it replaced);
    with the time of the round's convergence fold (torch ops).  The
    batch is a one-hop one, whose trip launches both batched kernels
    every round (a delayed trip launches no ``faulted_gather_round``)."""
    import torch

    if any(sc.delays is not None for sc in batch.scenarios):
        raise ValueError("batched kernels are timed on a one-hop batch")
    staged = scenario.stage_broadcast_batch(batch, device=device)
    t = BATCH_CAPTURE_ROUND
    st = scenario.broadcast_trip(dict(staged, rounds=t))["state"]
    fb = staged["fb"]
    wipe = fb.rows(fb.plan.amnesia(fb.wflags, t))
    rec0 = st.received.masked_fill(wipe, 0)
    payload = st.frontier.masked_fill(wipe, 0)
    up = fb.up(t)
    live = fb.edge_live(t)
    coins = dict(t=t, live=live, table=fb.table[t], block=fb.n)
    flags = kernels.fault_coins(fb.nbrs, up, **coins)
    plain = kernels.fault_coins_plain(fb.nbrs, up, **coins)
    errs = {"fault_coins_batched": max_abs_err(flags, plain)}
    got = kernels.faulted_gather_round(payload, rec0, rec0, fb.nbrs, flags,
                                       block=fb.n)
    want = kernels.faulted_gather_round_plain(payload, rec0, rec0, fb.nbrs,
                                              flags, block=fb.n)
    errs["faulted_gather_round_batched"] = max(
        max_abs_err(a, b) for a, b in zip(got, want))
    if any(errs.values()):
        raise AssertionError(f"batched kernels on the batch's inputs: {errs}")
    rows, w = payload.shape
    edges = fb.nbrs.numel()
    n_send = int(((flags & kernels.FLAG_SEND) != 0).sum())
    n_del = int(((flags & kernels.FLAG_DEL) != 0).sum())
    n_dup = int(((flags & kernels.FLAG_DUP) != 0).sum())
    words = rows * w
    s = fb.s_count
    out = {
        # the index table, up, the mask and the table of coins in, a flag
        # byte an edge out; a loss coin on every sent edge and a dup coin
        # on every delivered one, and a few operations an edge besides
        # (as the one-scenario bound counts them)
        "fault_coins_batched": _timed(
            "fault_coins_batched",
            lambda: kernels.fault_coins(fb.nbrs, up, **coins),
            lambda: kernels.fault_coins_plain(fb.nbrs, up, **coins),
            bound(4 * edges + rows + edges
                  + (0 if live is None else edges) + 40 * s,
                  13 * (n_send + n_del) + 8 * edges)),
        # payload and rec0 (also the dup rows, read once), the index
        # table and flags in, new and rec_next and S charges out
        "faulted_gather_round_batched": _timed(
            "faulted_gather_round_batched",
            lambda: kernels.faulted_gather_round(payload, rec0, rec0,
                                                 fb.nbrs, flags, block=fb.n),
            lambda: kernels.faulted_gather_round_plain(
                payload, rec0, rec0, fb.nbrs, flags, block=fb.n),
            bound(2 * 4 * words + 5 * edges + 2 * 4 * words + 8 * s,
                  (2 * (n_del + n_dup) + n_dup) * w + 3 * rows * w)),
    }
    for name, rec in out.items():
        rec.update(library_ms=None, max_abs_err=errs[name], round=t,
                   coins={"send": n_send, "deliver": n_del, "dup": n_dup})
    # the round's freeze: round 5's state rows into copies, the scenarios
    # still active at round 5 (every one of these batches' is)
    active = torch.ones(s, dtype=torch.bool, device=device)
    dst = (st.received.clone(), st.frontier.clone())
    want = (st.received.clone(), st.frontier.clone())
    kernels.fold_freeze(dst[0], got[1], active, fb.n, dst[1], got[0])
    kernels.fold_freeze_plain(want[0], got[1], active, fb.n, want[1],
                              got[0])
    err = max(max_abs_err(a, b) for a, b in zip(dst, want))
    if err:
        raise AssertionError(f"fold_freeze on the batch's rows: {err}")
    moved = 2 * 2 * 4 * words * int(active.sum()) // s + s
    out["fold_freeze"] = _timed(
        "fold_freeze",
        lambda: kernels.fold_freeze(dst[0], got[1], active, fb.n, dst[1],
                                    got[0]),
        lambda: kernels.fold_freeze_plain(want[0], got[1], active, fb.n,
                                          want[1], got[0]),
        bound(moved, 0))
    out["fold_freeze"].update(library_ms=None, max_abs_err=err, round=t)
    ops = {"freeze_plain_ms": out["fold_freeze"]["plain_ms"],
           "convergence_ms": cuda_ms(lambda: broadcast._batch_converged(
               fb, st, staged["target"], staged["member"]))}
    return out, ops


def scenario_broadcast_fuzz(modules, device, launches: Launches, card: str,
                            times: dict) -> None:
    """The 1,152-scenario broadcast campaign as 9 folded batches of 128
    (:func:`broadcast_fuzz_batch`): each batch's walls, rounds, launches
    a round and scenarios a second; the device idle share of a one-hop
    and a delayed trip; batch 0's 128 scenarios one at a time through
    ``run_broadcast_nemesis`` on the card (ms a scenario both ways), 8 of
    them held bit for bit (rows, telemetry, received) and the whole of
    batch 0 against the CPU path."""
    broadcast, nemesis, scenario, telemetry, topology, _, kernels, fuzz = \
        modules
    rec = {"phase": "scenario_broadcast_fuzz", "card": card, "n": FUZZ_N,
           "n_values": FUZZ_NV, "batches": FUZZ_BATCHES,
           "batch_size": FUZZ_BATCH, "horizon": FUZZ_HORIZON,
           "max_recovery_rounds": FUZZ_MRR, "per_batch": []}
    batches = [broadcast_fuzz_batch(scenario, fuzz, topology, b)
               for b in range(FUZZ_BATCHES)]
    certified = 0
    launches.start()
    results = []
    for b, batch in enumerate(batches):
        res, t = timed_trip(scenario, kernels, batch, device)
        results.append(res)
        certified += sum(1 for r in res["scenarios"] if r["ok"])
        t.update(batch=b, delays=bool(b % 2), n_ok=sum(
            1 for r in res["scenarios"] if r["ok"]))
        rec["per_batch"].append(t)
    launches.stop(rec, BATCH_EXPECT + ("faulted_gather_round_batched",
                                       "gather_or"))
    wall = sum(t["wall_s"] for t in rec["per_batch"])
    rec.update(n_scenarios=FUZZ_BATCHES * FUZZ_BATCH, n_certified=certified,
               wall_s=wall, scenarios_per_s=FUZZ_BATCHES * FUZZ_BATCH / wall)
    for b in (0, 1):
        busy, spans = trip_busy(scenario, batches[b], device)
        trip_ms = rec["per_batch"][b]["trip_s"] * 1e3
        rec[f"batch{b}_device_busy_ms"] = busy
        rec[f"batch{b}_device_idle_share"] = idle_share(busy, trip_ms)
        rec[f"batch{b}_device_spans"] = spans
    t0 = time.perf_counter()
    seq = [seq_nemesis(nemesis, batches[0], k, device)
           for k in range(FUZZ_BATCH)]
    seq_s = time.perf_counter() - t0
    rec["sequential_ms_per_scenario"] = seq_s * 1e3 / FUZZ_BATCH
    rec["batch_ms_per_scenario"] = \
        rec["per_batch"][0]["wall_s"] * 1e3 / FUZZ_BATCH
    keys = ("converged_round", "recovery_rounds", "msgs_total", "ok",
            "lost_writes")
    rec["sequential_rows_equal"] = all(
        results[0]["scenarios"][k][key] == seq[k][key]
        for k in range(FUZZ_BATCH) for key in keys)
    tel = telemetry.TelemetrySpec("broadcast",
                                  rounds=FUZZ_HORIZON + FUZZ_MRR)
    held, _ = timed_trip(scenario, kernels, batches[0], device, tel)
    rec["held_bit_for_bit"] = held_to_sequential(
        (broadcast, nemesis, topology), batches[0], held,
        range(FUZZ_SEQ_HELD), device, tel) and same_batch_rows(
            held, results[0])
    t0 = time.perf_counter()
    cpu = scenario.run_scenario_batch(batches[0], device="cpu")
    rec["cpu_s"] = time.perf_counter() - t0
    rec["cpu_equal"] = same_batch_rows(cpu, results[0]) and bool(
        (cpu["final"].received == results[0]["final"].received.cpu()).all())
    shape = (results[0]["final"].received.shape[2],
             FUZZ_N * FUZZ_BATCH)
    kt, ops = batched_kernel_times(scenario, kernels, broadcast, batches[0],
                                   device)
    for name, r in kt.items():
        times.setdefault(name, {})[shape] = r
    rec["batched_kernels"] = kt
    rec["torch_ops"] = ops
    rec["ok"] = bool(rec["sequential_rows_equal"] and rec["held_bit_for_bit"]
                     and rec["cpu_equal"])
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"scenario_broadcast_fuzz: {rec}")


def wide_batch(scenario, faults, topology):
    """256 scenarios of a 1,024-node grid, 2,048 values (W = 64), horizon
    16, 96 recovery rounds, per-edge delays 1-2: scenario i is
    ``random_spec(1024, seed=i, horizon=16)`` with ``1 + i % 2`` crash
    windows, loss 0.1 on even i and dup 0.05 on every third, the
    even/odd partition window [2, 5) on every fourth."""
    import numpy as np

    nbrs = topology.to_padded_neighbors(topology.grid(WIDE_N))
    even_odd = {"starts": [2], "ends": [5],
                "group": [(np.arange(WIDE_N) % 2).tolist()]}
    cells = []
    for i in range(WIDE_S):
        spec = faults.random_spec(
            WIDE_N, seed=i, horizon=WIDE_HORIZON, n_crash_windows=1 + i % 2,
            loss_rate=0.1 * (i % 2 == 0), dup_rate=0.05 * (i % 3 == 0))
        cells.append(scenario.Scenario(
            spec=spec, parts=even_odd if i % 4 == 0 else None,
            delays=tuple(map(tuple, np.random.default_rng(i).integers(
                1, 3, nbrs.shape).tolist()))))
    return scenario.ScenarioBatch(
        workload="broadcast", scenarios=tuple(cells),
        runner_kw={"n_values": WIDE_NV, "topology": "grid",
                   "sync_every": 4},
        max_recovery_rounds=WIDE_MRR)


def scenario_broadcast_256x1024(modules, device, launches: Launches,
                                card: str, times: dict) -> None:
    """:func:`wide_batch` folded into 262,144 rows, delayed and one-hop
    (the same scenarios without their delays): each trip's wall and ms a
    round, launches a round and device idle share; each batched kernel's
    device ms and bound on the one-hop trip's own round-5 inputs; the
    torch freeze and convergence ops' device ms; 4 delayed and 2 one-hop
    scenarios held against their sequential runs on the card."""
    import torch

    broadcast, nemesis, scenario, telemetry, topology, faults, kernels, _ = \
        modules
    batch = wide_batch(scenario, faults, topology)
    one_hop = dataclasses.replace(batch, scenarios=tuple(
        dataclasses.replace(sc, delays=None) for sc in batch.scenarios))
    rec = {"phase": "scenario_broadcast_256x1024", "card": card,
           "scenarios": WIDE_S, "n": WIDE_N, "n_values": WIDE_NV,
           "rows": WIDE_S * WIDE_N, "horizon": WIDE_HORIZON,
           "max_recovery_rounds": WIDE_MRR}
    launches.start()
    res, t = timed_trip(scenario, kernels, batch, device)
    res1, t1 = timed_trip(scenario, kernels, one_hop, device)
    MESH_PROV_ONE["wide"] = {"rows": res1["scenarios"],
                             "rounds": res1["rounds"],
                             "launches_per_round": t1["launches_per_round"]}
    launches.stop(rec, BATCH_EXPECT + ("gather_or",
                                       "faulted_gather_round_batched"))
    rec.update(t)
    rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["n_certified"] = sum(1 for r in res["scenarios"] if r["ok"])
    busy, spans = trip_busy(scenario, batch, device)
    rec.update(device_busy_ms=busy, device_spans=spans,
               device_idle_share=idle_share(busy, t["trip_s"] * 1e3))
    busy, spans = trip_busy(scenario, one_hop, device)
    t1.update(n_certified=sum(1 for r in res1["scenarios"] if r["ok"]),
              device_busy_ms=busy, device_spans=spans,
              device_idle_share=idle_share(busy, t1["trip_s"] * 1e3))
    rec["one_hop"] = t1
    shape = (WIDE_NV // 32, WIDE_S * WIDE_N)
    kt, ops = batched_kernel_times(scenario, kernels, broadcast, one_hop,
                                   device)
    for name, r in kt.items():
        times.setdefault(name, {})[shape] = r
    rec["batched_kernels"] = kt
    rec["torch_ops"] = ops
    rec["held_bit_for_bit"] = held_to_sequential(
        (broadcast, nemesis, topology), batch, res,
        range(WIDE_HELD), device) and held_to_sequential(
            (broadcast, nemesis, topology), one_hop, res1,
            range(WIDE_HELD_ONE_HOP), device)
    rec["ok"] = bool(rec["held_bit_for_bit"])
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"scenario_broadcast_256x1024: {rec}")


def same_states(a, b) -> bool:
    """Two stacked states equal leaf by leaf (tensors on either device,
    host arrays)."""

    import numpy as np
    import torch

    def leaves(x):
        if dataclasses.is_dataclass(x):
            return [getattr(x, f.name) for f in dataclasses.fields(x)]
        return list(x)

    for p, q in zip(leaves(a), leaves(b)):
        if isinstance(p, torch.Tensor):
            if not torch.equal(p.cpu(), q.cpu()):
                return False
        elif isinstance(p, tuple) or dataclasses.is_dataclass(p):
            if not same_states(p, q):
                return False
        elif not np.array_equal(np.asarray(p), np.asarray(q)):
            return False
    return True


def looped_phase(name: str, scenario, kernels, batch, device,
                 launches: Launches, card: str, expect: tuple,
                 extra: dict) -> dict:
    """A looped batch on the card and on the CPU: the wall, trips, host
    syncs and port launches a trip, the certified count, and equality of
    the rows and final states with the CPU path."""
    import torch

    rec = {"phase": name, "card": card, "scenarios": len(batch.scenarios),
           "n": batch.n_nodes, "max_recovery_rounds":
           batch.max_recovery_rounds, **extra}
    launches.start()
    t0 = time.perf_counter()
    res = scenario.run_scenario_batch(batch, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.stop(rec, expect)
    port = sum(rec["launches"].values())
    t0 = time.perf_counter()
    cpu = scenario.run_scenario_batch(batch, device="cpu")
    rec.update(wall_s=wall, cpu_s=time.perf_counter() - t0,
               scenarios_per_s=len(batch.scenarios) / wall,
               trips=res["trips"], rounds=res["rounds"],
               syncs=res["syncs"], syncs_per_trip=res["syncs"] / res["trips"],
               launches_per_trip=port / res["trips"],
               ms_per_trip=wall * 1e3 / res["trips"],
               n_certified=sum(1 for r in res["scenarios"] if r["ok"]),
               cpu_equal=bool(same_batch_rows(res, cpu)
                              and same_states(res["final"], cpu["final"])))
    return res, rec


def scenario_looped_phases(modules, device, launches: Launches,
                           card: str) -> None:
    """fault_sweep.py:699-706's counter and Kafka breadth batches (64
    scenarios at 16 nodes, horizon 8) and 64 txn campaigns at 64 nodes
    (the runner_kw defaults), each scenario on its own sim under its own
    plan, held against the CPU path; every txn verdict serializable."""
    scenario, fuzz, kernels = modules
    for name, wl, seed, kw, mrr, expect in (
            ("scenario_counter_fuzz", "counter", 2,
             {"mode": "cas", "poll_every": 2}, 48,
             ("counter_select", "counter_apply")),
            ("scenario_kafka_fuzz", "kafka", 3, KAFKA_FUZZ_KW, 32,
             ("kafka_merge", "kafka_nem_deliver"))):
        cells = fuzz.sample_scenarios(wl, LOOP_S, n_nodes=LOOP_N, seed=seed,
                                      horizon=LOOP_HORIZON)
        batch = scenario.ScenarioBatch(workload=wl, scenarios=tuple(cells),
                                       runner_kw=kw, max_recovery_rounds=mrr)
        res, rec = looped_phase(name, scenario, kernels, batch, device,
                                launches, card, expect,
                                {"horizon": LOOP_HORIZON, "runner_kw": kw})
        MESH_PROV_ONE[name] = res["scenarios"]
        rec["ok"] = rec["cpu_equal"]
        emit(rec)
        if not rec["ok"]:
            raise AssertionError(f"{name}: {rec}")
    cells = fuzz.sample_scenarios("txn", TXN_FUZZ_S, n_nodes=TXN_FUZZ_N,
                                  seed=4, horizon=LOOP_HORIZON)
    batch = scenario.ScenarioBatch(workload="txn", scenarios=tuple(cells))
    res, rec = looped_phase("scenario_txn", scenario, kernels, batch, device,
                            launches, card, ("txn_claim", "txn_commit"),
                            {"runner_kw": scenario._txn_kw(batch)})
    MESH_PROV_ONE["scenario_txn"] = res["scenarios"]
    rec["all_serializable"] = all(r["serializable"]
                                  for r in res["scenarios"])
    rec["n_committed"] = sum(r["n_committed"] for r in res["scenarios"])
    rec["ok"] = bool(rec["cpu_equal"] and rec["all_serializable"])
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"scenario_txn: {rec}")


def serving_batch_frontier(modules, device, launches: Launches,
                           card: str) -> list:
    """The 256-cell broadcast frontier (:data:`FRONTIER_GRID`) as one
    serving batch on the card (MRR 12, drain 4, ``n_windows=2``): its
    wall, trips, syncs and launches a trip; every row equal to the
    port's ``run_serving`` of its cell on the card on the cartography's
    parity keys; the first 32 cells equal to the CPU path."""
    import torch

    scenario, serving, frontier, kernels = modules
    cells = frontier.frontier_grid("broadcast", **FRONTIER_GRID)
    batch = scenario.ServingBatch(workload="broadcast", cells=tuple(cells),
                                  max_recovery_rounds=12, drain_every=4)
    rec = {"phase": "serving_batch_frontier", "card": card,
           "cells": len(cells), "n": 8, "max_recovery_rounds": 12,
           "drain_every": 4}
    launches.start()
    t0 = time.perf_counter()
    res = scenario.run_serving_batch(batch, n_windows=2, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.stop(rec, ("fault_coins", "faulted_gather_round", "and_fold"))
    port = sum(rec["launches"].values())
    t0 = time.perf_counter()
    seq = [serving.run_serving(
        "broadcast", c.traffic, nemesis=c.spec,
        sim_kw=scenario._serving_sim_kw(batch, c), max_recovery_rounds=12,
        drain_every=4, device=device) for c in cells]
    seq_s = time.perf_counter() - t0
    bad = [(i, k) for i, (s, row) in enumerate(zip(seq, res["cells"]))
           for k in FRONTIER_PARITY_KEYS if s.get(k) != row.get(k)]
    sub = scenario.ServingBatch(
        workload="broadcast", cells=tuple(cells[:FRONTIER_CPU_CELLS]),
        max_recovery_rounds=12, drain_every=4)
    cpu = scenario.run_serving_batch(sub, n_windows=2, device="cpu")
    rec.update(wall_s=wall, cells_per_s=len(cells) / wall,
               ms_per_cell=wall * 1e3 / len(cells),
               sequential_ms_per_cell=seq_s * 1e3 / len(cells),
               trips=res["trips"], rounds=res["rounds"], syncs=res["syncs"],
               syncs_per_trip=res["syncs"] / res["trips"],
               launches_per_trip=port / res["trips"],
               n_ok=sum(1 for r in res["cells"] if r["ok"]),
               run_serving_equal=not bad, mismatches=bad[:8],
               cpu_equal=cpu["cells"] == res["cells"][:FRONTIER_CPU_CELLS])
    rec["ok"] = bool(rec["run_serving_equal"] and rec["cpu_equal"])
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"serving_batch_frontier: {rec}")
    return res["cells"]


# -- checkpoints, elastic resize, the frontier and the fuzzer -------------

# where the phases below write their checkpoints, bundles and repros: a
# directory of the checkout that git ignores
WORK_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke")
# checkpoint_tree_1m: the round saved, inside the crash window [2, 16)
CKPT_ROUND = 8
# resize_broadcast_full: tests/test_membership.py:242-276's specs scaled
# to 1,024 <-> 1,536 nodes (and 64 <-> 96 for the card / CPU twins)
RESIZE_BCAST = ((1024, 1536), (64, 96))
RESIZE_BCAST_KEYS, RESIZE_MRR = 65536, 48
# resize_counter_1m: 2^20 <-> 2^21 nodes, config3b's deltas
RESIZE_COUNTER_N = 1 << 20
# resize_kafka_4k: kafka_nemesis_4k's 4,096 nodes, tests/test_membership
# .py:311-329's specs
RESIZE_KAFKA_N = 4096
RESIZE_KAFKA_KW = {"n_keys": 1024, "capacity": 64, "max_sends": 2,
                   "resync_every": 4, "send_prob": 0.7}
# tests/test_frontier.py:199-204's small grid, whose first two cells the
# SLO run takes
SLO_GRID = dict(n_nodes=8, rates=(0.3, 0.6),
                fault_levels=(None, {"n_crash_windows": 1, "loss_rate": 0.1}),
                until=8, seed=3)
# the keys of a resize result that the phase lines leave out (the specs
# and the moved keys run to a million entries)
RESIZE_BULKY = ("spec", "continuation_spec")


def work_dir(name: str) -> str:
    """A fresh directory under :data:`WORK_ROOT`."""
    import shutil

    path = os.path.join(WORK_ROOT, name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def checkpoint_tree_1m(modules, device, launches: Launches,
                       card: str) -> None:
    """The main path's 2^20-node 4-ary tree, words-major, under
    ``w1_tree_nemesis``'s plan and under ``w1_tree_nemesis_delayed``'s
    (``dir_delays = (1, 3)``, the delay ring in the file): run to
    convergence, then again with a checkpoint at round
    :data:`CKPT_ROUND`, restored on the card in a sim rebuilt from the
    file's ``fault_spec`` and finished.  ``ok``: received, frontier,
    msgs and t equal the uninterrupted run, and the file's arrays carry
    the reference's names and dtypes.  The save and restore ms (host
    clock, synchronized) and the file's bytes."""
    import numpy as np
    import torch

    broadcast, structured, topology, faults, checkpoint = modules
    n = N_NODES
    inject = broadcast.make_inject(n, W1_VALUES)
    nbrs = topology.to_padded_neighbors(topology.tree(n, BRANCHING))
    spec = tree_nemesis_spec(faults, n)
    out = work_dir("checkpoint")

    def sim_of(sp, dd):
        return broadcast.BroadcastSim(
            nbrs, n_values=W1_VALUES, sync_every=8, srv_ledger=False,
            fault_plan=sp.compile(device), device=device,
            exchange=structured.make_exchange("tree", n),
            nemesis=structured.make_nemesis("tree", n, sp, dir_delays=dd,
                                            device=device))

    rec = {"phase": "checkpoint_tree_1m", "card": card, "n": n,
           "n_values": W1_VALUES, "sync_every": 8,
           "save_round": CKPT_ROUND, "plans": []}
    launches.start()
    for name, dd in (("w1_tree_nemesis", None),
                     ("w1_tree_nemesis_delayed", (1, 3))):
        sim = sim_of(spec, dd)
        ref, rounds = sim.run(inject)
        st = sim.init_state(inject)
        for _ in range(CKPT_ROUND):
            st = sim.step(st)
        path = os.path.join(out, f"{name}.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save(path, st, {"phase": rec["phase"], "plan": name},
                        fault_spec=spec)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        back, meta = checkpoint.restore(path, broadcast.BroadcastState,
                                        device=device)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        sim2 = sim_of(checkpoint.fault_spec_from_meta(meta), dd)
        while back.t < rounds:
            back = sim2.step(back)
        with np.load(path) as z:
            arrays = {k: [str(z[k].dtype), list(z[k].shape)]
                      for k in z.files if k != "__meta__"}
        words = [1, n]
        want = {"received": ["uint32", words], "frontier": ["uint32", words],
                "t": ["int32", []], "msgs": ["uint32", []]}
        if dd is not None:
            want["history"] = ["uint32", [st.history.shape[0]] + words]
        resumed = (back.t == ref.t == rounds and all(
            torch.equal(getattr(back, f), getattr(ref, f))
            for f in ("received", "frontier", "msgs")))
        rec["plans"].append({
            "plan": name, "dir_delays": None if dd is None else list(dd),
            "rounds": rounds, "save_ms": save_ms, "restore_ms": restore_ms,
            "file_bytes": os.path.getsize(path), "arrays": arrays,
            "arrays_as_reference": arrays == want,
            "resumed_equal": resumed})
    launches.stop(rec, ("wm_fault_coins", "tree_ring_exchange",
                        "col_popcount"))
    rec["ok"] = all(p["resumed_equal"] and p["arrays_as_reference"]
                    for p in rec["plans"])
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"checkpoint_tree_1m: {rec}")


def resize_summary(res: dict, wall_s: float) -> dict:
    """A resize result for a phase line: the verdict's fields without the
    bulky specs and moved keys, and the wall."""
    out = {k: v for k, v in res.items() if k not in RESIZE_BULKY}
    if "rehoming" in out:
        out["rehoming"] = {k: v for k, v in out["rehoming"].items()
                           if k != "moved_keys"}
    out["wall_s"] = wall_s
    return out


def resize_run(membership, wl: str, spec, n_to: int, r: int, device,
               **kw) -> tuple[dict, float]:
    """(result, wall s) of one ``run_resize_campaign`` on ``device``."""
    import torch

    t0 = time.perf_counter()
    res = membership.run_resize_campaign(
        wl, spec, n_to, r, checkpoint_dir=work_dir(f"resize_{wl}"),
        device=device, **kw)
    if device != "cpu":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def resize_idle(membership, wl: str, spec, n_to: int, r: int, device,
                wall_s: float, **kw) -> dict:
    """The device busy ms (profiler) of one more run of a campaign, and
    its idle share against ``wall_s``, the unprofiled run's wall."""
    def make_run():
        return lambda: membership.run_resize_campaign(
            wl, spec, n_to, r, checkpoint_dir=work_dir(f"resize_{wl}_p"),
            device=device, **kw)

    busy, spans = busy_and_spans(make_run)
    return {"device_busy_ms": busy, "device_spans": spans,
            "device_idle_share": idle_share(busy, wall_s * 1e3)}


def resize_broadcast_full(modules, device, launches: Launches,
                          card: str) -> None:
    """Broadcast on ``full``, n_values = 2N: grow 1,024 -> 1,536 at round
    6 under a crash window [4, 9) of nodes (1, 2) that crosses the
    boundary; shrink 1,536 -> 1,024 at round 6 with rows 1,024-1,535
    leaving at round 3; ``kv_keys`` 65,536, 48 recovery rounds.  ``ok``:
    each certified, its twin bit-exact, the re-homing diff and carry ok;
    the same campaigns at 64 <-> 96 nodes give equal results on the card
    and the CPU."""
    membership, faults = modules

    def specs(n, m):
        return ((faults.NemesisSpec(n_nodes=n, seed=3,
                                    crash=((4, 9, (1, 2)),)), m),
                (faults.NemesisSpec(n_nodes=m, seed=5, crash=((4, 9, (1,)),),
                                    leave=((3, tuple(range(n, m))),)), n))

    kw = dict(kv_keys=RESIZE_BCAST_KEYS, max_recovery_rounds=RESIZE_MRR)
    rec = {"phase": "resize_broadcast_full", "card": card,
           "sizes": [list(x) for x in RESIZE_BCAST], "resize_round": 6,
           **kw, "campaigns": {}}
    launches.start()
    for shape, (spec, n_to) in zip(("grow", "shrink"),
                                   specs(*RESIZE_BCAST[0])):
        res, wall = resize_run(membership, "broadcast", spec, n_to, 6,
                               device, **kw)
        rec["campaigns"][shape] = resize_summary(res, wall)
    launches.stop(rec, ("fault_coins", "faulted_gather_round"))
    spec, n_to = specs(*RESIZE_BCAST[0])[0]
    rec["grow_device"] = resize_idle(membership, "broadcast", spec, n_to, 6,
                                     device, rec["campaigns"]["grow"]
                                     ["wall_s"], **kw)
    twins = {}
    for shape, (spec, n_to) in zip(("grow", "shrink"),
                                   specs(*RESIZE_BCAST[1])):
        gpu, _ = resize_run(membership, "broadcast", spec, n_to, 6, device,
                            **kw)
        cpu, _ = resize_run(membership, "broadcast", spec, n_to, 6, "cpu",
                            **kw)
        twins[shape] = {"ok": gpu["ok"], "cpu_equal": gpu == cpu}
    rec["small_card_cpu"] = twins
    rec["ok"] = all(c["ok"] and c["twin"]["bit_exact"]
                    and c["rehoming"]["ok"]
                    for c in rec["campaigns"].values()) and all(
        t["ok"] and t["cpu_equal"] for t in twins.values())
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"resize_broadcast_full: {rec}")


def resize_device_functions(membership_ops, kvstore, faults, traffic,
                            counter, device) -> dict:
    """CUDA-event ms of the device functions the resize path adds, at
    resize_counter_1m's sizes: the moved-key mask over 2^20 keys, the
    carry of 2^20 registers (one gather, one scatter, the index uploads),
    the member census of a 2^21-row plan, the counter state's pad to
    2^21 and cut back, and the resizing intake gate's sum over 2^20
    arrivals."""
    import numpy as np
    import torch

    n, k = RESIZE_COUNTER_N, RESIZE_COUNTER_N
    M = membership_ops
    lo, ln = kvstore.make_layout(k, n), kvstore.make_layout(k, 2 * n)
    rows = kvstore.init_rows(lo, device)
    spec = faults.NemesisSpec(n_nodes=2 * n, seed=5,
                              leave=((8, tuple(range(n, 2 * n))),))
    plan = spec.compile(device)
    ids = torch.arange(2 * n, dtype=torch.int32, device=device)
    sim = counter.CounterSim(n, mode="allreduce", device=device)
    st = sim.add(sim.init_state(), np.arange(n, dtype=np.int32) % 10)
    big = M.resize_state(st, 2 * n)
    tspec = traffic.TrafficSpec(n_nodes=n, n_clients=n, ops_per_client=1,
                                until=4)
    ts = traffic.init_state(tspec, device=device)
    arr = torch.rand(n, device=device) < 0.5
    return {
        "rehomed_mask_ms": cuda_ms(lambda: M.rehomed_mask(k, n, 2 * n,
                                                          device=device)),
        "apply_rehoming_ms": cuda_ms(lambda: M.apply_rehoming(rows, lo, ln),
                                     inner=3),
        "member_census_ms": cuda_ms(lambda: M.member_census(plan, 9, ids)),
        "resize_state_pad_ms": cuda_ms(lambda: M.resize_state(st, 2 * n)),
        "resize_state_cut_ms": cuda_ms(lambda: M.resize_state(big, n)),
        "resizing_defer_ms": cuda_ms(lambda: traffic.resizing_defer(ts,
                                                                    arr)),
        "sizes": {"keys": k, "n_from": n, "n_to": 2 * n,
                  "cap_from": lo.cap, "cap_to": ln.cap, "arrivals": n}}


def resize_counter_1m(modules, device, launches: Launches,
                      card: str) -> None:
    """The counter, allreduce, poll every 2, config3b's deltas
    (``default_rng(0).integers(0, 10, N)``; the default 1..N would wrap
    the int32 KV at 2^21): grow 2^20 -> 2^21 at round 12 under a crash
    [10, 15) of nodes (1, 2); shrink 2^21 -> 2^20 at round 18 under a
    crash [16, 21) of node 1, rows [2^20, 2^21) leaving at round 8;
    ``kv_keys`` 2^20 (the re-homing at a million keys on the card).
    ``ok``: each certified with a bit-exact twin and the re-homing ok.
    Then the resize path's device functions, timed."""
    import numpy as np

    membership, faults, M, kvstore, traffic, counter = modules
    n = RESIZE_COUNTER_N
    kw = dict(mode="allreduce", poll_every=2, kv_keys=n,
              max_recovery_rounds=RESIZE_MRR)
    rec = {"phase": "resize_counter_1m", "card": card, "n": n,
           **kw, "campaigns": {}}
    launches.start()
    runs = (("grow", faults.NemesisSpec(n_nodes=n, seed=3,
                                        crash=((10, 15, (1, 2)),)),
             2 * n, 12),
            ("shrink", faults.NemesisSpec(
                n_nodes=2 * n, seed=5, crash=((16, 21, (1,)),),
                leave=((8, tuple(range(n, 2 * n))),)), n, 18))
    for shape, spec, n_to, r in runs:
        deltas = np.random.default_rng(0).integers(
            0, 10, spec.n_nodes).astype(np.int32)
        res, wall = resize_run(membership, "counter", spec, n_to, r, device,
                               deltas=deltas, **kw)
        rec["campaigns"][shape] = resize_summary(res, wall)
    launches.stop(rec, ("counter_select", "counter_apply"))
    _, spec, n_to, r = runs[0]
    rec["grow_device"] = resize_idle(
        membership, "counter", spec, n_to, r, device,
        rec["campaigns"]["grow"]["wall_s"], deltas=np.random.default_rng(
            0).integers(0, 10, n).astype(np.int32), **kw)
    rec["device_functions"] = resize_device_functions(
        M, kvstore, faults, traffic, counter, device)
    rec["ok"] = all(c["ok"] and c["twin"]["bit_exact"]
                    and c["rehoming"]["ok"]
                    for c in rec["campaigns"].values())
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"resize_counter_1m: {rec}")


def resize_kafka_4k(modules, device, launches: Launches, card: str) -> None:
    """Kafka at ``kafka_nemesis_4k``'s 4,096 nodes: 1,024 keys, capacity
    64, S 2, resync every 4, send 0.7; grow 4,096 -> 6,144 at round 6
    under a crash [4, 9) of nodes (1, 2); shrink 6,144 -> 4,096 at round
    6, rows 4,096-6,143 leaving at round 3.  Certified only (no twin);
    ``ok``: each certified with ``n_allocated >= n_allocated_pre_resize >
    0``."""
    membership, faults = modules
    n, m = RESIZE_KAFKA_N, RESIZE_KAFKA_N * 3 // 2
    rec = {"phase": "resize_kafka_4k", "card": card, "sizes": [n, m],
           "resize_round": 6, **RESIZE_KAFKA_KW,
           "max_recovery_rounds": RESIZE_MRR, "campaigns": {}}
    launches.start()
    runs = (("grow", faults.NemesisSpec(n_nodes=n, seed=7,
                                        crash=((4, 9, (1, 2)),)), m),
            ("shrink", faults.NemesisSpec(n_nodes=m, seed=9,
                                          crash=((4, 9, (1,)),),
                                          leave=((3, tuple(range(n, m))),)),
             n))
    kw = dict(max_recovery_rounds=RESIZE_MRR, **RESIZE_KAFKA_KW)
    for shape, spec, n_to in runs:
        res, wall = resize_run(membership, "kafka", spec, n_to, 6, device,
                               **kw)
        rec["campaigns"][shape] = resize_summary(res, wall)
    launches.stop(rec, ("kafka_merge", "kafka_nem_deliver",
                        "kafka_commit_select", "kafka_commit_apply"))
    _, spec, n_to = runs[0]
    rec["grow_device"] = resize_idle(membership, "kafka", spec, n_to, 6,
                                     device, rec["campaigns"]["grow"]
                                     ["wall_s"], **kw)
    rec["ok"] = all(c["ok"] and c["n_allocated"]
                    >= c["n_allocated_pre_resize"] > 0
                    for c in rec["campaigns"].values())
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"resize_kafka_4k: {rec}")


def frontier_grid_256(modules, device, launches: Launches, card: str,
                      batch_rows: list) -> None:
    """``run_frontier`` over frontier_cartography.py's 256-cell grid (MRR
    12, drain 4, ``n_windows=2``, signatures on) on the card: the report
    validated, every cell's row equal to ``serving_batch_frontier``'s row
    of the same cell; then tests/test_frontier.py:248-271's two cells
    under ``p99_max_rounds = 1``, whose bundles replay on the card and on
    the CPU to the same ``check_slo`` failure."""
    import torch

    frontier, observe, checkers = modules
    cells = frontier.frontier_grid("broadcast", **FRONTIER_GRID)
    rec = {"phase": "frontier_grid_256", "card": card, "cells": len(cells),
           "max_recovery_rounds": 12, "drain_every": 4, "n_windows": 2}
    launches.start()
    t0 = time.perf_counter()
    rep = frontier.run_frontier("broadcast", cells, max_recovery_rounds=12,
                                drain_every=4, n_windows=2, signatures=True,
                                device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    slo_cells = frontier.frontier_grid("broadcast", **SLO_GRID)[:2]
    slo = {"p99_max_rounds": 1}
    bad = frontier.run_frontier("broadcast", slo_cells, slo=slo,
                                max_recovery_rounds=16, drain_every=4,
                                observe_dir=work_dir("frontier"),
                                pipeline=False, device=device)
    launches.stop(rec, ("fault_coins", "faulted_gather_round", "and_fold"))
    observe.validate_frontier(rep)
    observe.validate_frontier(bad)
    MESH_PROV_ONE["frontier"] = strip_frontier(rep)
    differ = [i for i, (row, cell) in enumerate(zip(batch_rows,
                                                    rep["cells"]))
              if any(cell.get(k) != v for k, v in row.items())]
    replays = []
    for b in bad["bundles"]:
        bundle = observe.load_bundle(b["path"])
        got = []
        for dev in (device, "cpu"):
            r = observe.replay_bundle(b["path"], device=dev)
            ok, det = checkers.check_slo(
                r, **bundle["failure"]["slo"],
                coords=bundle["failure"]["grid_coords"])
            got.append((ok, det["problems"],
                        r.get("first_divergence_round")))
        replays.append({"coords": b["coords"], "card_cpu_equal":
                        got[0] == got[1], "fails": not got[0][0],
                        "faithful": got[0][2] is None})
    rec.update(wall_s=wall, cells_per_s=len(cells) / wall,
               n_ok=sum(1 for c in rep["cells"] if c["ok"]),
               n_distinct_signatures=rep["coverage"]["n_distinct"],
               rows_equal_serving_batch=not differ, differ=differ[:8],
               slo_failing=bad["failing"], bundles=len(bad["bundles"]),
               replays=replays)
    rec["ok"] = bool(not differ and len(rep["cells"]) == len(batch_rows)
                     and bad["bundles"] and all(
                         r["card_cpu_equal"] and r["fails"]
                         and r["faithful"] for r in replays))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"frontier_grid_256: {rec}")


def fuzz_summary(res: dict) -> dict:
    """A ``fuzz_run`` result for a phase line: its counts and rates, each
    shrink's weights and verdicts (no rows)."""
    keep = ("n_scenarios", "n_distinct", "n_certified_ok", "n_failing",
            "n_batches", "dispatch_s", "total_s", "scenarios_per_sec",
            "scenarios_per_sec_steady", "n_program_shapes",
            "n_distinct_signatures")
    out = {k: res[k] for k in keep}
    out["shrinks"] = [{k: s[k] for k in (
        "weight_before", "weight_after", "n_candidate_runs",
        "all_components_load_bearing", "replay_same_failure")}
        | {"seed": s["original"]["spec"]["seed"]} for s in res["shrinks"]]
    return out


def fuzz_campaigns(modules, device, launches: Launches, card: str) -> None:
    """benchmarks/fault_sweep.py:684-706 with ``mesh=None`` on the card:
    1,152 broadcast scenarios (24 nodes, batches of 128, horizon 8, MRR
    48, seed 1, the planted failure, two shrinks), the counter (64 at 16
    nodes, MRR 48, seed 2) and Kafka (64 at 16 nodes, MRR 32, seed 3)
    breadth batches, the counter again with the membership axis, and
    frontier_cartography.py:144-195's shape-bucket + pipeline run and
    adaptive run.  ``ok``: the planted seed 424242 shrinks and its
    repro's bundle replays to the same failure on the card and the CPU;
    the bucketed verdicts equal the plain ones; the adaptive run finds
    more distinct signatures than the blind one."""
    fuzz, observe = modules
    out = work_dir("fuzz")
    rec = {"phase": "fuzz_campaigns", "card": card}
    launches.start()
    t0 = time.perf_counter()
    runs = {
        "broadcast": fuzz.fuzz_run(
            "broadcast", 1152, n_nodes=24, batch_size=128, horizon=8,
            max_recovery_rounds=48, seed=1, plant_failure=True,
            max_shrinks=2, observe_dir=out, device=device),
        "counter": fuzz.fuzz_run(
            "counter", 64, n_nodes=16, batch_size=128, horizon=8,
            max_recovery_rounds=48, seed=2, max_shrinks=1, observe_dir=out,
            device=device),
        "kafka": fuzz.fuzz_run(
            "kafka", 64, n_nodes=16, batch_size=128, horizon=8,
            max_recovery_rounds=32, seed=3, max_shrinks=1, observe_dir=out,
            runner_kw=KAFKA_FUZZ_KW, device=device),
        "counter_membership": fuzz.fuzz_run(
            "counter", 64, n_nodes=16, batch_size=128, horizon=8,
            max_recovery_rounds=48, seed=2, membership_axis=True,
            max_shrinks=1, observe_dir=out, device=device)}
    bkw = dict(workload="broadcast", n_scenarios=24, n_nodes=12,
               batch_size=8, horizon=6, max_recovery_rounds=24, seed=7,
               shrink=False, device=device)
    base = fuzz.fuzz_run(**bkw)
    buck = fuzz.fuzz_run(**bkw, shape_buckets=True, pipeline=True)
    akw = dict(workload="counter", n_scenarios=16, n_nodes=12,
               batch_size=4, horizon=8, max_recovery_rounds=24, seed=11,
               shrink=False, device=device)
    blind = fuzz.fuzz_run(**akw, signatures=True)
    adapt = fuzz.fuzz_run(**akw, adapt=True, adapt_oversample=8)
    wall = time.perf_counter() - t0
    launches.stop(rec, ("fault_coins_batched", "faulted_gather_round_batched",
                        "fold_freeze", "counter_select", "kafka_merge"))
    planted = next(s for s in runs["broadcast"]["shrinks"]
                   if s["original"]["spec"]["seed"] == 424242)
    MESH_PROV_ONE["fuzz"] = {
        "rows": [r for r in runs["broadcast"]["rows"] if r["batch"] == 0],
        "planted": {k: v for k, v in planted.items() if k != "bundle"}}
    sig = {k: (tuple(v) if isinstance(v, list) else v)
           for k, v in planted["signature"].items()}
    replays = [observe.replay_bundle(planted["bundle"], device=dev)
               for dev in (device, "cpu")]
    rec.update(
        wall_s=wall, campaigns={k: fuzz_summary(v) for k, v in runs.items()},
        planted={"weight_before": planted["weight_before"],
                 "weight_after": planted["weight_after"],
                 "moves_accepted": planted["moves_accepted"],
                 "all_components_load_bearing":
                     planted["all_components_load_bearing"],
                 "replay_same_failure": planted["replay_same_failure"]},
        planted_replays=[{"ok": r["ok"], "same_failure":
                          fuzz.failure_signature(r) == sig,
                          "first_divergence_round":
                              r.get("first_divergence_round")}
                         for r in replays],
        shape_buckets={"program_shapes": [base["n_program_shapes"],
                                          buck["n_program_shapes"]],
                       "verdicts_identical": all(
                           a["ok"] == b["ok"] and a["spec"] == b["spec"]
                           for a, b in zip(base["rows"], buck["rows"]))},
        adaptive={"blind_distinct": blind["n_distinct_signatures"],
                  "adapt_distinct": adapt["n_distinct_signatures"]})
    rec["ok"] = bool(
        planted["weight_after"] < planted["weight_before"]
        and planted["replay_same_failure"]
        and all(not r["ok"] and r["same_failure"]
                and r["first_divergence_round"] is None
                for r in rec["planted_replays"])
        and replays[0]["lost_writes"] == replays[1]["lost_writes"]
        and rec["shape_buckets"]["verdicts_identical"]
        and buck["n_program_shapes"] <= base["n_program_shapes"]
        and adapt["n_distinct_signatures"]
        > blind["n_distinct_signatures"])
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"fuzz_campaigns: {rec}")


# -- the mesh: 4 ranks on the one card over host-staged gloo ---------------
#
# The card machine has one H100, and NCCL refuses two ranks on one card,
# so the mesh phases run MESH_RANKS processes on it, a gloo group whose
# payloads cross ranks through host memory (Mesh.host_staged); a 1-rank
# NCCL world shows that backend's all-reduce path.  One 4-rank world
# runs every mesh phase's rank side (mesh_rank_work: a world's start-up
# is paid once); the parent builds the kernels before it spawns, so the
# ranks only load them, and it holds each rank result against the
# one-process run on the card and the CPU twin.

MESH_RANKS = 4
MESH_SEED = 19
MESH_TIMEOUT_S = 600.0
# the halo kernels' shard shapes: the main path's (2^20 nodes over 4
# ranks, W = 1) and a wide one
HALO_SHAPES = [(1, N_NODES // MESH_RANKS), (W128_VALUES // 32, 1 << 16)]
# the kernel checks' (w, B, k): small, the thread-tile edges (256 words a
# block: B/k + 1 = 256 for the pack, B = 256 for the round) and the shapes
HALO_CHECKS = ([(w, b, k) for w in (1, 3) for k in (2, 4)
                for b in (k, 12 * k, 255 * k, 256 * k, 257 * k)]
               + [(w, b, 4) for w, b in HALO_SHAPES])
MESH_EXPECT = ("tree_halo_pack", "tree_halo_round", "col_popcount")
MESH_TOPO = (("grid", 4096, {}), ("ring", 128, {}), ("line", 128, {}),
             ("circulant", 4096, {"strides": "expander"}),
             ("tree", 4096, {"branching": 2}))
MESH_SMALL_NODES = 1 << 16


def halo_case(kernels, w: int, b: int, k: int, seed: int, device,
              live: bool):
    """Random operands of the halo kernels: a (w, b) block, the parent
    buffer, the kids' landing buffer, the back column, a received set
    and (``live``) a packed live row."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                             device=device, generator=gen)

    lv = (kernels.pack_bits(torch.rand(b, device=device, generator=gen)
                            < 0.6) if live else None)
    return {"p": rnd((w, b)), "buf": rnd((w, b // k + 1)),
            "ek": rnd((w, b + 1)), "back": rnd((w,)), "rec": rnd((w, b)),
            "live": lv}


def check_halo_kernels(kernels, device) -> dict:
    """max |kernel - plain| of tree_halo_pack and tree_halo_round (both
    forms) over HALO_CHECKS, with and without a live row (0 = bit for
    bit)."""
    import torch

    errs = {"tree_halo_pack": 0, "tree_halo_round": 0}
    for i, (w, b, k) in enumerate(HALO_CHECKS):
        for live in (False, True):
            c = halo_case(kernels, w, b, k, 1000 + i, device, live)
            errs["tree_halo_pack"] = max(
                errs["tree_halo_pack"],
                max_abs_err(kernels.tree_halo_pack(c["p"], k, c["live"]),
                            kernels.tree_halo_pack_plain(c["p"], k,
                                                         c["live"])))
            for back in (None, c["back"]):
                got = kernels.tree_halo_round(c["buf"], c["ek"], back, k,
                                              c["live"])
                want = kernels.tree_halo_round_plain(c["buf"], c["ek"],
                                                     back, k, c["live"])
                errs["tree_halo_round"] = max(errs["tree_halo_round"],
                                              max_abs_err(got, want))
                rec_g, rec_w = c["rec"].clone(), c["rec"].clone()
                nxt_g, nxt_w = torch.empty_like(rec_g), torch.empty_like(
                    rec_w)
                kernels.tree_halo_round(c["buf"], c["ek"], back, k,
                                        c["live"], received=rec_g,
                                        frontier_next=nxt_g)
                kernels.tree_halo_round_plain(c["buf"], c["ek"], back, k,
                                              c["live"], rec_w, nxt_w)
                errs["tree_halo_round"] = max(
                    errs["tree_halo_round"], max_abs_err(rec_g, rec_w),
                    max_abs_err(nxt_g, nxt_w))
    torch.cuda.synchronize()
    return errs


def time_halo_kernels(kernels, device) -> dict:
    """{kernel: {(w, B): timing}} of the halo kernels at HALO_SHAPES (k =
    4): tree_halo_pack, and tree_halo_round's fused form (the flood
    twin's; its inbox form beside it).  Bounds: every input read once,
    every output written once, over HBM's rate."""
    import torch

    out = {"tree_halo_pack": {}, "tree_halo_round": {}}
    k = BRANCHING
    for w, b in HALO_SHAPES:
        c = halo_case(kernels, w, b, k, 7, device, False)
        sub = b // k
        nxt = torch.empty_like(c["rec"])
        pack_bytes = 4 * w * (b + sub + 1)
        out["tree_halo_pack"][(w, b)] = _timed(
            "tree_halo_pack",
            lambda c=c: kernels.tree_halo_pack(c["p"], k),
            lambda c=c: kernels.tree_halo_pack_plain(c["p"], k),
            bound(pack_bytes, 2 * k * w * (sub + 1)))
        rec = c["rec"]
        fused_bytes = 4 * w * ((sub + 1) + (b + 1) + 1 + 3 * b)
        entry = _timed(
            "tree_halo_round",
            lambda c=c, rec=rec, nxt=nxt: kernels.tree_halo_round(
                c["buf"], c["ek"], c["back"], k, received=rec,
                frontier_next=nxt),
            lambda c=c, rec=rec, nxt=nxt: kernels.tree_halo_round_plain(
                c["buf"], c["ek"], c["back"], k, None, rec, nxt),
            bound(fused_bytes, 8 * w * b))
        inbox_bytes = 4 * w * ((sub + 1) + (b + 1) + 1 + b)
        entry.update({
            "form": "fused flood round",
            "inbox_ms": cuda_ms(lambda c=c: kernels.tree_halo_round(
                c["buf"], c["ek"], c["back"], k)),
            "inbox_bound_ms": bound(inbox_bytes, 4 * w * b)[0]})
        out["tree_halo_round"][(w, b)] = entry
    torch.cuda.synchronize()
    return out


def _calls_delta(mesh, before: dict) -> dict:
    return {kind: mesh.calls[kind] - before.get(kind, 0)
            for kind in ("ppermute", "all_reduce", "all_gather")}


def _mesh_collectives_rank(mesh, seed: int) -> dict:
    """Every collective and halo primitive on random operands (made from
    ``seed`` with numpy, the same on every rank); this rank's results."""
    import numpy as np
    import torch

    from gossip_glomers_tpu_torch.tpu_sim import engine

    k, p = mesh.size, mesh.rank
    rows, block, w = 256, 1000, 3
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, (k * rows, 4), dtype=np.uint64).astype(
        np.uint32)
    y = rng.integers(-1 << 40, 1 << 40, (k * rows, 2)).astype(np.int64)
    z = rng.integers(0, 1 << 32, (w, k * block), dtype=np.uint64).astype(
        np.uint32)
    mine = slice(p * rows, (p + 1) * rows)
    dev = mesh.device

    def t(a):
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                else a).to(dev)

    def back(x_):
        a = x_.cpu().numpy()
        return a.view(np.uint32) if a.dtype == np.int32 else a

    coll = engine.collectives(rows, mesh)
    xl, yl = t(x[mine]), t(y[mine])
    out = {}
    before = dict(mesh.calls)
    out["reduce_or"] = back(coll.reduce_or(xl))
    out["reduce_and"] = back(coll.reduce_and(xl))
    out["exclusive_sum"] = back(coll.exclusive_sum(yl))
    out["ladder_calls"] = _calls_delta(mesh, before)
    for name in ("reduce_sum", "reduce_max", "reduce_min"):
        out[name] = back(getattr(coll, name)(yl))
    out["widen"] = back(coll.widen(xl))
    out["row_ids"] = back(coll.row_ids)
    zl = t(z[:, p * block:(p + 1) * block])
    for s in (0, 1, -1, block - 1, -(block - 1), block, block + 3,
              -(block + 3), 2 * block + 1):
        out[("roll", s)] = back(engine.sharded_roll(zl, s, k * block, k,
                                                    mesh))
    for s in (0, 1, -1, block - 1, -(block - 1)):
        out[("shift", s)] = back(engine.sharded_shift(zl, s, k, mesh))
    torch.cuda.synchronize()
    return out


def check_mesh_collectives(ranks: list, seed: int) -> list:
    """Hold the ranks' collectives against their twins on the stitched
    input (numpy); returns the names checked."""
    import numpy as np

    k, rows, block, w = len(ranks), 256, 1000, 3
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, (k * rows, 4), dtype=np.uint64).astype(
        np.uint32)
    y = rng.integers(-1 << 40, 1 << 40, (k * rows, 2)).astype(np.int64)
    z = rng.integers(0, 1 << 32, (w, k * block), dtype=np.uint64).astype(
        np.uint32)
    xb, yb = x.reshape(k, rows, 4), y.reshape(k, rows, 2)
    twins = {
        "reduce_or": [np.bitwise_or.reduce(xb, axis=0)] * k,
        "reduce_and": [np.bitwise_and.reduce(xb, axis=0)] * k,
        "exclusive_sum": [yb[:r].sum(axis=0) for r in range(k)],
        "reduce_sum": [yb.sum(axis=0)] * k,
        "reduce_max": [yb.max(axis=0)] * k,
        "reduce_min": [yb.min(axis=0)] * k,
        "widen": [x] * k,
        "row_ids": [np.arange(r * rows, (r + 1) * rows) for r in range(k)]}
    n = k * block
    for s in (0, 1, -1, block - 1, -(block - 1), block, block + 3,
              -(block + 3), 2 * block + 1):
        full = np.roll(z, s, axis=1)
        twins[("roll", s)] = [full[:, r * block:(r + 1) * block]
                              for r in range(k)]
    for s in (0, 1, -1, block - 1, -(block - 1)):
        idx = np.arange(n) + s
        full = np.where((idx >= 0) & (idx < n),
                        z[:, np.clip(idx, 0, n - 1)], 0)
        twins[("shift", s)] = [full[:, r * block:(r + 1) * block]
                               for r in range(k)]
    for name, want in twins.items():
        for r, rank in enumerate(ranks):
            got = np.asarray(rank[name])
            if got.shape != np.shape(want[r]) or \
                    (got.astype(np.int64) != np.asarray(
                        want[r]).astype(np.int64)).any():
                raise AssertionError(f"mesh_collectives: {name} differs "
                                     f"from its twin on rank {r}")
    for r, rank in enumerate(ranks):
        calls = rank["ladder_calls"]
        if calls["all_gather"] or calls["all_reduce"] or \
                not calls["ppermute"]:
            raise AssertionError(f"mesh_collectives: the OR / AND / prefix "
                                 f"circuits on rank {r} made {calls}")
    return [str(name) for name in twins]


def _tree_run(sim, inject, rounds: int) -> dict:
    """The flood twin's fixed trip (timed) on a staged state."""
    import torch

    state0 = sim.init_state(inject)
    torch.cuda.synchronize()
    if sim.mesh is not None:
        sim.mesh.agree(True)            # start the ranks' clocks together
    t0 = time.perf_counter()
    state = sim.run_staged_fixed(state0, rounds, donate=True)
    torch.cuda.synchronize()
    return {"state": state, "wall_s": time.perf_counter() - t0}


def _mesh_tree_rank(mesh) -> dict:
    """mesh_tree_1m's rank side: the flood twin's fixed trip (warm, then
    timed, its launches and collective calls counted), the
    while-converge run_fused, and the accounted run (server ledger, sync
    waves every 16 rounds)."""
    import torch

    from gossip_glomers_tpu_torch.tpu_sim import broadcast, kernels, timing

    n, nv = N_NODES, W1_VALUES
    inject = broadcast.make_inject(n, nv)
    rounds = timing.discover_rounds("tree", n, nv)
    sim = timing.structured_sim("tree", n, nv, mesh=mesh)
    if sim.build_fixed(rounds, donate=True) is None:
        raise AssertionError("mesh_tree_1m: no flood twin on the mesh")
    _tree_run(sim, inject, rounds)                       # warm
    kernels.reset_launches()
    before = dict(mesh.calls)
    run = _tree_run(sim, inject, rounds)
    out = {"rounds": rounds, "wall_s": run["wall_s"],
           "fixed_launches": dict(kernels.LAUNCHES),
           "fixed_calls": _calls_delta(mesh, before),
           "fixed_msgs": int(run["state"].msgs),
           "fixed_received": sim.received_node_major(run["state"])}
    del run
    kernels.reset_launches()
    before = dict(mesh.calls)
    t0 = time.perf_counter()
    state, rounds_f = sim.run_fused(inject)
    torch.cuda.synchronize()
    out.update({"fused_rounds": rounds_f,
                "fused_wall_s": time.perf_counter() - t0,
                "fused_launches": dict(kernels.LAUNCHES),
                "fused_calls": _calls_delta(mesh, before),
                "fused_msgs": int(state.msgs)})
    del state
    acct = timing.structured_sim("tree", n, nv, sync_every=16,
                                 srv_ledger=True, mesh=mesh)
    kernels.reset_launches()
    before = dict(mesh.calls)
    t0 = time.perf_counter()
    state, rounds_a = acct.run_fused(inject)
    torch.cuda.synchronize()
    out.update({"acct_rounds": rounds_a,
                "acct_wall_s": time.perf_counter() - t0,
                "acct_launches": dict(kernels.LAUNCHES),
                "acct_calls": _calls_delta(mesh, before),
                "acct_msgs": int(state.msgs),
                "acct_srv": acct.server_msgs(state),
                "acct_received": acct.received_node_major(state),
                "halo": acct.sharded_exchange is not None})
    if mesh.rank:
        for key in ("fixed_received", "acct_received"):
            out[key] = None                 # rank 0 brings the sets back
    return out


def _mesh_topo_sims(broadcast, timing, topology, mesh, device):
    """(name, sim, inject) of mesh_topologies' runs, on ``mesh`` or (None)
    on one device."""
    one = device if mesh is None else None
    cases = []
    for topo, n, kw in MESH_TOPO:
        if kw.get("strides") == "expander":
            kw = {"strides": topology.expander_strides(n, DEGREE, seed=0)}
        sim = timing.structured_sim(topo, n, W1_VALUES, sync_every=16,
                                    srv_ledger=True, mesh=mesh,
                                    device=one, **kw)
        cases.append((f"{topo}_{n}", sim,
                      broadcast.make_inject(n, W1_VALUES)))
    n = MESH_SMALL_NODES
    strides = topology.expander_strides(n, DEGREE, seed=0)
    parts, _ = config4c_parts(broadcast, n)
    cases.append((f"circulant_partitioned_{n}", timing.structured_sim(
        "circulant", n, W1_VALUES, sync_every=16, srv_ledger=True,
        parts=parts, mesh=mesh, device=one,
        strides=strides), broadcast.make_inject(n, W1_VALUES)))
    cases.append((f"random_regular_gather_{n}", broadcast.BroadcastSim(
        topology.random_regular(n, DEGREE, seed=0), n_values=W1_VALUES,
        sync_every=4, mesh=mesh, device=one),
        broadcast.make_inject(n, W1_VALUES)))
    return cases


def _mesh_topo_rank(mesh) -> dict:
    import torch

    from gossip_glomers_tpu_torch.parallel import topology
    from gossip_glomers_tpu_torch.tpu_sim import broadcast, kernels, timing

    out = {}
    for name, sim, inject in _mesh_topo_sims(broadcast, timing, topology,
                                             mesh, None):
        kernels.reset_launches()
        before = dict(mesh.calls)
        t0 = time.perf_counter()
        state, rounds = sim.run_fused(inject)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls = _calls_delta(mesh, before)
        halo = (sim.words_major and (
            sim._faulted.sharded_exchange is not None
            if sim._faulted is not None
            else sim.sharded_exchange is not None))
        out[name] = {"rounds": rounds, "wall_s": wall, "calls": calls,
                     "launches": {k: v for k, v in kernels.LAUNCHES.items()
                                  if v},
                     "msgs": int(state.msgs),
                     "srv": (None if state.srv_msgs is None
                             else int(state.srv_msgs)),
                     "path": ("halo" if halo else "all-gather widen"),
                     # a collective read: every rank takes part
                     "received": sim.received_node_major(state)}
        if mesh.rank:
            out[name]["received"] = None    # rank 0 brings it back
    return out


# -- the faulted, delayed and counter paths on the mesh ----------------------
#
# Each configuration below is one an earlier phase ran in one process on
# the card (kept in ONE_PROCESS by that phase); the ranks run it over the
# halo closures (or the gather path's all-gathers) and the parent holds
# every rank's rounds, ledgers and rank 0's gathered state against it.

# the one-process card runs the mesh phases are held against, kept by the
# phases that ran them
ONE_PROCESS: dict = {}
# the kernels the new mesh paths launch on the ranks: each must show in
# the mesh bucket of its launches_by_path
MESH_PATH_KERNELS = ("wm_fault_coins", "tree_halo_pack", "tree_halo_round",
                     "fault_coins", "faulted_gather_round", "gather_or",
                     "counter_select", "counter_apply", "kafka_merge",
                     "kafka_nem_deliver", "kafka_commit_select",
                     "kafka_commit_apply")
# the gather ring's graph on the mesh: config 4b's law at 2^16 nodes
MESH_RING_NODES = 1 << 16


def keep_run(name: str, sim, state) -> None:
    ONE_PROCESS[name] = {"rounds": state.t, "msgs": int(state.msgs),
                         "srv": (None if state.srv_msgs is None
                                 else int(state.srv_msgs)),
                         "received": sim.received_node_major(state)}


def keep_counter(name: str, sim, state) -> None:
    ONE_PROCESS[name] = {
        "rounds": state.t, "kv": int(state.kv), "msgs": int(state.msgs),
        "pending": state.pending.cpu().numpy(), "cached": sim.reads(state),
        "vals": None if state.rows is None else state.rows.vals.cpu()
        .numpy()}


def _mesh_run(mesh, sim, inject, rounds: int) -> dict:
    """One broadcast configuration on the ranks, for the ``rounds`` its
    one-process card run took to converge: the fixed trip of ``rounds -
    1`` rounds timed (its launches and collective calls counted), not
    converged there, then one more round, converged: so the mesh run
    converges in exactly ``rounds``.  Its ledgers and the gathered
    received set (which rank 0 keeps) come back."""
    import torch

    from gossip_glomers_tpu_torch.tpu_sim import kernels

    state0, target = sim.stage(inject)
    mesh.agree(True)                    # start the ranks' clocks together
    kernels.reset_launches()
    before = dict(mesh.calls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = sim.run_staged_fixed(state0, rounds - 1, donate=True)
    torch.cuda.synchronize()
    out = {"wall_s": time.perf_counter() - t0, "trip_rounds": rounds - 1,
           "launches": dict(kernels.LAUNCHES),
           "calls": _calls_delta(mesh, before)}
    early = sim.converged(state, target)
    state = sim.step(state)
    out.update({"rounds": state.t if sim.converged(state, target) and not
                early else None, "msgs": int(state.msgs),
                "srv": (None if state.srv_msgs is None
                        else int(state.srv_msgs)),
                "received": sim.received_node_major(state)})
    if mesh.rank:
        out["received"] = None          # rank 0 brings the set back
    return out


def _mesh_nemesis_rank(mesh, rounds: dict) -> dict:
    """mesh_tree_1m_nemesis's rank side: w1_tree_nemesis's plan on the
    2^20-node tree, then with dir_delays (1, 3), then the loss-only
    accounted circulant under config 4c's window, each over the bundle's
    halo closures."""
    from gossip_glomers_tpu_torch.parallel import topology
    from gossip_glomers_tpu_torch.tpu_sim import (broadcast, faults,
                                                  structured)

    n, dev, k = N_NODES, str(mesh.device), mesh.size
    inject = broadcast.make_inject(n, W1_VALUES)
    spec = tree_nemesis_spec(faults, n)
    tree_nbrs = topology.to_padded_neighbors(topology.tree(n, BRANCHING))
    out = {}
    for name, dd in (("tree_nemesis", None), ("tree_nemesis_delayed",
                                              (1, 3))):
        sim = broadcast.BroadcastSim(
            tree_nbrs, n_values=W1_VALUES, sync_every=8, srv_ledger=False,
            fault_plan=spec.compile(dev),
            exchange=structured.make_exchange("tree", n),
            nemesis=structured.make_nemesis("tree", n, spec, dir_delays=dd,
                                            n_shards=k, device=dev),
            mesh=mesh)
        out[name] = dict(_mesh_run(mesh, sim, inject, rounds[name]),
                         halo=sim._halo)
        del sim
    strides = topology.expander_strides(n, DEGREE, seed=0)
    parts, group = config4c_parts(broadcast, n)
    spec = loss_only_spec(faults, n)
    sim = broadcast.BroadcastSim(
        topology.circulant(n, strides), n_values=W1_VALUES, sync_every=16,
        parts=parts.to(dev), fault_plan=spec.compile(dev),
        exchange=structured.make_exchange("circulant", n, strides=strides),
        nemesis=structured.make_nemesis("circulant", n, spec, groups=group,
                                        n_shards=k, device=dev,
                                        strides=strides), mesh=mesh)
    out["circulant_nemesis_accounted"] = dict(
        _mesh_run(mesh, sim, inject, rounds["circulant_nemesis_accounted"]),
        halo=sim._halo)
    return out


def ring_delays(nbrs):
    """config4d's law over an (N, D) table: ``default_rng(11).choice([1,
    3], p=[0.7, 0.3])`` an edge (pad slots drawn too, never read)."""
    import numpy as np

    return np.random.default_rng(11).choice(
        [1, 3], nbrs.shape, p=[0.7, 0.3]).astype(np.int32)


def ring_sim(broadcast, topology, mesh=None, device=None):
    """mesh_delays' gather ring: config 4d's law on random_regular(2^16,
    8, 0), the server ledger on, sync waves every 16 rounds."""
    nbrs = topology.random_regular(MESH_RING_NODES, DEGREE, seed=0)
    return broadcast.BroadcastSim(
        nbrs, n_values=W1_VALUES, sync_every=16, delays=ring_delays(nbrs),
        mesh=mesh, device=device)


def _mesh_delays_rank(mesh, rounds: dict) -> dict:
    """mesh_delays' rank side: config 4d's per-edge delays on the 2^20
    circulant through make_delayed, make_edge_delayed and, under config
    4c's window, make_edge_delayed_faulted (their halo closures); the
    gather ring on the 2^16-node random regular graph."""
    from gossip_glomers_tpu_torch.parallel import topology
    from gossip_glomers_tpu_torch.tpu_sim import broadcast, structured

    n, k = N_NODES, mesh.size
    inject = broadcast.make_inject(n, W1_VALUES)
    strides = topology.expander_strides(n, DEGREE, seed=0)
    circ, ckw = topology.circulant(n, strides), {"strides": strides}
    rows, rng = delay_rows(2 * len(strides), n)
    dd = tuple(int(x) for x in
               rng.choice([1, 3], size=2 * len(strides), p=[0.7, 0.3]))
    ex = structured.make_exchange("circulant", n, **ckw)
    kw = dict(n_values=W1_VALUES, sync_every=1 << 20, srv_ledger=False,
              exchange=ex, mesh=mesh)
    out = {}
    sim = broadcast.BroadcastSim(circ, delayed=structured.make_delayed(
        "circulant", n, dd, n_shards=k, **ckw), **kw)
    out["circulant_delayed"] = _mesh_run(mesh, sim, inject,
                                         rounds["circulant_delayed"])
    sim = broadcast.BroadcastSim(circ, edge_delayed=structured
                                 .make_edge_delayed("circulant", n, rows,
                                                    n_shards=k, **ckw), **kw)
    out["circulant_edge_delayed"] = _mesh_run(
        mesh, sim, inject, rounds["circulant_edge_delayed"])
    parts, group = config4c_parts(broadcast, n)
    sim = broadcast.BroadcastSim(
        circ, n_values=W1_VALUES, sync_every=16, parts=parts.to(
            mesh.device), exchange=ex,
        edge_delayed=structured.make_edge_delayed_faulted(
            "circulant", n, rows, group, n_shards=k, **ckw), mesh=mesh)
    out["circulant_edge_delayed_partitioned"] = _mesh_run(
        mesh, sim, inject, rounds["circulant_edge_delayed_partitioned"])
    del sim
    out["ring"] = _mesh_run(mesh, ring_sim(broadcast, topology, mesh),
                            broadcast.make_inject(MESH_RING_NODES,
                                                  W1_VALUES),
                            rounds["ring"])
    return out


def _mesh_gather_rank(mesh, rounds: dict) -> dict:
    """mesh_gather_nemesis' rank side: w1_random_regular_nemesis's plan
    on random_regular(2^20, 8, 0), materialized and in slabs of 2^16
    rows."""
    from gossip_glomers_tpu_torch.parallel import topology
    from gossip_glomers_tpu_torch.tpu_sim import broadcast, faults

    n = N_NODES
    nbrs = topology.random_regular(n, DEGREE, seed=0)
    spec = nemesis_spec(faults, n, dup=True)
    inject = broadcast.make_inject(n, W1_VALUES)
    out = {}
    for ub in ("materialized", 1 << 16):
        sim = broadcast.BroadcastSim(
            nbrs, n_values=W1_VALUES, sync_every=4, srv_ledger=False,
            fault_plan=spec.compile(str(mesh.device)), union_block=ub,
            mesh=mesh)
        out[str(ub)] = dict(_mesh_run(
            mesh, sim, inject, rounds["random_regular_nemesis"]),
            block=sim._ub)
        del sim
    return out


def _rank0_profile(mesh, run, rounds: int, k: int = 8) -> dict | None:
    """Rank 0's torch.profiler view of one more ``run()`` of ``rounds``
    rounds, which every rank makes (its collectives need them all; only
    rank 0 profiles, so only its process is slowed): the wall, the
    device's busy time and spans, the ``k`` device span kinds
    (:func:`top_spans`) and host operations (by self CPU time: [name, ms
    a round, calls a round]) that took the most, each a round.  None on
    the other ranks."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    mesh.agree(True)
    torch.cuda.synchronize()
    if mesh.rank:
        run()
        torch.cuda.synchronize()
        return None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [{"name": e.name, "us": e.time_range.end - e.time_range.start}
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    return {"wall_ms_per_round": wall * 1e3 / rounds,
            "device_busy_ms_per_round": sum(x["us"] for x in dev)
            / 1e3 / rounds,
            "device_spans_per_round": len(dev) / rounds,
            "top_device": top_spans(dev, rounds, k),
            "top_host": [[a.key[:90], a.self_cpu_time_total / 1e3 / rounds,
                          a.count / rounds] for a in host[:k]]}


def _counter_run(mesh, sim, state0, rounds: int) -> dict:
    """One counter configuration on the ranks: ``rounds`` rounds from
    ``state0`` (``run`` leaves it whole) three times.  The first gives
    the gathered state and its wall (``cold_wall_s``: it carries each
    rank process's first launches of the configuration's torch kernels,
    which cost seconds with four processes on one card); the second is
    timed with its launches and collective calls counted; rank 0
    profiles the third (:func:`_rank0_profile`)."""
    import torch

    from gossip_glomers_tpu_torch.tpu_sim import kernels

    def timed():
        mesh.agree(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = sim.run(state0, rounds)
        torch.cuda.synchronize()
        return st, time.perf_counter() - t0

    st, cold = timed()
    kernels.reset_launches()
    before = dict(mesh.calls)
    _, wall = timed()
    out = {"wall_s": wall, "cold_wall_s": cold,
           "launches": dict(kernels.LAUNCHES),
           "calls": _calls_delta(mesh, before), "rounds": st.t,
           "kv": int(st.kv), "msgs": int(st.msgs),
           "pending": mesh.all_gather(st.pending).cpu().numpy(),
           "cached": sim.reads(st),
           "vals": None if st.rows is None else mesh.all_gather(
               st.rows.vals).cpu().numpy(),
           "profile": _rank0_profile(mesh, lambda: sim.run(state0, rounds),
                                     rounds)}
    if mesh.rank:
        out.update(pending=None, cached=None, vals=None)
    return out


def _mesh_counter_rank(mesh, rounds: dict) -> dict:
    """mesh_counter's rank side: counter_1m_partitioned's,
    counter_16m_cas_wide's and counter_nemesis_device_kv's
    configurations, each for the rounds its one-process run took."""
    import numpy as np

    from gossip_glomers_tpu_torch.tpu_sim import counter, faults

    out = {}
    n = COUNTER_3B_NODES
    deltas = np.random.default_rng(0).integers(0, 10, n).astype(np.int32)
    blocked = np.zeros((1, n), bool)
    blocked[0, : n // 2] = True
    sim = counter.CounterSim(
        n, mode="allreduce", poll_every=2, mesh=mesh,
        kv_sched=counter.KVReach.from_numpy([0], [8], blocked))
    out["counter_1m_partitioned"] = _counter_run(
        mesh, sim, sim.add(sim.init_state(), deltas),
        rounds["counter_1m_partitioned"])
    n = COUNTER_3C_NODES
    deltas = np.random.default_rng(0).integers(1, 10, n).astype(np.int32)
    sim = counter.CounterSim(n, mode="cas", poll_every=4, mesh=mesh)
    out["counter_16m_cas_wide"] = dict(_counter_run(
        mesh, sim, sim.add(sim.init_state(), deltas),
        rounds["counter_16m_cas_wide"]), wide=sim._wide)
    del sim, deltas
    n = COUNTER_NEMESIS_NODES
    spec = counter_nemesis_spec(faults, n)
    deltas = np.random.default_rng(0).integers(0, 10, n).astype(np.int32)
    for way, kw in COUNTER_NEMESIS_WAYS.items():
        sim = counter.CounterSim(n, poll_every=2, kv_backend="device",
                                 fault_plan=spec.compile(str(mesh.device)),
                                 mesh=mesh, **kw)
        name = f"counter_nemesis_device_kv_{way}"
        out[name] = _counter_run(mesh, sim, sim.add(sim.init_state(),
                                                    deltas), rounds[name])
    return out


# -- mesh_kafka: Kafka, ids and echo on the ranks ---------------------------

# kafka_node_sweep's 131,072-node row (K = N / 16, capacity 64, one
# round-robin send a node, 2 + 2 rounds); kafka_nemesis_4k's campaign
# (KAFKA_NEMESIS, 12 staged rounds with commits, resync every 4, then the
# one-process run's quiet rounds to convergence, at most 48) four ways;
# kafka_faulted_1k's 4,096-node point (KAFKA_FAULTED[1]) as the matmul
# oracle
MESH_KAFKA_UNION = (131072, 8192, 64)
MESH_KAFKA_STAGED = 12
MESH_KAFKA_MAX_QUIET = 48
MESH_KAFKA_WAYS = {
    "pull_blocked": dict(union_block=512),
    "pull_materialized": dict(union_block="materialized"),
    "push_blocked": dict(resync_mode="push", union_block=512),
    "pull_device_kv": dict(kv_backend="device", kv_amnesia=True)}
MESH_KAFKA_RUNS = ("union",) + tuple(MESH_KAFKA_WAYS) + ("matmul_oracle",)
# the runs whose round widens only the sends' packed metadata, or (the
# matmul oracle) gathers the own words: exactly one all-gather a round;
# every other run makes none
MESH_KAFKA_GATHERS = ("pull_materialized", "pull_device_kv",
                      "matmul_oracle")
MESH_KAFKA_EXPECT = ("kafka_merge", "kafka_nem_deliver",
                     "kafka_commit_select", "kafka_commit_apply")
# each configuration's one-process card run: its digests by rank block
# and whole, its rounds and quiet rounds (mesh_kafka_one_process)
KAFKA_ONE: dict = {}
# dcn_worker's digest weights: word i of a field weighs i * MUL + ADD
DIGEST_MUL, DIGEST_ADD = 2654435761, 0x9E3779B9
MASK32 = 0xFFFFFFFF


def mul32(a, b):
    """a * b mod 2^32 for int64 tensors (or ints) in [0, 2^32), by 16-bit
    halves of b, so no product leaves int64."""
    return ((a * (b & 0xFFFF)) + (((a * (b >> 16)) & 0xFFFF) << 16)) \
        & MASK32


def card_digest(x, offset: int) -> int:
    """:func:`dcn_worker.digest_array` of the 4-byte words of ``x`` as
    words ``offset ..`` of a larger array, on the card in chunks: the
    position-weighted sum mod 2^32, so a field's digest is the sum of
    its blocks' (a rank's block at its rows' global offset)."""
    import torch

    words = x.reshape(-1)
    total, step = 0, 1 << 26
    for lo in range(0, words.numel(), step):
        w = words[lo:lo + step].to(torch.int64) & MASK32
        i = torch.arange(offset + lo, offset + lo + w.numel(),
                         dtype=torch.int64, device=w.device) & MASK32
        total += int(mul32(w, (mul32(i, DIGEST_MUL) + DIGEST_ADD)
                           & MASK32).sum())
    return total & MASK32


def kafka_digests(st, row0: int, rows: int | None = None) -> dict:
    """A Kafka state's digests: the replicated ``log_vals`` and ``kv_val``
    whole; the node-axis fields (and the device KV's rows) over the rows
    ``[row0, row0 + rows)`` of a whole state, or (``rows`` None) over the
    state's own rows taken as the block from global row ``row0``."""
    def d(x):
        if rows is not None:
            x = x[row0:row0 + rows]
        return card_digest(x, row0 * (x[0].numel() if x.shape[0] else 0))

    out = {"log_vals": card_digest(st.log_vals, 0),
           "kv_val": card_digest(st.kv_val, 0), "present": d(st.present),
           "local_committed": d(st.local_committed),
           "origin_bits": d(st.origin_bits), "t": st.t,
           "msgs": int(st.msgs)}
    if st.rows is not None:
        out.update(rows_vals=d(st.rows.vals), rows_vers=d(st.rows.vers))
    return out


def mesh_kafka_sim(name: str, device, mesh=None):
    """mesh_kafka's configuration ``name``: its sim (on the mesh, or in one
    process on ``device``) and its staged operands, the full (R, N, S) /
    (R, N, K) numpy batches every rank cuts its block from."""
    import numpy as np

    from gossip_glomers_tpu_torch.harness import nemesis
    from gossip_glomers_tpu_torch.tpu_sim import faults, kafka

    place = dict(mesh=mesh) if mesh is not None else dict(device=device)
    dev = str(device if mesh is None else mesh.device)
    if name == "union":
        n, k, c = MESH_KAFKA_UNION
        sks = np.tile((np.arange(n, dtype=np.int32) % k)[None, :, None],
                      (2, 1, 1))
        svs = np.random.default_rng(n).integers(0, 1 << 20, (2, n, 1)) \
            .astype(np.int32)
        return kafka.KafkaSim(n, k, c, max_sends=1, **place), (sks, svs,
                                                                None)
    if name == "matmul_oracle":
        n, k, c, s, _, _, _, seed = KAFKA_FAULTED[1]
        spec = faults.NemesisSpec(
            n_nodes=n, seed=seed, crash=((1, 3, tuple(range(0, n, 97))),),
            loss_rate=0.1, loss_until=3)
        rng = np.random.default_rng(seed)
        sks = rng.integers(0, k, (2, n, s)).astype(np.int32)
        svs = rng.integers(0, 1 << 20, (2, n, s)).astype(np.int32)
        return kafka.KafkaSim(n, k, c, max_sends=s, repl_fast=False,
                              fault_plan=spec.compile(dev), **place), \
            (sks, svs, None)
    n, k, c, s = KAFKA_NEMESIS
    spec = faults.random_spec(n, seed=2, horizon=12, n_crash_windows=1,
                              loss_rate=0.1)
    ops = nemesis.stage_kafka_ops(spec, MESH_KAFKA_STAGED, n_keys=k,
                                  max_sends=s)
    return kafka.KafkaSim(n, k, c, max_sends=s, resync_every=4,
                          fault_plan=spec.compile(dev), **place,
                          **MESH_KAFKA_WAYS[name]), ops


def mesh_kafka_trip(name: str, sim, ops, quiet: int):
    """The configuration's run from a fresh state: the union's two
    ``run_fused`` calls of 2 rounds, the oracle's one; a campaign's staged
    rounds with commits, then ``quiet`` rounds with no op."""
    import numpy as np

    sks, svs, crs = ops
    st = sim.run_fused(sim.init_state(), sks, svs, crs)
    if name == "union":
        st = sim.run_fused(st, sks, svs)
    if quiet:
        empty = np.full((quiet,) + sks.shape[1:], -1, np.int32)
        st = sim.run_fused(st, empty, np.zeros_like(empty))
    return st


def mesh_kafka_one_process(device) -> None:
    """Each mesh_kafka configuration (and the ids / echo runs) in one
    process on the card: a campaign's quiet rounds counted one at a time
    until every node's presence agrees (at most 48); the digests by rank
    block and whole kept in :data:`KAFKA_ONE`."""
    import numpy as np
    import torch

    for name in MESH_KAFKA_RUNS:
        sim, ops = mesh_kafka_sim(name, device)
        st = mesh_kafka_trip(name, sim, ops, 0)
        quiet = 0
        if name in MESH_KAFKA_WAYS:
            one = np.full((1,) + ops[0].shape[1:], -1, np.int32)
            while not bool((st.present == st.present[:1]).all()):
                if quiet == MESH_KAFKA_MAX_QUIET:
                    raise AssertionError(f"mesh_kafka {name}: no "
                                         "convergence in 48 quiet rounds")
                st = sim.run_fused(st, one, np.zeros_like(one))
                quiet += 1
        b = sim.n_nodes // MESH_RANKS
        KAFKA_ONE[name] = {
            "rounds": st.t, "quiet": quiet, "msgs": int(st.msgs),
            "whole": kafka_digests(st, 0),
            "blocks": [kafka_digests(st, r * b, b)
                       for r in range(MESH_RANKS)]}
        del sim, st
        torch.cuda.empty_cache()
    KAFKA_ONE["ids_echo"] = ids_echo_digests(None, device)


def ids_echo_digests(mesh, device) -> dict:
    """ids_echo's runs (``UniqueIdsSim(2^20, max_per_round=32)`` 4 rounds,
    then ``EchoSim(2^20)`` with 4 slots 3 rounds, ``default_rng(0)``) as
    digests: on a mesh this rank's block, in one process each rank's
    block; with the rounds, the ledger and the collectives made."""
    import numpy as np

    from gossip_glomers_tpu_torch.tpu_sim import echo, unique_ids

    n, g, slots = IDS_ECHO_NODES, 32, 4
    place = dict(mesh=mesh) if mesh is not None else dict(device=device)
    p = MESH_RANKS if mesh is None else 1
    b = n // MESH_RANKS
    r0 = 0 if mesh is None else mesh.rank * b

    def blocks(x, width):
        if mesh is not None:
            return [card_digest(x, r0 * width)]
        return [card_digest(x[r * b:(r + 1) * b], r * b * width)
                for r in range(p)]

    before = {} if mesh is None else dict(mesh.calls)
    rng = np.random.default_rng(0)
    sim = unique_ids.UniqueIdsSim(n, max_per_round=g, **place)
    st = sim.init_state()
    ids = []
    for _ in range(4):
        st, got = sim.step(st, rng.integers(0, g + 1, n).astype(np.int32))
        ids.append(blocks(got, g * 3))
    esim = echo.EchoSim(n, **place)
    es, reps = esim.init_state(), []
    for _ in range(3):
        payload = rng.integers(-2**31, 2**31, (n, slots)).astype(np.int32)
        valid = rng.random((n, slots)) < 0.5
        es, rep = esim.step(es, payload, valid)
        reps.append(blocks(rep, slots))
    return {"ids": ids, "minted": blocks(st.minted, 1), "t": st.t,
            "echo": reps, "echo_t": es.t, "echo_msgs": int(es.msgs),
            "calls": {} if mesh is None else _calls_delta(mesh, before)}


def _mesh_kafka_rank(mesh, rounds: dict) -> dict:
    """mesh_kafka's rank side: each configuration's trip twice from a
    fresh state (the first cold; the second timed, its launches and
    collective calls counted), the state's digests over this rank's
    block; then ids and echo."""
    import torch

    from gossip_glomers_tpu_torch.tpu_sim import kernels

    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    out = {}
    for name in MESH_KAFKA_RUNS:
        sim, ops = mesh_kafka_sim(name, mesh.device, mesh)
        quiet = rounds[f"kafka_quiet_{name}"]

        def trip():
            mesh.agree(True)
            torch.cuda.synchronize()
            kernels.reset_launches()
            before = dict(mesh.calls)
            t0 = time.perf_counter()
            st = mesh_kafka_trip(name, sim, ops, quiet)
            torch.cuda.synchronize()
            return (st, time.perf_counter() - t0, _calls_delta(mesh, before),
                    dict(kernels.LAUNCHES))

        _, cold, _, _ = trip()
        st, wall, calls, launched = trip()
        out[name] = {"wall_s": wall, "cold_wall_s": cold, "calls": calls,
                     "launches": launched, "rounds": st.t,
                     "path": sim._repl_mode(None), "ub": sim._ub,
                     "digest": kafka_digests(st, mesh.rank * sim._block)}
        del sim, st
        torch.cuda.empty_cache()
    out["ids_echo"] = ids_echo_digests(mesh, mesh.device)
    out["seconds"] = time.perf_counter() - t_start
    return out


def nccl_kafka(mesh) -> dict:
    """The 1-rank NCCL world's Kafka run: the pull campaign in slabs of 512
    (its collectives all-reduces only), digested whole."""
    import torch

    name = "pull_blocked"
    sim, ops = mesh_kafka_sim(name, mesh.device, mesh)
    before = dict(mesh.calls)
    st = mesh_kafka_trip(name, sim, ops, KAFKA_ONE[name]["quiet"])
    torch.cuda.synchronize()
    return {"rounds": st.t, "calls": _calls_delta(mesh, before),
            "digest": kafka_digests(st, 0)}


def mesh_kafka_phase(ranks: list, launches: Launches, head: dict,
                     nccl: dict, world_s: float) -> None:
    """mesh_kafka (module docstring): every rank's digests of every run
    against its block of the one-process card run's state
    (:data:`KAFKA_ONE`), the census (no all-gather but the materialized
    union's metadata widen and the oracle's own words, one a round), the
    matmul oracle's one-process run against its CPU twin, and the 1-rank
    NCCL run against the one-process run whole."""
    import torch

    rec = {"phase": "mesh_kafka", **head, "runs": {}}
    counts = []
    for name in MESH_KAFKA_RUNS:
        one = KAFKA_ONE[name]
        per = [r["kafka"][name] for r in ranks]
        for r, x in enumerate(per):
            if x["digest"] != one["blocks"][r]:
                raise AssertionError(
                    f"mesh_kafka {name}: rank {r}'s state {x['digest']} vs "
                    f"its block of the one-process card run "
                    f"{one['blocks'][r]}")
        x = per[0]
        rounds = x["rounds"]
        gathers = x["calls"]["all_gather"]
        want = rounds if name in MESH_KAFKA_GATHERS else 0
        if gathers != want or any(y["calls"] != x["calls"] for y in per):
            raise AssertionError(f"mesh_kafka {name}: {gathers} all-gathers "
                                 f"in {rounds} rounds (want {want}), or the "
                                 "ranks' calls differ")
        walls = [y["wall_s"] for y in per]
        rec["runs"][name] = {
            "rounds": rounds, "quiet_rounds": one["quiet"],
            "msgs": x["digest"]["msgs"], "path": x["path"],
            "union_block": x["ub"] if x["path"] == "union_nem" else None,
            "wall_ms": max(walls) * 1e3,
            "ms_per_round": max(walls) * 1e3 / rounds,
            "cold_wall_ms": max(y["cold_wall_s"] for y in per) * 1e3,
            "collective_calls_per_round": _per_round(x["calls"], rounds),
            "launches_per_round_by_rank": [_per_round(y["launches"], rounds)
                                           for y in per],
            "equals_one_process_card_run": True}
        counts += [y["launches"] for y in per]
    launches.add_ranks(rec, counts, MESH_KAFKA_EXPECT)
    # ids and echo: every rank's block of every round
    one = KAFKA_ONE["ids_echo"]
    for r, rk in enumerate(ranks):
        x = rk["kafka"]["ids_echo"]
        if not (x["ids"] == [[d[r]] for d in one["ids"]]
                and x["minted"] == [one["minted"][r]]
                and x["echo"] == [[d[r]] for d in one["echo"]]
                and (x["t"], x["echo_t"], x["echo_msgs"])
                == (one["t"], one["echo_t"], one["echo_msgs"])
                and not any(x["calls"].values())):
            raise AssertionError(f"mesh_kafka ids_echo: rank {r} differs "
                                 "from the one-process card run, or made "
                                 "a collective")
    rec["ids_echo"] = {"n": IDS_ECHO_NODES, "max_per_round": 32,
                       "rounds": one["t"], "echo_rounds": one["echo_t"],
                       "echo_msgs": one["echo_msgs"], "collectives": 0,
                       "equals_one_process_card_run": True}
    # the matmul oracle's CPU twin
    t0 = time.perf_counter()
    sim, ops = mesh_kafka_sim("matmul_oracle", "cpu")
    st = mesh_kafka_trip("matmul_oracle", sim, ops, 0)
    b = sim.n_nodes // MESH_RANKS
    if [kafka_digests(st, r * b, b) for r in range(MESH_RANKS)] \
            != KAFKA_ONE["matmul_oracle"]["blocks"]:
        raise AssertionError("mesh_kafka: the matmul oracle's one-process "
                             "card run differs from its CPU twin")
    rec["cpu_twin"] = {"matmul_oracle": True,
                       "seconds": time.perf_counter() - t0,
                       "campaign_ways": "kafka_nemesis_4k holds the pull "
                                        "and push campaigns and the device "
                                        "KV's against the CPU"}
    del sim, st
    if nccl["digest"] != KAFKA_ONE["pull_blocked"]["whole"] or set(
            k for k, v in nccl["calls"].items() if v) != {"all_reduce"}:
        raise AssertionError(f"mesh_kafka: the 1-rank NCCL run {nccl} "
                             "differs from the no-mesh run, or made a "
                             "collective other than an all-reduce")
    rec["nccl_one_rank"] = {"run": "pull_blocked", "rounds": nccl["rounds"],
                            "calls": nccl["calls"],
                            "equals_no_mesh_run": True}
    rec.update(
        n=MESH_KAFKA_UNION[0], campaign_nodes=KAFKA_NEMESIS[0],
        rank_seconds=max(r["kafka"]["seconds"] for r in ranks),
        world_seconds=world_s, one_process_seconds=KAFKA_ONE["seconds"],
        census_reference={
            "kafka/sharded-step-union": {"all-reduce": 13,
                                         "collective-permute": 6},
            "kafka/sharded-step-union-nem-blocked": {
                "all-reduce": 14, "collective-permute": 27},
            "kafka/sharded-step-union-nem-materialized": {
                "all-gather": 3, "all-reduce": 14,
                "collective-permute": 6},
            "kafka/sharded-step-matmul-oracle": {
                "all-gather": 1, "all-reduce": 13,
                "collective-permute": 3}},
        ok=True)
    emit(rec)
    torch.cuda.empty_cache()


# -- mesh_txn_serving: txn and open-loop serving on the ranks ----------------

# run_txn_nemesis on the mesh: txn_64k's workload at 4,096 nodes (the key
# ratio kept) under txn_nemesis_64k's plan law at this size
MESH_TXN_NEM = (4096, 1024)
# run_serving on the mesh: the serving phases' configurations at one rate
MESH_SERVING = (("serving_counter_64k", 0.3), ("serving_kafka_64k", 0.3),
                ("serving_broadcast_64k", 0.1))
MESH_TXN_EXPECT = ("txn_claim", "txn_commit", "counter_select",
                   "counter_apply", "kafka_merge", "and_fold",
                   "tree_halo_pack", "tree_halo_round")
# the kernels this phase adds to the mesh bucket of launches_by_path
MESH_TXN_KERNELS = ("txn_claim", "txn_commit", "and_fold")
# txn_64k's one-process card state (digests by rank block and whole, its
# rounds) and the serving phases' one-process rows and replayed series,
# which mesh_txn_serving is held against; the ranks' and the NCCL world's
# results, kept until those runs exist
TXN_ONE: dict = {}
SERVING_ONE: dict = {}
MESH_TXN: dict = {}


def txn_kw() -> dict:
    return dict(txns_per_node=TXN_T, ops_per_txn=TXN_O, rate=TXN_RATE,
                until=TXN_UNTIL, workload_seed=0)


def txn_digests(st, row0: int, rows: int | None = None) -> dict:
    """A txn state's digests: every node-axis field (and the store's rows)
    over the rows ``[row0, row0 + rows)`` of a whole state, or (``rows``
    None) over the state's own rows taken as the block from global row
    ``row0``; ``t`` and ``msgs``."""
    def d(x):
        if rows is not None:
            x = x[row0:row0 + rows]
        return card_digest(x, row0 * (x[0].numel() if x.shape[0] else 0))

    out = {f: d(getattr(st, f)) for f in (
        "arrived", "cur", "issue", "issue_round", "commit_round", "op_ver",
        "op_val")}
    out.update(rows_vals=d(st.rows.vals), rows_vers=d(st.rows.vers),
               t=st.t, msgs=int(st.msgs))
    return out


def txn_trip(sim, mesh=None) -> tuple:
    """txn_64k's rounds on ``sim``: stepped until every offered
    transaction commits (at or past the arrivals' end; the flag agreed
    over the mesh), at most :data:`TXN_MAX_RECOVERY` past it."""
    st = sim.init_state()

    def done(s) -> bool:
        ok = bool((s.cur >= s.arrived).all())
        return ok if mesh is None else mesh.agree(ok)

    while not (st.t >= TXN_UNTIL and done(st)) \
            and st.t < TXN_UNTIL + TXN_MAX_RECOVERY:
        st = sim.run_fused(st, 1)
    return st, st.t


def serving_config(name: str):
    """A serving phase's (kind, traffic kwargs, rates, sim kwargs at the
    widths its sim was built with)."""
    from gossip_glomers_tpu_torch.harness import serving
    from gossip_glomers_tpu_torch.tpu_sim import traffic

    for nm, kind, tkw, rates, sim_kw, _ in SERVING_PHASES:
        if nm == name:
            spec = traffic.TrafficSpec(**tkw).with_rate(float(max(rates)))
            kw = dict(sim_kw, **serving.serving_widths(kind, spec, sim_kw))
            return kind, tkw, rates, kw
    raise KeyError(name)


def serving_fields(row: dict) -> dict:
    """The fields of a serving row that a mesh run must equal."""
    out = {k: row[k] for k in (
        "ok", "completed", "msgs_total", "lat_p50", "lat_p99", "lat_max",
        "n_lost_writes", "total_rounds", "in_flight", "arrived", "issued",
        "deferred")}
    return out


def _mesh_txn_serving_rank(mesh, txn_ops) -> dict:
    """mesh_txn_serving's rank side: txn_64k stepped to convergence, then
    its fixed trip timed (launches and collective calls counted); the two
    txn campaigns; the three serving runs with telemetry on (launches and
    calls counted around each run)."""
    import torch

    from gossip_glomers_tpu_torch.harness import serving
    from gossip_glomers_tpu_torch.harness import txn as htxn
    from gossip_glomers_tpu_torch.tpu_sim import (faults, kernels, kvstore,
                                                  traffic, txn)

    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    out = {}
    sim = txn.TxnSim(TXN_NODES, TXN_KEYS, mesh=mesh, ops=txn_ops, **txn_kw())
    t0 = time.perf_counter()
    st, rounds = txn_trip(sim, mesh)
    step_s = time.perf_counter() - t0
    stepped = txn_digests(st, mesh.rank * sim._block)
    del st
    mesh.agree(True)
    torch.cuda.synchronize()
    kernels.reset_launches()
    before = dict(mesh.calls)
    t0 = time.perf_counter()
    st = sim.run_fused(sim.init_state(), rounds)
    torch.cuda.synchronize()
    out["txn_64k"] = {"rounds": rounds, "wall_s": time.perf_counter() - t0,
                      "step_s": step_s, "calls": _calls_delta(mesh, before),
                      "launches": dict(kernels.LAUNCHES),
                      "stepped": stepped,
                      "digest": txn_digests(st, mesh.rank * sim._block)}
    del sim, st
    torch.cuda.empty_cache()
    n, k = MESH_TXN_NEM
    kw = dict(n_keys=k, txns_per_node=TXN_T, ops_per_txn=TXN_O,
              rate=TXN_RATE, until=TXN_UNTIL,
              max_recovery_rounds=TXN_MAX_RECOVERY)
    for name, amnesia in (("nemesis", False), ("nemesis_amnesia", True)):
        spec = txn_nemesis_spec(faults, kvstore, n, amnesia)
        kernels.reset_launches()
        before = dict(mesh.calls)
        t0 = time.perf_counter()
        res = htxn.run_txn_nemesis(spec, kv_amnesia=amnesia, mesh=mesh,
                                   **kw)
        out[name] = {"result": res, "wall_s": time.perf_counter() - t0,
                     "calls": _calls_delta(mesh, before),
                     "launches": dict(kernels.LAUNCHES)}
    for name, rate in MESH_SERVING:
        kind, tkw, _, sim_kw = serving_config(name)
        tspec = traffic.TrafficSpec(**tkw).with_rate(rate)
        mesh.agree(True)
        kernels.reset_launches()
        before = dict(mesh.calls)
        row = serving.run_serving(kind, tspec, mesh=mesh, sim_kw=sim_kw,
                                  telemetry=True)
        out[name] = {"fields": serving_fields(row), "mesh": row["mesh"],
                     "series": row["telemetry"]["series"],
                     "telemetry_ok": not row["telemetry"]["check"][
                         "problems"],
                     "wall_s": row["total_s"], "driven_s": row["driven_s"],
                     "calls": _calls_delta(mesh, before),
                     "launches": dict(kernels.LAUNCHES)}
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_start
    return out


def nccl_txn(mesh, txn_ops) -> dict:
    """The 1-rank NCCL world's txn_64k run to convergence (all-reduces
    only), digested whole."""
    import torch

    from gossip_glomers_tpu_torch.tpu_sim import txn

    sim = txn.TxnSim(TXN_NODES, TXN_KEYS, mesh=mesh, ops=txn_ops, **txn_kw())
    before = dict(mesh.calls)
    st, rounds = txn_trip(sim, mesh)
    torch.cuda.synchronize()
    out = {"rounds": rounds, "calls": _calls_delta(mesh, before),
           "digest": txn_digests(st, 0)}
    del sim, st
    torch.cuda.empty_cache()
    return out


def mesh_txn_serving_phase(htxn, faults, kvstore, launches: Launches,
                           device, card: str) -> None:
    """mesh_txn_serving (module docstring): the ranks' runs, kept by
    :func:`mesh_phases`, against ``txn_64k``'s one-process card state
    (:data:`TXN_ONE`), the txn campaigns' one-process card runs (made
    here), the serving phases' rows and replayed series
    (:data:`SERVING_ONE`), and the 1-rank NCCL run against the no-mesh
    run."""
    import torch

    ranks, head = MESH_TXN["ranks"], MESH_TXN["head"]
    rec = {"phase": "mesh_txn_serving", **head, "runs": {}}
    counts = []
    # txn_64k: every rank's block, stepped and as the timed trip
    per = [r["txn_64k"] for r in ranks]
    for r, x in enumerate(per):
        want = TXN_ONE["blocks"][r]
        if not (x["rounds"] == TXN_ONE["rounds"] and x["stepped"] == want
                and x["digest"] == want):
            raise AssertionError(f"mesh_txn_serving txn_64k: rank {r}'s "
                                 f"state {x['digest']} vs its block of the "
                                 f"one-process card run {want}")
        if set(k for k, v in x["calls"].items() if v) != {"all_reduce"} \
                or x["calls"]["all_reduce"] != 3 * x["rounds"]:
            raise AssertionError(f"mesh_txn_serving txn_64k: rank {r}'s "
                                 f"calls {x['calls']}, not three "
                                 "all-reduces a round")
    x = per[0]
    walls = [y["wall_s"] for y in per]
    rec["runs"]["txn_64k"] = {
        "n": TXN_NODES, "keys": TXN_KEYS, "rounds": x["rounds"],
        "msgs": x["digest"]["msgs"], "wall_ms": max(walls) * 1e3,
        "ms_per_round": max(walls) * 1e3 / x["rounds"],
        "stepped_s": max(y["step_s"] for y in per),
        "collective_calls_per_round": _per_round(x["calls"], x["rounds"]),
        "launches_per_round_by_rank": [_per_round(y["launches"], x["rounds"])
                                       for y in per],
        "ops_staged": "once in the parent, shipped in the spawn arguments",
        "equals_one_process_card_run": True}
    counts += [y["launches"] for y in per]
    # the txn campaigns against their one-process card runs
    n, k = MESH_TXN_NEM
    kw = dict(n_keys=k, txns_per_node=TXN_T, ops_per_txn=TXN_O,
              rate=TXN_RATE, until=TXN_UNTIL,
              max_recovery_rounds=TXN_MAX_RECOVERY)
    t0 = time.perf_counter()
    for name, amnesia in (("nemesis", False), ("nemesis_amnesia", True)):
        spec = txn_nemesis_spec(faults, kvstore, n, amnesia)
        want = htxn.run_txn_nemesis(spec, kv_amnesia=amnesia, device=device,
                                    **kw)
        per = [r[name] for r in ranks]
        for r, y in enumerate(per):
            if y["result"] != want:
                diff = [key for key in want
                        if y["result"].get(key) != want[key]]
                raise AssertionError(f"mesh_txn_serving {name}: rank {r}'s "
                                     f"result differs in {diff}")
        res = per[0]["result"]
        lost = [q for q in res["serializability"]["problems"]
                if q["kind"] in ("lost-update", "lost-acked-commit")]
        if amnesia == res["ok"] or (amnesia and not (
                lost and all(q["txns"] for q in lost))) or (
                not amnesia and res["n_lost_writes"]):
            raise AssertionError(f"mesh_txn_serving {name}: ok "
                                 f"{res['ok']}, lost {lost[:2]}")
        rounds = res["converged_round"] or res["clear_round"]
        walls = [y["wall_s"] for y in per]
        rec["runs"][name] = {
            "n": n, "keys": k, "ok": res["ok"],
            "clear_round": res["clear_round"],
            "converged_round": res["converged_round"],
            "n_committed": res["n_committed"],
            "msgs_total": res["msgs_total"],
            "by_kind": res["serializability"]["by_kind"],
            "lost_named": lost[:2], "wall_ms": max(walls) * 1e3,
            "collective_calls_per_round": _per_round(per[0]["calls"],
                                                     rounds),
            "launches_by_rank": [{k: v for k, v in y["launches"].items()
                                  if v} for y in per],
            "collectives_note": "the all-gathers are the certificate's "
                                "collective reads of the history",
            "equals_one_process_card_run": True}
        counts += [y["launches"] for y in per]
    rec["txn_one_process_s"] = time.perf_counter() - t0
    # the serving runs against the serving phases' rows and replays
    for name, rate in MESH_SERVING:
        one = SERVING_ONE[(name, rate)]
        per = [r[name] for r in ranks]
        for r, y in enumerate(per):
            if y["fields"] != one["fields"] or y["series"] != one["series"]:
                diff = [key for key in one["fields"]
                        if y["fields"][key] != one["fields"][key]]
                raise AssertionError(
                    f"mesh_txn_serving {name}: rank {r} differs from the "
                    f"one-process card row in {diff} or its telemetry")
            if y["calls"].get("all_gather") or y["mesh"] != MESH_RANKS:
                raise AssertionError(f"mesh_txn_serving {name}: rank {r}'s "
                                     f"calls {y['calls']}")
        y = per[0]
        rounds = y["fields"]["total_rounds"]
        walls = [z["wall_s"] for z in per]
        rec["runs"][name] = {
            "rate": rate, **y["fields"], "telemetry_ok": y["telemetry_ok"],
            "wall_ms": max(walls) * 1e3,
            "ms_per_round": max(walls) * 1e3 / rounds,
            "driven_ms": max(z["driven_s"] for z in per) * 1e3,
            "collective_calls_per_round": _per_round(y["calls"], rounds),
            "launches_per_round_by_rank": [_per_round(z["launches"], rounds)
                                           for z in per],
            "no_all_gather": True, "equals_one_process_card_run": True}
        counts += [z["launches"] for z in per]
    launches.add_ranks(rec, counts, MESH_TXN_EXPECT)
    for name in MESH_TXN_KERNELS:
        if not launches.split(name)["mesh"]:
            raise AssertionError(f"{name}: no launch in the mesh bucket")
    nccl = MESH_TXN["nccl"]
    if nccl["digest"] != TXN_ONE["whole"] or set(
            k for k, v in nccl["calls"].items() if v) != {"all_reduce"}:
        raise AssertionError(f"mesh_txn_serving: the 1-rank NCCL run "
                             f"{nccl} differs from the no-mesh run, or made "
                             "a collective other than an all-reduce")
    rec["nccl_one_rank"] = {"run": "txn_64k", "rounds": nccl["rounds"],
                            "calls": nccl["calls"],
                            "equals_no_mesh_run": True}
    rec.update(rank_seconds=max(r["seconds"] for r in ranks),
               census_reference={"txn/sharded-step": {"all-reduce": None}},
               ok=True)
    emit(rec)
    torch.cuda.empty_cache()


# -- provenance and scenario batches on the mesh ---------------------------
#
# mesh_provenance_batches: its ranks run in the mesh world
# (_mesh_prov_batches_rank); the parent holds them, after fuzz_campaigns,
# against the one-process card runs the earlier phases keep here
# (MESH_PROV_ONE), and against one-process card runs it makes itself (the
# replayed bundle's, the txn frontier's).
MESH_PROV_ONE: dict = {}
MESH_PROV: dict = {}
# the tree campaign's census trips: the campaign's rounds, plain and with
# the record, on the mesh sim
MESH_PROV_EXPECT = ("prov_attribute", "fault_coins", "faulted_gather_round",
                    "fault_coins_batched", "faulted_gather_round_batched",
                    "fold_freeze", "counter_select", "counter_apply",
                    "kafka_merge", "kafka_nem_deliver", "txn_claim",
                    "txn_commit", "and_fold")
# the counter census trip's rounds
MESH_PROV_COUNTER_ROUNDS = 12
# the replayed bundle: a one-process card campaign under the tree plan at
# 4,096 nodes, provenance and telemetry on, no recovery budget (it fails)
MESH_REPLAY_NODES = 4096
# the mesh fuzz campaign: fuzz_campaigns' broadcast run cut to its first
# batch (the planted seed is its scenario 0), one shrink
MESH_FUZZ_S = 128
# the txn frontier: 8 crash + loss specs at 64 nodes, two rates
MESH_TXN_FRONTIER = dict(n_keys=16, txns_per_node=4, until=8,
                         max_recovery_rounds=64)
MESH_TXN_FRONTIER_RATES = (0.3, 0.7)


def txn_frontier_specs(faults) -> list:
    return [faults.random_spec(64, seed=s, horizon=8, n_crash_windows=1,
                               loss_rate=0.1) for s in range(8)]


def array_digest(arrays: dict) -> dict:
    """{field: sha256 of its int32 bytes}: a record whole, small."""
    import hashlib

    import numpy as np

    return {k: hashlib.sha256(np.ascontiguousarray(
        np.asarray(v, np.int32)).tobytes()).hexdigest()
        for k, v in sorted(arrays.items())}


def prov_result(res: dict) -> dict:
    """A nemesis runner's result with its provenance arrays replaced by
    their digests (the rest as it is)."""
    out = dict(res)
    if "provenance" in out:
        entry = dict(out["provenance"])
        entry["arrays"] = array_digest(entry["arrays"])
        out["provenance"] = entry
    return out


def row_blocks(x, shards: int) -> list:
    """:func:`card_digest` of each of ``shards`` row blocks of a
    node-major tensor, at its global offset."""
    b = x.shape[0] // shards
    width = x[0].numel()
    return [card_digest(x[r * b:(r + 1) * b], r * b * width)
            for r in range(shards)]


def _counted(mesh, fn):
    """``(result, seconds, collective calls, launches)`` of ``fn()`` on a
    rank, its clock started with the others'."""
    import torch

    from gossip_glomers_tpu_torch.tpu_sim import kernels

    mesh.agree(True)
    torch.cuda.synchronize()
    kernels.reset_launches()
    before = dict(mesh.calls)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, _calls_delta(mesh, before),
            dict(kernels.LAUNCHES))


def _mesh_prov_batches_rank(mesh, args: dict) -> dict:
    """mesh_provenance_batches's rank side (module docstring): the three
    provenance runs and their census trips, the one-hop wide batch, the
    looped batches, the frontier, the fuzz campaign, the replay and the
    txn frontier on the mesh."""
    import numpy as np
    import torch

    from gossip_glomers_tpu_torch.harness import frontier, fuzz, nemesis
    from gossip_glomers_tpu_torch.harness import observe
    from gossip_glomers_tpu_torch.harness import txn as htxn
    from gossip_glomers_tpu_torch.parallel import topology
    from gossip_glomers_tpu_torch.tpu_sim import (broadcast, counter,
                                                  faults, kafka)
    from gossip_glomers_tpu_torch.tpu_sim import provenance as PV
    from gossip_glomers_tpu_torch.tpu_sim import scenario

    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    out = {}
    # the main path's tree under the provenance campaign's plan, each
    # host certificate this rank runs timed (rank 0 alone certifies)
    n = N_NODES
    spec = tree_nemesis_spec(faults, n)
    certify_s = []
    real_check = nemesis.check_provenance

    def timed_check(*a, **kw):
        t0 = time.perf_counter()
        verdict = real_check(*a, **kw)
        certify_s.append(time.perf_counter() - t0)
        return verdict

    nemesis.check_provenance = timed_check
    try:
        res, wall, calls, launched = _counted(
            mesh, lambda: nemesis.run_broadcast_nemesis(
                spec, n_values=PROV_VALUES, topology="tree", sync_every=8,
                telemetry=True, provenance=True, mesh=mesh))
    finally:
        nemesis.check_provenance = real_check
    out["tree"] = {"result": prov_result(res), "wall_s": wall,
                   "calls": calls, "launches": launched,
                   "certify_s": certify_s}
    rounds = res["converged_round"]
    del res
    sim = tree_prov_sim(broadcast, topology, faults, n, None, mesh=mesh)
    inject = broadcast.make_inject(n, PROV_VALUES)
    psp = PV.ProvenanceSpec("broadcast")
    st, wall, calls, launched = _counted(
        mesh, lambda: sim.run_staged_fixed(sim.init_state(inject), rounds,
                                           donate=True))
    plain = {"wall_s": wall, "calls": calls, "launches": launched,
             "received": card_digest(st.received,
                                     mesh.rank * st.received.numel())}
    del st
    (st, prov), wall, calls, launched = _counted(
        mesh, lambda: sim.run_observed(
            sim.init_state(inject), None, None, rounds, donate=True,
            prov=sim.provenance_state(psp, inject), prov_spec=psp))
    out["tree_trips"] = {
        "rounds": rounds, "plain": plain,
        "observed": {"wall_s": wall, "calls": calls, "launches": launched,
                     "received": card_digest(
                         st.received, mesh.rank * st.received.numel())}}
    del sim, st, prov
    torch.cuda.empty_cache()
    # the counter campaign and its census trips
    cn = COUNTER_NEMESIS_NODES
    cspec = counter_nemesis_spec(faults, cn)
    deltas = np.random.default_rng(0).integers(0, 10, cn).astype(np.int32)
    res, wall, calls, launched = _counted(
        mesh, lambda: nemesis.run_counter_nemesis(
            cspec, mode="allreduce", deltas=deltas,
            union_block=COUNTER_PROV_BLOCK, telemetry=True, provenance=True,
            mesh=mesh))
    out["counter"] = {"result": prov_result(res), "wall_s": wall,
                      "calls": calls, "launches": launched}
    csim = counter.CounterSim(cn, mode="allreduce",
                              fault_plan=cspec.compile(mesh.device),
                              union_block=COUNTER_PROV_BLOCK, mesh=mesh)
    cpsp = PV.ProvenanceSpec("counter")
    r = MESH_PROV_COUNTER_ROUNDS
    _, _, c_plain, _ = _counted(mesh, lambda: csim.run_fused(
        csim.add(csim.init_state(), deltas), r))
    _, _, c_obs, _ = _counted(mesh, lambda: csim.run_observed(
        csim.add(csim.init_state(), deltas), None, None, r, donate=True,
        prov=csim.provenance_state(cpsp), prov_spec=cpsp))
    out["counter_trips"] = {"rounds": r, "plain": c_plain, "observed": c_obs}
    del csim
    # the Kafka sweep point
    kn, k, cap, sends, block, kr = KAFKA_PROV_POINT
    kspec = faults.NemesisSpec(n_nodes=kn, seed=5,
                               crash=((0, kr, tuple(range(0, kn, 97))),),
                               loss_rate=0.1, loss_until=kr)
    sks, svs, _ = nemesis.stage_kafka_ops(kspec, kr, n_keys=k,
                                          max_sends=sends, workload_seed=0,
                                          commits=False)
    ksim = kafka.KafkaSim(kn, k, cap, max_sends=sends,
                          fault_plan=kspec.compile(mesh.device),
                          resync_every=4, union_block=block, mesh=mesh)
    kpsp = PV.ProvenanceSpec("kafka")
    kst, k_wall_plain, k_plain, _ = _counted(
        mesh, lambda: ksim.run_rounds(ksim.init_state(), sks, svs))
    plain_digest = kafka_digests(kst, ksim._row0)
    del kst
    (kst, kprov), k_wall, k_obs, k_launched = _counted(
        mesh, lambda: ksim.run_observed(
            ksim.init_state(), None, None, sks, svs,
            prov=ksim.provenance_state(kpsp), prov_spec=kpsp))
    out["kafka"] = {"rounds": kr, "plain": plain_digest,
                    "observed": kafka_digests(kst, ksim._row0),
                    "prov": array_digest(PV.arrays_of(kprov)),
                    "wall_s_plain": k_wall_plain, "wall_s": k_wall,
                    "calls_plain": k_plain, "calls": k_obs,
                    "launches": k_launched}
    del ksim, kst, kprov
    torch.cuda.empty_cache()
    # the wide one-hop batch: 256 scenarios, 64 a rank
    batch = wide_batch(scenario, faults, topology)
    one_hop = dataclasses.replace(batch, scenarios=tuple(
        dataclasses.replace(sc, delays=None) for sc in batch.scenarios))
    handle, trip_s, trip_calls, trip = _counted(
        mesh, lambda: scenario.dispatch_scenario_batch(one_hop, mesh=mesh))
    rows, collect_s, collect_calls, _ = _counted(
        mesh, lambda: scenario.collect_scenario_batch(handle)["scenarios"])
    out["wide"] = {"rows": rows, "rounds": handle["rounds"],
                   "local_scenarios": handle["s_count"],
                   "trip_s": trip_s, "collect_s": collect_s,
                   "trip_calls": trip_calls, "collect_calls": collect_calls,
                   "launches": trip}
    del handle, batch, one_hop
    torch.cuda.empty_cache()
    # the looped batches
    for name, wl, seed, kw, mrr in (
            ("scenario_counter_fuzz", "counter", 2,
             {"mode": "cas", "poll_every": 2}, 48),
            ("scenario_kafka_fuzz", "kafka", 3, KAFKA_FUZZ_KW, 32),
            ("scenario_txn", "txn", 4, None, None)):
        if wl == "txn":
            cells = fuzz.sample_scenarios("txn", TXN_FUZZ_S,
                                          n_nodes=TXN_FUZZ_N, seed=seed,
                                          horizon=LOOP_HORIZON)
            lb = scenario.ScenarioBatch(workload="txn",
                                        scenarios=tuple(cells))
        else:
            cells = fuzz.sample_scenarios(wl, LOOP_S, n_nodes=LOOP_N,
                                          seed=seed, horizon=LOOP_HORIZON)
            lb = scenario.ScenarioBatch(workload=wl, scenarios=tuple(cells),
                                        runner_kw=kw,
                                        max_recovery_rounds=mrr)
        res, wall, calls, launched = _counted(
            mesh, lambda: scenario.run_scenario_batch(lb, mesh=mesh))
        out[name] = {"rows": res["scenarios"], "wall_s": wall,
                     "calls": calls, "launches": launched,
                     "trips": res["trips"]}
    # the 256-cell frontier, 64 cells a rank
    cells = frontier.frontier_grid("broadcast", **FRONTIER_GRID)
    rep, wall, calls, launched = _counted(
        mesh, lambda: frontier.run_frontier(
            "broadcast", cells, max_recovery_rounds=12, drain_every=4,
            n_windows=2, signatures=True, mesh=mesh))
    out["frontier"] = {"report": strip_frontier(rep), "wall_s": wall,
                       "calls": calls, "launches": launched}
    # fuzz_campaigns' first broadcast batch, the planted seed shrunk on
    # the mesh (its candidate runs, bundle and replay collective)
    res, wall, calls, launched = _counted(
        mesh, lambda: fuzz.fuzz_run(
            "broadcast", MESH_FUZZ_S, n_nodes=24, batch_size=128, horizon=8,
            max_recovery_rounds=48, seed=1, plant_failure=True,
            max_shrinks=1, observe_dir=args["fuzz_dir"], mesh=mesh))
    out["fuzz"] = {"rows": res["rows"],
                   "planted": {k: v for k, v in res["shrinks"][0].items()
                               if k != "bundle"},
                   "bundle": os.path.basename(res["shrinks"][0]["bundle"]),
                   "wall_s": wall, "calls": calls, "launches": launched}
    # a one-process card run's bundle, replayed on the mesh
    res, wall, calls, launched = _counted(
        mesh, lambda: observe.replay_bundle(args["bundle"], mesh=mesh))
    out["replay"] = {"result": prov_result(res), "wall_s": wall,
                     "calls": calls, "launches": launched}
    # the txn frontier: 8 specs a rate, 2 a rank
    res, wall, calls, launched = _counted(
        mesh, lambda: htxn.run_txn_frontier(
            MESH_TXN_FRONTIER_RATES, txn_frontier_specs(faults), mesh=mesh,
            **MESH_TXN_FRONTIER))
    out["txn_frontier"] = {"result": res, "wall_s": wall, "calls": calls,
                           "launches": launched}
    out["seconds"] = time.perf_counter() - t_start
    return out


def mesh_prov_setup(device) -> dict:
    """Before the world: the bundle its ranks replay, written by a
    one-process card campaign (:data:`MESH_REPLAY_NODES` nodes under the
    tree plan, provenance and telemetry on, no recovery budget), whose
    result is kept; the fuzz campaign's directory, which every rank sees
    (one file system: the ranks agree on each bundle's name, rank 0
    writes it)."""
    from gossip_glomers_tpu_torch.harness import nemesis
    from gossip_glomers_tpu_torch.tpu_sim import faults

    t0 = time.perf_counter()
    res = nemesis.run_broadcast_nemesis(
        tree_nemesis_spec(faults, MESH_REPLAY_NODES), n_values=PROV_VALUES,
        topology="tree", sync_every=8, telemetry=True, provenance=True,
        max_recovery_rounds=0, observe_dir=work_dir("mesh_replay"),
        device=device)
    path = res.pop("flight_bundle")
    MESH_PROV_ONE["replay_source"] = prov_result(res)
    MESH_PROV["setup_s"] = time.perf_counter() - t0
    return {"bundle": path, "fuzz_dir": work_dir("mesh_fuzz")}


def mesh_provenance_batches_phase(modules, launches: Launches, device,
                                  card: str) -> None:
    """mesh_provenance_batches (module docstring): the ranks' runs, kept
    by :func:`mesh_phases`, against the one-process card runs the earlier
    phases kept (:data:`MESH_PROV_ONE`) and those made here (the replay
    of the same bundle, the txn frontier); the census of each."""
    import torch

    htxn, observe, faults = modules
    ranks, head = MESH_PROV["ranks"], MESH_PROV["head"]
    rec = {"phase": "mesh_provenance_batches", **head,
           "setup_s": MESH_PROV["setup_s"], "runs": {}}
    one = MESH_PROV_ONE
    counts = []

    def held(name: str, got: list, want, what: str = "result") -> None:
        for r, x in enumerate(got):
            if x != want:
                diff = ([k for k in want if x.get(k) != want.get(k)]
                        if isinstance(want, dict) else "rows")
                raise AssertionError(f"mesh_provenance_batches {name}: "
                                     f"rank {r}'s {what} differs from the "
                                     f"one-process card run in {diff}")

    def calls_only(calls: dict, kinds) -> bool:
        return all(not v or k in kinds for k, v in calls.items())

    def nonzero(calls: dict) -> dict:
        return {k: v for k, v in calls.items() if v}

    # the tree campaign: result, stamps' digests, received blocks, census
    per = [r["tree"] for r in ranks]
    held("tree", [x["result"] for x in per], one["tree"]["result"])
    trips = [r["tree_trips"] for r in ranks]
    rounds = one["tree"]["rounds"]
    for r, x in enumerate(trips):
        want = one["tree"]["blocks"][r]
        if not (x["rounds"] == rounds and x["plain"]["received"] == want
                and x["observed"]["received"] == want):
            raise AssertionError(f"mesh_provenance_batches tree: rank {r}'s "
                                 "received block differs")
        if x["observed"]["calls"] != x["plain"]["calls"]:
            raise AssertionError(
                f"mesh_provenance_batches tree: rank {r}'s record added "
                f"collectives: {x['observed']['calls']} vs "
                f"{x['plain']['calls']}")
        if x["observed"]["launches"].get("prov_attribute") != rounds:
            raise AssertionError(f"mesh_provenance_batches tree: rank {r} "
                                 "did not stamp with the kernel each round")
    if [len(x["certify_s"]) for x in per] != [1] + [0] * (MESH_RANKS - 1):
        raise AssertionError("mesh_provenance_batches tree: the host "
                             "certificate ran other than once, on rank 0")
    res = per[0]["result"]
    walls = [x["wall_s"] for x in per]
    rec["runs"]["tree_1m"] = {
        "n": N_NODES, "n_values": PROV_VALUES, "rounds": rounds,
        "msgs_total": res["msgs_total"], "ok": res["ok"],
        "provenance_problems": res["provenance"]["check"]["problems"][:3],
        "stamp_digests": res["provenance"]["arrays"],
        "wall_ms_by_rank": [w * 1e3 for w in walls],
        "certified_by": "rank 0, verdict shared",
        "certify_s_by_rank": [x["certify_s"] for x in per],
        "trip_ms_plain": max(x["plain"]["wall_s"] for x in trips) * 1e3,
        "trip_ms_observed": max(x["observed"]["wall_s"]
                                for x in trips) * 1e3,
        "collective_calls_per_round": _per_round(
            trips[0]["observed"]["calls"], rounds),
        "collective_calls_per_round_plain": _per_round(
            trips[0]["plain"]["calls"], rounds),
        "launches_per_round_rank0": _per_round(
            trips[0]["observed"]["launches"], rounds),
        "campaign_calls_rank0": per[0]["calls"],
        "equals_one_process_card_run": True}
    counts += [x["launches"] for x in per]
    counts += [x["observed"]["launches"] for x in trips]
    # the counter campaign: one all-reduce more a round
    per = [r["counter"] for r in ranks]
    held("counter", [x["result"] for x in per], one["counter"])
    for r, x in enumerate(r["counter_trips"] for r in ranks):
        extra = {k: x["observed"].get(k, 0) - x["plain"].get(k, 0)
                 for k in set(x["observed"]) | set(x["plain"])}
        if {k: v for k, v in extra.items() if v} != {
                "all_reduce": x["rounds"]}:
            raise AssertionError(f"mesh_provenance_batches counter: rank "
                                 f"{r}'s record added {extra}, not one "
                                 "all-reduce a round")
    res = per[0]["result"]
    rec["runs"]["counter_128k"] = {
        "n": COUNTER_NEMESIS_NODES, "ok": res["ok"],
        "converged_round": res["converged_round"], "kv": res["kv"],
        "msgs_total": res["msgs_total"],
        "wall_ms_by_rank": [x["wall_s"] * 1e3 for x in per],
        "record_extra_calls_per_round": {"all_reduce": 1},
        "equals_one_process_card_run": True}
    counts += [x["launches"] for x in per]
    # the Kafka point: each rank's block, the whole record, <= 2 more
    per = [r["kafka"] for r in ranks]
    for r, x in enumerate(per):
        want = one["kafka"]["blocks"][r]
        if not (x["plain"] == want and x["observed"] == want
                and x["prov"] == one["kafka"]["prov"]):
            raise AssertionError(f"mesh_provenance_batches kafka: rank {r} "
                                 "differs from its block of the "
                                 "one-process card run")
        extra = {k: x["calls"].get(k, 0) - x["calls_plain"].get(k, 0)
                 for k in set(x["calls"]) | set(x["calls_plain"])}
        if not (calls_only(extra, ("all_reduce",))
                and 0 < extra.get("all_reduce", 0) <= 2 * x["rounds"]):
            raise AssertionError(f"mesh_provenance_batches kafka: rank {r}'s "
                                 f"record added {extra}")
    rec["runs"]["kafka_point"] = {
        "point": list(KAFKA_PROV_POINT), "msgs": per[0]["observed"]["msgs"],
        "wall_ms_plain": max(x["wall_s_plain"] for x in per) * 1e3,
        "wall_ms_observed": max(x["wall_s"] for x in per) * 1e3,
        "record_extra_calls": {k: per[0]["calls"].get(k, 0)
                               - per[0]["calls_plain"].get(k, 0)
                               for k in per[0]["calls"]},
        "equals_one_process_card_run": True}
    counts += [x["launches"] for x in per]
    # the wide one-hop batch: rows, launches a round, no collective in
    # the trip and one gather at collect
    per = [r["wide"] for r in ranks]
    held("wide", [x["rows"] for x in per], one["wide"]["rows"], "rows")
    for r, x in enumerate(per):
        want = fold_launches(None, x["rounds"])
        got = {k: x["launches"].get(k, 0) for k in want}
        if got != want or x["rounds"] != one["wide"]["rounds"]:
            raise AssertionError(f"mesh_provenance_batches wide: rank {r} "
                                 f"launched {got}, not {want}")
        if any(x["trip_calls"].values()) or nonzero(x["collect_calls"]) \
                != {"all_gather": 1}:
            raise AssertionError(f"mesh_provenance_batches wide: rank {r}'s "
                                 f"census {x['trip_calls']} / "
                                 f"{x['collect_calls']}")
    x = per[0]
    rec["runs"]["scenario_broadcast_256x1024"] = {
        "scenarios": WIDE_S, "scenarios_a_rank": x["local_scenarios"],
        "rows_a_rank": x["local_scenarios"] * WIDE_N, "rounds": x["rounds"],
        "trip_ms": max(y["trip_s"] for y in per) * 1e3,
        "collect_ms": max(y["collect_s"] for y in per) * 1e3,
        "launches_per_round_rank0": _per_round(x["launches"], x["rounds"]),
        "launches_per_round_one_process":
            one["wide"]["launches_per_round"],
        "trip_calls": x["trip_calls"], "collect_calls": x["collect_calls"],
        "equals_one_process_card_run": True}
    counts += [y["launches"] for y in per]
    # the looped batches
    for name in ("scenario_counter_fuzz", "scenario_kafka_fuzz",
                 "scenario_txn"):
        per = [r[name] for r in ranks]
        held(name, [x["rows"] for x in per], one[name], "rows")
        for r, x in enumerate(per):
            if nonzero(x["calls"]) != {"all_gather": 1}:
                raise AssertionError(f"mesh_provenance_batches {name}: rank "
                                     f"{r}'s calls {x['calls']}")
        rec["runs"][name] = {
            "scenarios": len(per[0]["rows"]),
            "wall_ms_by_rank": [x["wall_s"] * 1e3 for x in per],
            "trips": per[0]["trips"], "calls": per[0]["calls"],
            "equals_one_process_card_run": True}
        counts += [x["launches"] for x in per]
    # the frontier
    per = [r["frontier"] for r in ranks]
    held("frontier", [x["report"] for x in per], one["frontier"])
    rec["runs"]["frontier_256"] = {
        "cells": per[0]["report"]["n_cells"], "cells_a_rank":
            per[0]["report"]["n_cells"] // MESH_RANKS,
        "wall_ms_by_rank": [x["wall_s"] * 1e3 for x in per],
        "calls": per[0]["calls"], "equals_one_process_card_run": True}
    counts += [x["launches"] for x in per]
    # the fuzz campaign: fuzz_campaigns' first batch and planted shrink
    per = [r["fuzz"] for r in ranks]
    held("fuzz", [x["rows"] for x in per], one["fuzz"]["rows"], "rows")
    held("fuzz", [x["planted"] for x in per], one["fuzz"]["planted"],
         "shrink")
    written = sorted(os.listdir(MESH_PROV["fuzz_dir"]))
    planted = per[0]["planted"]
    rec["runs"]["fuzz"] = {
        "scenarios": MESH_FUZZ_S, "n_failing": sum(
            1 for row in per[0]["rows"] if not row["ok"]),
        "weight_before": planted["weight_before"],
        "weight_after": planted["weight_after"],
        "n_candidate_runs": planted["n_candidate_runs"],
        "replay_same_failure": planted["replay_same_failure"],
        "bundles_written": written,
        "wall_ms_by_rank": [x["wall_s"] * 1e3 for x in per],
        "equals_one_process_card_run": True}
    if not (planted["replay_same_failure"] and per[0]["bundle"] in written
            and len(written) == 1):
        raise AssertionError(f"mesh_provenance_batches fuzz: {written}")
    counts += [x["launches"] for x in per]
    # the replay: the mesh's against the card's of the same bundle
    want = prov_result(observe.replay_bundle(MESH_PROV["bundle"],
                                             device=device))
    per = [r["replay"] for r in ranks]
    held("replay", [x["result"] for x in per], want)
    res = per[0]["result"]
    src = one["replay_source"]
    if not (res.get("first_divergence_round") is None and not res["ok"]
            and res["lost_writes"] == src["lost_writes"]
            and res["provenance"]["arrays"] == src["provenance"]["arrays"]):
        raise AssertionError("mesh_provenance_batches replay: not the "
                             "bundle's failure, or not faithful")
    rec["runs"]["replay"] = {
        "n": MESH_REPLAY_NODES, "first_divergence_round": None,
        "lost_writes": len(res["lost_writes"]),
        "wall_ms_by_rank": [x["wall_s"] * 1e3 for x in per],
        "equals_one_process_card_replay": True}
    counts += [x["launches"] for x in per]
    # the txn frontier against its one-process card run
    want = htxn.run_txn_frontier(MESH_TXN_FRONTIER_RATES,
                                 txn_frontier_specs(faults), device=device,
                                 **MESH_TXN_FRONTIER)
    per = [r["txn_frontier"] for r in ranks]
    held("txn_frontier", [x["result"] for x in per], want)
    rec["runs"]["txn_frontier"] = {
        "cells": want["n_cells"], "ok": want["ok"],
        "wall_ms_by_rank": [x["wall_s"] * 1e3 for x in per],
        "calls": per[0]["calls"], "equals_one_process_card_run": True}
    counts += [x["launches"] for x in per]
    launches.add_ranks(rec, counts, MESH_PROV_EXPECT)
    rec.update(rank_seconds=max(r["seconds"] for r in ranks), ok=True)
    emit(rec)
    torch.cuda.empty_cache()


def strip_frontier(rep: dict) -> dict:
    """A frontier report without its wall clocks and bundle paths."""
    out = {k: v for k, v in rep.items()
           if k not in ("dispatch_s", "batch_walls_s", "cells_per_sec",
                        "total_s")}
    out["bundles"] = [{k: v for k, v in b.items() if k != "path"}
                      for b in rep.get("bundles", ())]
    return out


# -- mesh_2d: the words axis and the hosts axis on the ranks -----------------

# the words axis's many-values regime (the reference's
# timing.words_axis_regime): the 4-ary tree at 2^20 nodes, 4,096 values
# (W = 128) on 2 nodes x 2 words, a rank holding (64, 2^19) int32
MESH2D_WORDS = (N_NODES, W128_VALUES)
# the circulant's halo path and the node-major gather path on the words
# mesh: their halos at 2^20 would move whole blocks a round through the
# host-staged transport, so 2^16 nodes
MESH2D_SMALL = 1 << 16
MESH2D_TASKS = ("batch", "certify", "takeover", "pipelined", "stale")
MESH2D_EXPECT = ("tree_halo_pack", "tree_halo_round", "col_popcount",
                 "gather_flood_round", "col_popcount_nm", "counter_select",
                 "counter_apply", "kafka_nem_deliver")
# the reference's certified staleness spec (tests/test_dcn_pr20.py)
MESH2D_STALE = dict(n_nodes=16, seed=3, crash=((1, 4, (2, 11)),),
                    loss_rate=0.2, loss_until=5)


def words_block_digest(sim, rec) -> int:
    """The digest of a rank's block of a words-major (W, N) bitset as
    its part of the whole array's (:func:`card_digest`: each of its word
    rows at that row's global offset); the whole array's off a mesh."""
    n, w0, n0 = sim.n_nodes, sim._wcols.start, sim._rows.start
    total = 0
    for i in range(rec.shape[0]):
        total += card_digest(rec[i], (w0 + i) * n + n0)
    return total & MASK32


def mesh2d_small_sims(broadcast, timing, topology, mesh, device=None):
    """(name, sim, inject) of the 2^16-node words-mesh runs: the
    circulant's halo path (server ledger on) and the gather path over a
    random 8-regular graph, W = 128."""
    n, nv = MESH2D_SMALL, W128_VALUES
    strides = topology.expander_strides(n, DEGREE, seed=0)
    place = dict(mesh=mesh) if mesh is not None else dict(device=device)
    inject = broadcast.make_inject(n, nv)
    yield ("circulant", timing.structured_sim(
        "circulant", n, nv, sync_every=16, srv_ledger=True,
        strides=strides, mesh=mesh, device=device), inject)
    yield ("gather", broadcast.BroadcastSim(
        topology.random_regular(n, DEGREE, seed=0), n_values=nv,
        sync_every=16, **place), inject)


def _words_rank(mesh, flat) -> dict:
    """The words axis on the ranks: the many-values tree on the 2 x 2
    words mesh and on the flat 4-rank mesh (its while-converge run, timed,
    launches and collectives counted; this rank's digest of its block),
    and the 2^16-node circulant and gather runs on the words mesh."""
    import torch

    from gossip_glomers_tpu_torch.tpu_sim import (broadcast, kernels,
                                                  timing)
    from gossip_glomers_tpu_torch.parallel import topology

    n, nv = MESH2D_WORDS
    inject = broadcast.make_inject(n, nv)
    out = {}
    for name, m in (("words", mesh), ("flat", flat)):
        sim = timing.structured_sim("tree", n, nv, mesh=m)
        m.agree(True)
        torch.cuda.synchronize()
        kernels.reset_launches()
        before = dict(m.calls_by_axis)
        t0 = time.perf_counter()
        state, rounds = sim.run_fused(inject)
        torch.cuda.synchronize()
        out[name] = {
            "wall_s": time.perf_counter() - t0, "rounds": rounds,
            "msgs": int(state.msgs), "launches": dict(kernels.LAUNCHES),
            "calls": {f"{k}@{a}": v - before.get((k, a), 0)
                      for (k, a), v in m.calls_by_axis.items()
                      if v > before.get((k, a), 0)},
            "block": list(state.received.shape),
            "digest": words_block_digest(sim, state.received),
            "halo": sim.sharded_exchange is not None}
        del sim, state
        torch.cuda.empty_cache()
    for name, sim, inj in mesh2d_small_sims(broadcast, timing, topology,
                                            mesh):
        mesh.agree(True)
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, rounds = sim.run_fused(inj)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = sim.received_node_major(state)    # a collective: every rank
        out[name] = {"wall_s": wall, "rounds": rounds,
                     "msgs": int(state.msgs),
                     "srv": (None if state.srv_msgs is None
                             else int(state.srv_msgs)),
                     "launches": dict(kernels.LAUNCHES),
                     "received": rec if mesh.rank == 0 else None}
        del sim, state, rec
    return out


def _hosts_rank(mesh, hosts, rounds: dict) -> dict:
    """The hosts axis on the ranks (``hosts``: ``pick_mesh_2d(hosts=2)``
    of the world): mesh_tree_1m's runs sync and pipelined; mesh_kafka's
    4,096-node pull campaign pipelined (this rank's digests); the stale
    counter campaign sync and ``stale:4`` (and sync on the flat mesh);
    the worker's hosts task set on the hosts mesh and (but ``stale``) on
    the flat one."""
    import torch

    from gossip_glomers_tpu_torch.harness import checkers, nemesis
    from gossip_glomers_tpu_torch.parallel import dcn_worker
    from gossip_glomers_tpu_torch.tpu_sim import faults, kernels

    out = {"shape": hosts.shape}
    old = os.environ.get("GG_DCN_PIPELINE")
    try:
        for mode in ("sync", "pipelined"):
            os.environ["GG_DCN_PIPELINE"] = "1" if mode == "pipelined" \
                else "0"
            before = dict(hosts.calls_by_axis)
            out[f"tree_1m_{mode}"] = _mesh_tree_rank(hosts)
            out[f"tree_1m_{mode}"]["axes"] = {
                f"{k}@{a}": v - before.get((k, a), 0)
                for (k, a), v in hosts.calls_by_axis.items()
                if v > before.get((k, a), 0)}
        os.environ["GG_DCN_PIPELINE"] = "1"
        sim, ops = mesh_kafka_sim("pull_blocked", hosts.device, hosts)
        hosts.agree(True)
        kernels.reset_launches()
        t0 = time.perf_counter()
        st = mesh_kafka_trip("pull_blocked", sim, ops,
                             rounds["kafka_quiet_pull_blocked"])
        torch.cuda.synchronize()
        out["kafka_pipelined"] = {
            "wall_s": time.perf_counter() - t0,
            "launches": dict(kernels.LAUNCHES),
            "dcn_mode": sim._dcn.label(),
            "digest": kafka_digests(st, hosts.rank * sim._block)}
        del sim, st
        torch.cuda.empty_cache()
    finally:
        if old is None:
            os.environ.pop("GG_DCN_PIPELINE", None)
        else:
            os.environ["GG_DCN_PIPELINE"] = old
    spec = faults.NemesisSpec(**MESH2D_STALE)
    stale = {}
    kernels.reset_launches()
    for label, m, dcn in (("sync", hosts, "sync"),
                          ("stale", hosts, "stale:4"),
                          ("flat_sync", mesh, "sync")):
        t0 = time.perf_counter()
        res = nemesis.run_counter_nemesis(spec, mode="allreduce", mesh=m,
                                          max_recovery_rounds=32,
                                          dcn_mode=dcn)
        stale[label] = {k: res[k] for k in (
            "ok", "converged_round", "n_lost_writes", "kv", "acked_sum",
            "msgs_total")}
        stale[label]["wall_s"] = time.perf_counter() - t0
    stale["launches"] = dict(kernels.LAUNCHES)
    ok, details = checkers.check_staleness_bound(
        stale_k=4, sync_converged_round=stale["sync"]["converged_round"],
        stale_converged_round=stale["stale"]["converged_round"],
        lost_writes=[] if not stale["stale"]["n_lost_writes"] else [
            {"n": stale["stale"]["n_lost_writes"]}],
        recovery=(stale["stale"]["ok"], {}))
    stale["bound"] = {"ok": ok, **{k: details[k] for k in (
        "delay_rounds", "bound_round")}}
    planted, d1 = checkers.check_staleness_bound(
        stale_k=1, sync_converged_round=stale["sync"]["converged_round"],
        stale_converged_round=stale["stale"]["converged_round"],
        lost_writes=[])
    stale["planted_k1"] = {"ok": planted,
                           "violating_round": d1.get("violating_round")}
    out["stale"] = stale
    t0 = time.perf_counter()
    out["tasks"] = {"hosts": dcn_worker.run_tasks(MESH2D_TASKS, hosts,
                                                  timed=True),
                    "flat": dcn_worker.run_tasks(MESH2D_TASKS[:4], mesh,
                                                 timed=True)}
    out["tasks_s"] = time.perf_counter() - t0
    return out


def _mesh_2d_rank(mesh, rounds: dict) -> dict:
    """mesh_2d's rank side (every rank makes the words mesh's and the
    hosts mesh's groups, in the same order)."""
    from gossip_glomers_tpu_torch.parallel.mesh import (make_mesh,
                                                        pick_mesh_2d)

    t0 = time.perf_counter()
    words = make_mesh((2, 2), ("nodes", "words"), device=mesh.device)
    hosts = pick_mesh_2d(hosts=2, device=mesh.device)
    out = {"words_shape": words.shape, "coords": words.coords,
           "words": _words_rank(words, mesh),
           "hosts": _hosts_rank(mesh, hosts, rounds)}
    out["seconds"] = time.perf_counter() - t0
    return out


def mesh_2d_phase(ranks: list, modules, launches: Launches, device,
                  head: dict, tree_flat: list) -> None:
    """mesh_2d (module docstring): every run of the ranks held against
    its one-process card run (the many-values tree, the 2^16-node words
    runs, the stale counter's sync twin and the worker's tasks here; the
    Kafka campaign's :data:`KAFKA_ONE`) and against the flat 4-rank run
    (``tree_flat``: mesh_tree_1m's ranks)."""
    import torch

    broadcast, timing, topology, dcn_worker = modules
    rec = {"phase": "mesh_2d", **head,
           "words_mesh": ranks[0]["mesh_2d"]["words_shape"],
           "hosts_mesh": ranks[0]["mesh_2d"]["hosts"]["shape"]}
    w = [r["mesh_2d"]["words"] for r in ranks]
    h = [r["mesh_2d"]["hosts"] for r in ranks]
    counts = []
    # -- the words axis at full width -------------------------------------
    n, nv = MESH2D_WORDS
    one = timing.structured_sim("tree", n, nv, device=device, mesh=None)
    t0 = time.perf_counter()
    st, rounds = one.run_fused(broadcast.make_inject(n, nv))
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    whole = card_digest(st.received, 0)
    want = {"rounds": rounds, "msgs": int(st.msgs)}
    del one, st
    torch.cuda.empty_cache()
    runs = {}
    for name in ("words", "flat"):
        got = [x[name] for x in w]
        digest = sum(x["digest"] for x in got) & MASK32
        if digest != whole or any(
                {"rounds": x["rounds"], "msgs": x["msgs"]} != want
                for x in got) or not all(x["halo"] for x in got):
            raise AssertionError(f"mesh_2d words tree ({name} mesh): "
                                 f"{digest} / {got[0]['rounds']} rounds vs "
                                 f"the one-process card run {whole} / "
                                 f"{want}, or no halo path")
        counts += [x["launches"] for x in got]
        walls = [x["wall_s"] for x in got]
        runs[f"tree_{name}"] = {
            **want, "block": got[0]["block"], "wall_ms": max(walls) * 1e3,
            "ms_per_round": max(walls) * 1e3 / rounds,
            "collective_calls_rank0": got[0]["calls"],
            "launches_per_round_rank0": _per_round(got[0]["launches"],
                                                   rounds),
            "equals_one_process_card_run": True}
    runs["tree_words"]["one_process_ms"] = one_s * 1e3
    runs["tree_words"]["equals_flat_mesh_run"] = True
    for name, sim, inj in mesh2d_small_sims(broadcast, timing, topology,
                                            None, device):
        st, rounds = sim.run_fused(inj)
        want = {"rounds": rounds, "msgs": int(st.msgs),
                "srv": None if st.srv_msgs is None else int(st.srv_msgs)}
        for r, x in enumerate(w):
            if {k: x[name][k] for k in want} != want:
                raise AssertionError(f"mesh_2d words {name}: rank {r} "
                                     f"differs from the one-process run")
        if not (w[0][name]["received"]
                == sim.received_node_major(st)).all():
            raise AssertionError(f"mesh_2d words {name}: received differs "
                                 "from the one-process card run")
        counts += [x[name]["launches"] for x in w]
        runs[name] = {**want, "n": MESH2D_SMALL, "n_values": W128_VALUES,
                      "wall_ms": max(x[name]["wall_s"] for x in w) * 1e3,
                      "equals_one_process_card_run": True}
        del sim, st
    # -- the hosts axis ---------------------------------------------------
    keys = ("rounds", "fused_rounds", "acct_rounds", "fixed_msgs",
            "fused_msgs", "acct_msgs", "acct_srv")
    for mode in ("sync", "pipelined"):
        got = [x[f"tree_1m_{mode}"] for x in h]
        for r, (x, y) in enumerate(zip(got, tree_flat)):
            if {k: x[k] for k in keys} != {k: y[k] for k in keys}:
                raise AssertionError(f"mesh_2d tree_1m {mode}: rank {r} "
                                     "differs from the flat mesh's run")
        for key in ("fixed_received", "acct_received"):
            if not (got[0][key] == tree_flat[0][key]).all():
                raise AssertionError(f"mesh_2d tree_1m {mode}: {key} "
                                     "differs from the flat mesh's run")
        # only the pipelined mode splits the hosts level out of the sums
        split = [x["axes"].get("all_reduce@hosts", 0) for x in got]
        if (mode == "pipelined") != all(s > 0 for s in split) or \
                (mode == "sync" and any(split)):
            raise AssertionError(f"mesh_2d tree_1m {mode}: all_reduce@hosts "
                                 f"calls by rank {split} do not show the "
                                 f"{mode} mode")
        counts += [x[k] for x in got for k in ("fixed_launches",
                                               "fused_launches",
                                               "acct_launches")]
        runs[f"tree_1m_hosts_{mode}"] = {
            "rounds": got[0]["rounds"], "msgs": got[0]["fixed_msgs"],
            "wall_ms": max(x["wall_s"] for x in got) * 1e3,
            "accounted_ms": max(x["acct_wall_s"] for x in got) * 1e3,
            "collective_calls_by_axis_rank0": got[0]["axes"],
            "equals_flat_mesh_run": True,
            "equals_one_process_card_run": True}
    one = KAFKA_ONE["pull_blocked"]
    for r, x in enumerate(h):
        if x["kafka_pipelined"]["digest"] != one["blocks"][r] or \
                x["kafka_pipelined"]["digest"] != ranks[r]["kafka"][
                    "pull_blocked"]["digest"] or \
                x["kafka_pipelined"]["dcn_mode"] != "pipelined":
            raise AssertionError(f"mesh_2d kafka pipelined: rank {r} "
                                 "differs from the one-process card run "
                                 "or the flat mesh's")
    counts += [x["kafka_pipelined"]["launches"] for x in h]
    runs["kafka_4k_pipelined"] = {
        "rounds": h[0]["kafka_pipelined"]["digest"]["t"],
        "msgs": h[0]["kafka_pipelined"]["digest"]["msgs"],
        "wall_ms": max(x["kafka_pipelined"]["wall_s"] for x in h) * 1e3,
        "equals_one_process_card_run": True, "equals_flat_mesh_run": True}
    from gossip_glomers_tpu_torch.harness import nemesis
    from gossip_glomers_tpu_torch.tpu_sim import faults

    sync_one = nemesis.run_counter_nemesis(
        faults.NemesisSpec(**MESH2D_STALE), mode="allreduce",
        max_recovery_rounds=32, device=device)
    stale = h[0]["stale"]
    fields = ("ok", "converged_round", "n_lost_writes", "kv", "acked_sum",
              "msgs_total")
    for r, x in enumerate(h):
        s = x["stale"]
        if any({k: s[label][k] for k in fields}
               != {k: stale[label][k] for k in fields}
               for label in ("sync", "stale", "flat_sync")):
            raise AssertionError(f"mesh_2d stale counter: rank {r} differs")
    if not ({k: stale["sync"][k] for k in fields}
            == {k: stale["flat_sync"][k] for k in fields}
            == {k: sync_one[k] for k in fields}):
        raise AssertionError("mesh_2d stale counter: the sync twin differs "
                             "from the flat mesh's or the one-process run")
    delay = stale["bound"]["delay_rounds"]
    if not (stale["stale"]["ok"] and stale["stale"]["n_lost_writes"] == 0
            and stale["stale"]["kv"] == stale["stale"]["acked_sum"]
            and stale["bound"]["ok"] and 1 <= delay <= 4
            and not stale["planted_k1"]["ok"]
            and stale["planted_k1"]["violating_round"]
            == stale["stale"]["converged_round"]):
        raise AssertionError(f"mesh_2d stale counter: {stale}")
    counts += [x["stale"]["launches"] for x in h]
    runs["stale_counter"] = {
        "spec": "tests/test_dcn_pr20.py STALE_SPEC", "k": 4,
        "sync_round": stale["sync"]["converged_round"],
        "stale_round": stale["stale"]["converged_round"],
        "delay_rounds": delay, "bound_round": stale["bound"]["bound_round"],
        "kv": stale["stale"]["kv"], "acked_sum": stale["stale"]["acked_sum"],
        "planted_k1_fails_at": stale["planted_k1"]["violating_round"],
        "sync_equals_one_process_card_run": True}
    t0 = time.perf_counter()
    tasks_one = dcn_worker.run_tasks(MESH2D_TASKS[:4], None, timed=False,
                                     device=device)
    tasks_one_s = time.perf_counter() - t0
    strip = dcn_worker._strip_timing
    for r, x in enumerate(h):
        got = strip(x["tasks"]["hosts"])
        flat = strip(x["tasks"]["flat"])
        if any(got[t] != tasks_one[t] or flat[t] != tasks_one[t]
               for t in MESH2D_TASKS[:4]) or got["stale"] != strip(
                h[0]["tasks"]["hosts"])["stale"] or not got["stale"]["ok"]:
            raise AssertionError(f"mesh_2d worker tasks: rank {r} differs "
                                 "from the one-process card run or the "
                                 "flat mesh's")
    runs["worker_tasks"] = {
        "tasks": list(MESH2D_TASKS), "stale": strip(
            h[0]["tasks"]["hosts"]["stale"]),
        "wall_ms_by_task_rank0": {
            t: v["wall_s"] * 1e3
            for t, v in h[0]["tasks"]["hosts"].items()},
        "one_process_s": tasks_one_s,
        "equals_one_process_card_run": True, "equals_flat_mesh_run": True}
    launches.add_ranks(rec, counts, MESH2D_EXPECT)
    rec.update(runs=runs,
               rank_seconds=max(r["mesh_2d"]["seconds"] for r in ranks),
               ok=True)
    emit(rec)
    torch.cuda.empty_cache()


def mesh_rank_work(mesh, seed: int, rounds: dict, txn_ops,
                   prov_args: dict) -> dict:
    """The rank side of every mesh phase, in one world; ``rounds``: each
    kept one-process run's rounds (:data:`ONE_PROCESS`); ``txn_ops``:
    txn_64k's staged ops, whole; ``prov_args``: the bundle to replay and
    the fuzz campaign's directory (:func:`_mesh_prov_batches_rank`)."""
    return {"transport": mesh.transport, "rank": mesh.rank,
            "collectives": _mesh_collectives_rank(mesh, seed),
            "tree_1m": _mesh_tree_rank(mesh),
            "topologies": _mesh_topo_rank(mesh),
            "nemesis": _mesh_nemesis_rank(mesh, rounds),
            "delays": _mesh_delays_rank(mesh, rounds),
            "gather": _mesh_gather_rank(mesh, rounds),
            "counter": _mesh_counter_rank(mesh, rounds),
            "kafka": _mesh_kafka_rank(mesh, rounds),
            "txn_serving": _mesh_txn_serving_rank(mesh, txn_ops),
            "prov_batches": _mesh_prov_batches_rank(mesh, prov_args),
            "mesh_2d": _mesh_2d_rank(mesh, rounds)}


def nccl_rank_work(mesh, txn_ops) -> dict:
    """The 1-rank NCCL world: structured_sim on a 65,536-node tree on the
    mesh (its all-reduces through NCCL, its halo ppermutes local)."""
    import torch

    from gossip_glomers_tpu_torch.tpu_sim import broadcast, timing

    n = MESH_SMALL_NODES
    inject = broadcast.make_inject(n, W1_VALUES)
    sim = timing.structured_sim("tree", n, W1_VALUES, sync_every=16,
                                srv_ledger=True, mesh=mesh)
    state, rounds = sim.run_fused(inject)
    torch.cuda.synchronize()
    out = {"backend": mesh.backend, "rounds": rounds,
           "msgs": int(state.msgs), "srv": sim.server_msgs(state),
           "received": sim.received_node_major(state),
           "calls": dict(mesh.calls)}
    del sim, state
    out["kafka"] = nccl_kafka(mesh)
    out["txn"] = nccl_txn(mesh, txn_ops)
    return out


def nccl_one_rank(txn_ops) -> dict:
    """:func:`nccl_rank_work` in a 1-rank NCCL world of this process (a
    ``file://`` store in a temporary directory), destroyed after."""
    import datetime

    import torch
    import torch.distributed as dist

    from gossip_glomers_tpu_torch.parallel.mesh import Mesh

    work = tempfile.mkdtemp(prefix="gg_nccl_")
    try:
        dist.init_process_group(
            "nccl", init_method=f"file://{work}/store", world_size=1,
            rank=0, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        try:
            return nccl_rank_work(Mesh(None, device=torch.device(
                "cuda", torch.cuda.current_device())), txn_ops)
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _per_round(d: dict, rounds: int) -> dict:
    return {k: v / rounds for k, v in d.items() if v}


def mesh_phases(modules, device, launches: Launches, card: str,
                times: dict) -> None:
    """mesh_collectives, mesh_tree_1m and mesh_topologies (module
    docstring).  Their launches are the ranks' own counts of the mesh
    runs (:meth:`Launches.add_ranks`); the parent's one-process and CPU
    runs they are held against are not counted."""
    import torch

    broadcast, timing, topology, dcn_worker = modules
    t0 = time.perf_counter()
    one = ring_sim(broadcast, topology, device=device)
    st, _ = one.run_fused(broadcast.make_inject(MESH_RING_NODES, W1_VALUES))
    keep_run("ring", one, st)
    del one, st
    t1 = time.perf_counter()
    mesh_kafka_one_process(device)
    KAFKA_ONE["seconds"] = time.perf_counter() - t1
    rounds = {name: run["rounds"] for name, run in ONE_PROCESS.items()}
    rounds.update({f"kafka_quiet_{name}": KAFKA_ONE[name]["quiet"]
                   for name in MESH_KAFKA_RUNS})
    # txn_64k's ops, staged once here (the host loop, cached for txn_64k)
    # and shipped to the ranks in the spawn arguments
    from gossip_glomers_tpu_torch.tpu_sim import txn

    t1 = time.perf_counter()
    txn_ops = txn._staged(TXN_NODES, TXN_T, TXN_O, TXN_KEYS, 0)
    MESH_TXN["stage_s"] = time.perf_counter() - t1
    prov_args = mesh_prov_setup(device)
    ranks = dcn_worker.spawn_world(mesh_rank_work, MESH_RANKS,
                                   backend="gloo", device=device,
                                   args=(MESH_SEED, rounds, txn_ops,
                                         prov_args),
                                   timeout=MESH_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    transport = ranks[0]["transport"]
    if transport != "gloo, host-staged":
        raise AssertionError(f"mesh transport {transport!r}")

    # -- mesh_collectives -------------------------------------------------
    checked = check_mesh_collectives([r["collectives"] for r in ranks],
                                     MESH_SEED)
    t1 = time.perf_counter()
    nccl = nccl_one_rank(txn_ops)
    nccl_s = time.perf_counter() - t1
    n = MESH_SMALL_NODES
    one = timing.structured_sim("tree", n, W1_VALUES, sync_every=16,
                                srv_ledger=True, device=device, mesh=None)
    st, rounds = one.run_fused(broadcast.make_inject(n, W1_VALUES))
    if not (nccl["backend"] == "nccl" and nccl["rounds"] == rounds
            and nccl["msgs"] == int(st.msgs)
            and nccl["srv"] == one.server_msgs(st)
            and (nccl["received"] == one.received_node_major(st)).all()):
        raise AssertionError("mesh_collectives: the 1-rank NCCL run differs "
                             "from the no-mesh run")
    emit({"phase": "mesh_collectives", "ranks": MESH_RANKS,
          "transport": transport, "device": card, "checked": checked,
          "tolerance": 0, "world_spawn_and_run_s": world_s,
          "nccl_one_rank": {"n": n, "rounds": rounds,
                            "msgs": nccl["msgs"], "srv_msgs": nccl["srv"],
                            "calls": nccl["calls"], "seconds": nccl_s,
                            "in_process": True,
                            "equals_no_mesh_run": True},
          "nccl_point_to_point": "not run: NCCL's cross-rank send and "
                                 "receive need two cards (this machine "
                                 "has one)"})
    del one, st

    # -- mesh_tree_1m -----------------------------------------------------
    tr = [r["tree_1m"] for r in ranks]
    rounds = tr[0]["rounds"]
    n, nv = N_NODES, W1_VALUES
    inject = broadcast.make_inject(n, nv)
    one = timing.structured_sim("tree", n, nv, device=device, mesh=None)
    ref_fixed = one.run_staged_fixed(one.init_state(inject), rounds)
    acct = timing.structured_sim("tree", n, nv, sync_every=16,
                                 srv_ledger=True, device=device, mesh=None)
    ref_a, rounds_a = acct.run_fused(inject)
    rec = {"phase": "mesh_tree_1m", "n": n, "n_values": nv, "w": 1,
           "ranks": MESH_RANKS, "block": n // MESH_RANKS,
           "transport": transport, "device": card,
           "label": "4 ranks on one card over host-staged gloo; not a "
                    "multi-card figure"}
    for r, x in enumerate(tr):
        if not (x["fused_rounds"] == rounds == ref_fixed.t
                and x["acct_rounds"] == rounds_a
                and x["fixed_msgs"] == x["fused_msgs"] == int(
                    ref_fixed.msgs)
                and x["acct_msgs"] == int(ref_a.msgs)
                and x["acct_srv"] == acct.server_msgs(ref_a) and x["halo"]):
            raise AssertionError(f"mesh_tree_1m: rank {r}'s rounds or "
                                 "ledgers differ from the one-process run")
    if not ((tr[0]["fixed_received"]
             == one.received_node_major(ref_fixed)).all()
            and (tr[0]["acct_received"]
                 == acct.received_node_major(ref_a)).all()):
        raise AssertionError("mesh_tree_1m: received differs from the "
                             "one-process run on the card")
    del ref_fixed, ref_a, one, acct
    torch.cuda.empty_cache()
    cpu = timing.structured_sim("tree", n, nv, sync_every=16,
                                srv_ledger=True, device="cpu", mesh=None)
    cpu_state, cpu_rounds = cpu.run_fused(inject)
    if not (cpu_rounds == rounds_a and int(cpu_state.msgs)
            == tr[0]["acct_msgs"] and cpu.server_msgs(cpu_state)
            == tr[0]["acct_srv"] and (cpu.received_node_major(cpu_state)
                                      == tr[0]["acct_received"]).all()):
        raise AssertionError("mesh_tree_1m: the mesh run differs from the "
                             "CPU twin")
    launches.add_ranks(rec, [x["fixed_launches"] for x in tr]
                       + [x["fused_launches"] for x in tr]
                       + [x["acct_launches"] for x in tr], MESH_EXPECT)
    walls = [x["wall_s"] for x in tr]
    rec.update({
        "rounds": rounds, "accounted_rounds": rounds_a,
        "msgs": tr[0]["fixed_msgs"], "srv_msgs": tr[0]["acct_srv"],
        "sync_every_accounted": 16,
        "wall_ms_by_rank": [w_ * 1e3 for w_ in walls],
        "wall_ms": max(walls) * 1e3,
        "ms_per_round": max(walls) * 1e3 / rounds,
        "launches_per_round_rank0": _per_round(tr[0]["fixed_launches"],
                                               rounds),
        "collective_calls_per_round_rank0": _per_round(
            tr[0]["fixed_calls"], rounds),
        "run_fused_ms": max(x["fused_wall_s"] for x in tr) * 1e3,
        "run_fused_calls_per_round_rank0": _per_round(
            tr[0]["fused_calls"], rounds),
        "accounted_ms": max(x["acct_wall_s"] for x in tr) * 1e3,
        "accounted_calls_per_round_rank0": _per_round(
            tr[0]["acct_calls"], rounds_a),
        "halo_kernels": {name: {f"{w}x{b}": v for (w, b), v in
                                times[name].items()}
                         for name in ("tree_halo_pack", "tree_halo_round")},
        "equals_one_process_card_run": True, "cpu_match": True})
    emit(rec)
    del cpu, cpu_state

    # -- mesh_topologies --------------------------------------------------
    rec = {"phase": "mesh_topologies", "ranks": MESH_RANKS,
           "transport": transport, "device": card, "runs": {}}
    tops = [r["topologies"] for r in ranks]
    for name, sim, inj in _mesh_topo_sims(broadcast, timing, topology, None,
                                          device):
        st, rounds = sim.run_fused(inj)
        want = {"rounds": rounds, "msgs": int(st.msgs),
                "srv": None if st.srv_msgs is None else int(st.srv_msgs)}
        for r, x in enumerate(tops):
            got = {k: x[name][k] for k in want}
            if got != want:
                raise AssertionError(f"mesh_topologies {name}: rank {r} "
                                     f"{got} vs one process {want}")
        if not (tops[0][name]["received"]
                == sim.received_node_major(st)).all():
            raise AssertionError(f"mesh_topologies {name}: received "
                                 "differs from the one-process run")
        x = tops[0][name]
        rec["runs"][name] = {**want, "path": x["path"],
                             "wall_ms": x["wall_s"] * 1e3,
                             "calls_rank0": x["calls"]}
        del sim, st
    launches.add_ranks(rec, [r[name]["launches"] for r in tops
                             for name in r],
                       ("tree_halo_pack", "tree_halo_round"))
    rec["equals_one_process_card_run"] = True
    emit(rec)
    torch.cuda.empty_cache()
    mesh_fault_phases(ranks, (broadcast, topology), device, launches, card,
                      transport)
    mesh_kafka_phase(ranks, launches, {"ranks": MESH_RANKS,
                                       "transport": transport,
                                       "device": card, "label": MESH_LABEL},
                     nccl["kafka"], world_s)
    mesh_2d_phase(ranks, modules, launches, device,
                  {"ranks": MESH_RANKS, "transport": transport,
                   "device": card, "label": MESH_LABEL,
                   "world_seconds": world_s}, tr)
    # mesh_txn_serving and mesh_provenance_batches are held against runs
    # of later phases: keep the ranks' results
    MESH_PROV.update(ranks=[r["prov_batches"] for r in ranks],
                     head={"ranks": MESH_RANKS, "transport": transport,
                           "device": card, "label": MESH_LABEL,
                           "world_seconds": world_s}, **prov_args)
    MESH_TXN.update(ranks=[r["txn_serving"] for r in ranks],
                    nccl=nccl["txn"],
                    head={"ranks": MESH_RANKS, "transport": transport,
                          "device": card, "label": MESH_LABEL,
                          "world_seconds": world_s,
                          "stage_s": MESH_TXN["stage_s"]})
    for name in MESH_PATH_KERNELS:
        if not launches.split(name)["mesh"]:
            raise AssertionError(f"{name}: no launch in the mesh bucket")


MESH_LABEL = ("4 ranks on one card over host-staged gloo; not a multi-card "
              "figure")


def _held(phase: str, name: str, runs: list, want: dict,
          fields=("rounds", "msgs", "srv")) -> dict:
    """Every rank's run of ``name`` against the one-process card run
    ``want``: the fields on every rank, the state arrays on rank 0 (which
    brings them back), the fixed trip equal to the converged run.
    Returns rank 0's record of it: rounds, ms a round, collective calls
    and launches a round a rank."""
    import numpy as np

    for r, x in enumerate(runs):
        got = {f: x[f] for f in fields}
        exp = {f: want[f] for f in fields}
        if got != exp:
            raise AssertionError(f"{phase} {name}: rank {r} {got} vs the "
                                 f"one-process card run {exp}")
    for f in ("received", "pending", "cached", "vals"):
        if want.get(f) is not None and not np.array_equal(runs[0][f],
                                                          want[f]):
            raise AssertionError(f"{phase} {name}: {f} differs from the "
                                 "one-process card run")
    x = runs[0]
    rounds = max(1, x.get("trip_rounds", x["rounds"]))
    walls = [y["wall_s"] for y in runs]
    return {**{f: x[f] for f in fields if f in x},
            "timed_rounds": rounds, "wall_ms": max(walls) * 1e3,
            "ms_per_round": max(walls) * 1e3 / rounds,
            "collective_calls_per_round": _per_round(x["calls"], rounds),
            "launches_per_round_rank0": _per_round(x["launches"], rounds),
            "equals_one_process_card_run": True}


def mesh_fault_phases(ranks: list, modules, device, launches: Launches,
                      card: str, transport: str) -> None:
    """mesh_tree_1m_nemesis, mesh_delays, mesh_gather_nemesis and
    mesh_counter (module docstring): the ranks' runs of configurations
    earlier phases ran in one process on the card (ONE_PROCESS; the
    gather ring's is made by :func:`mesh_phases`), held against those
    runs."""
    import torch

    broadcast, topology = modules
    head = {"ranks": MESH_RANKS, "transport": transport, "device": card,
            "label": MESH_LABEL}

    def phase(name: str, part: str, runs: dict, expect, extra=None):
        rec = {"phase": name, **head, "runs": {}}
        counts = []
        for key, want in runs.items():
            per = [r[part][key] for r in ranks]
            rec["runs"][key] = _held(name, key, per, want, *(
                () if extra is None else (extra,)))
            counts += [x["launches"] for x in per]
        launches.add_ranks(rec, counts, expect)
        rec["ok"] = True
        return rec

    # -- mesh_tree_1m_nemesis: the main path's tree under the nemesis ---
    rec = phase("mesh_tree_1m_nemesis", "nemesis", {
        k: ONE_PROCESS[k] for k in ("tree_nemesis", "tree_nemesis_delayed",
                                    "circulant_nemesis_accounted")},
        ("wm_fault_coins", "tree_halo_pack", "tree_halo_round"))
    for k, run in rec["runs"].items():
        run["halo"] = ranks[0]["nemesis"][k]["halo"]
        if not run["halo"] or run["collective_calls_per_round"].get(
                "all_gather"):
            raise AssertionError(f"mesh_tree_1m_nemesis {k}: not the halo "
                                 "path, or an all-gather a round")
    rec.update({"n": N_NODES, "n_values": W1_VALUES, "block":
                N_NODES // MESH_RANKS,
                "census_reference": {"broadcast/sharded-step-halo-wm-nem":
                                     {"collective-permute": 25,
                                      "all-reduce": 1}}})
    emit(rec)

    # -- mesh_delays ------------------------------------------------------
    rec = phase("mesh_delays", "delays", {
        k: ONE_PROCESS[k] for k in ("circulant_delayed",
                                    "circulant_edge_delayed",
                                    "circulant_edge_delayed_partitioned",
                                    "ring")},
        ("gather_or",))
    rec.update({"n": N_NODES, "ring_nodes": MESH_RING_NODES,
                "delay_values": [1, 3]})
    emit(rec)

    # -- mesh_gather_nemesis ----------------------------------------------
    want = ONE_PROCESS["random_regular_nemesis"]
    rec = phase("mesh_gather_nemesis", "gather",
                {"materialized": want, str(1 << 16): want},
                ("fault_coins", "faulted_gather_round"))
    rec.update({"n": N_NODES, "degree": DEGREE,
                "blocks": {k: ranks[0]["gather"][k]["block"]
                           for k in rec["runs"]},
                "census_reference": {"broadcast/sharded-step-gather-nem":
                                     {"all-gather": 2, "all-reduce": 1}}})
    for k, run in rec["runs"].items():
        if run["collective_calls_per_round"].get("ppermute"):
            raise AssertionError(f"mesh_gather_nemesis {k}: a ppermute")
    emit(rec)

    # -- mesh_counter -----------------------------------------------------
    names = [k for k in ONE_PROCESS if k.startswith("counter")]
    rec = phase("mesh_counter", "counter", {k: ONE_PROCESS[k]
                                            for k in names},
                ("counter_select", "counter_apply"),
                ("rounds", "kv", "msgs"))
    for k, run in rec["runs"].items():
        run["rank0_profile"] = ranks[0]["counter"][k]["profile"]
        run["cold_wall_ms"] = max(r["counter"][k]["cold_wall_s"]
                                  for r in ranks) * 1e3
        calls = run["collective_calls_per_round"]
        if set(calls) - {"all_reduce"}:
            raise AssertionError(f"mesh_counter {k}: {calls}, not "
                                 "all-reduces only")
    if not ranks[0]["counter"]["counter_16m_cas_wide"]["wide"]:
        raise AssertionError("mesh_counter: 2^24 nodes must take the wide "
                             "winner key")
    rec["census_reference"] = {"counter/sharded-step-wide":
                               {"all-reduce": 5},
                               "kvstore/sharded-cas-step":
                               {"all-reduce": 1}}
    emit(rec)
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from gossip_glomers_tpu_torch.harness import (checkers, frontier, fuzz,
                                                  membership, nemesis,
                                                  observe, serving)
    from gossip_glomers_tpu_torch.harness import txn as htxn
    from gossip_glomers_tpu_torch.parallel import dcn_worker, topology
    from gossip_glomers_tpu_torch.tpu_sim import (broadcast, checkpoint,
                                                  counter, echo, faults,
                                                  kafka, kernels, kvstore,
                                                  scenario, structured,
                                                  telemetry, timing, traffic,
                                                  txn, unique_ids)
    from gossip_glomers_tpu_torch.tpu_sim import membership as membership_ops

    device = torch.device("cuda")
    modules = (broadcast, timing)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    global OPS_PER_S
    OPS_PER_S = INT_LANES_PER_CLOCK * sms * float(clock.split()[0]) * 1e6
    emit({"phase": "card", "name_power_limit": smi, "sm_clock_max": clock,
          "sms": sms, "int_lanes_per_clock_per_sm": INT_LANES_PER_CLOCK,
          "int_ops_per_s": OPS_PER_S, "hbm_bytes_per_s": HBM_BYTES_PER_S})

    t0 = time.perf_counter()
    libs = kernels.build()
    for name in libs:
        kernels._lib(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {name: str(lib.relative_to(lib.parents[2]))
                        for name, lib in libs.items()},
          "ptxas": {name: [ln.strip() for ln in
                           lib.with_suffix(".log").read_text().splitlines()
                           if "registers" in ln or "Compiling entry" in ln]
                    for name, lib in libs.items()}})

    errs = check_kernels(kernels, structured, topology, device)
    errs.update(check_halo_kernels(kernels, device))
    times = time_kernels(kernels, structured, topology, device)
    times.update(time_halo_kernels(kernels, device))
    emit({"phase": "kernel_check", "tolerance": 0, "max_abs_err": errs,
          "shapes": [list(s) for s in CHECK_SHAPES + MAIN_SHAPES],
          "shift_edge_shapes": [list(s) for s in
                                shift_edges(kernels.SHIFT_TILE)],
          "shift_view_offsets": [0, 1],
          "gather_edge_shapes": [list(s) for s in gather_edges(
              kernels.gather_nodes_per_block)],
          "gather_view_offsets": [0, 1],
          "shift_modes": [m[0] for m in shift_modes(N_NODES, topology)],
          "tree_vec_ns": list(TREE_VEC_NS),
          "ring_shapes": [list(s) for s in
                          CHECK_SHAPES + RING_SHAPES + MAIN_SHAPES],
          "coin_dir_sets": [name for name, _ in coin_dir_sets(
              structured, topology, N_NODES)],
          "counter_ns": list(COUNTER_NS),
          "kafka_shapes": [list(x) for x in KAFKA_ODD_SHAPES
                           + KAFKA_PHASE_SHAPES],
          "kafka_shapes_past_memory": [
              list(x) for x in KAFKA_PHASE_SHAPES
              if kafka_past_memory(*x[:3])],
          "and_fold_shapes": [list(x) for x in serving_fold_shapes()],
          "prov_shapes": [list(x) for x in PROV_SHAPES],
          "prov_modes": list(PROV_MODES),
          "txn_cases": {"n": list(TXN_NS), "o": list(TXN_OS),
                        "k": list(TXN_KS), "active": list(TXN_ACTIVE),
                        "slots": TXN_CHECK_SLOTS,
                        "wrap": "issue * N past 2^31, colliding pairs"},
          "times": {k: {f"{w}x{n}": v for (w, n), v in t.items()}
                    for k, t in times.items()}})

    launches = Launches(kernels)
    tree_kw = {"branching": BRANCHING}
    w1_structured("w1_tree", "tree", tree_kw, BRANCHING + 1,
                  ("tree_flood_round", "tree_exchange", "col_popcount"),
                  modules, device, launches, want_rounds=13)
    w128_structured("w128_tree", "tree", lambda n: tree_kw, BRANCHING + 1,
                    ("tree_flood_round", "col_popcount"), modules, device,
                    launches, want_rounds=16)

    def circ_kw(n):
        return {"strides": topology.expander_strides(n, DEGREE, seed=0)}

    w1_structured("w1_circulant", "circulant", circ_kw(N_NODES), DEGREE,
                  ("shift_flood_round", "shift_exchange", "col_popcount",
                   "gather_flood_round", "col_popcount_nm"),
                  modules, device, launches,
                  gather_nbrs=topology.circulant(
                      N_NODES, circ_kw(N_NODES)["strides"]))
    w128_structured("w128_circulant", "circulant", circ_kw, DEGREE,
                    ("shift_flood_round", "col_popcount"), modules, device,
                    launches)
    gather_phases(modules, topology, device, launches)
    nemesis_phases(modules, faults, topology, device, launches)
    structured_fault_phases(modules, faults, structured, kernels, topology,
                            device, launches)
    delay_phases(modules, faults, structured, kernels, topology, device,
                 launches)
    small_floods(modules, device, launches)
    counter_phases(counter, faults, kernels, device, launches, smi)
    mesh_phases((broadcast, timing, topology, dcn_worker), device,
                launches, smi, times)
    ids_echo(unique_ids, echo, device, launches, smi)
    kafka_phases(kafka, nemesis, faults, kernels, device, launches, smi)
    nemesis_tree_1m_provenance((broadcast, nemesis, faults, topology,
                                kernels), device, launches, smi, times)
    nemesis_counter_128k_provenance(nemesis, faults, kernels, device,
                                    launches, smi)
    kafka_sweep_point_provenance(kafka, nemesis, faults, kernels, device,
                                 launches, smi)
    serving_pending = serving_phases(
        (serving, telemetry, traffic, kernels, faults), topology, structured,
        broadcast, device, launches, smi)
    txn_64k(txn, checkers, kernels, device, launches, smi, times)
    txn_nemesis_64k(txn, htxn, observe, faults, kvstore, kernels, device,
                    launches, smi)
    mesh_txn_serving_phase(htxn, faults, kvstore, launches, device, smi)
    flight_bundles(nemesis, serving, observe, faults, traffic, device,
                   launches, smi)
    scen = (broadcast, nemesis, scenario, telemetry, topology, faults,
            kernels, fuzz)
    scenario_broadcast_fuzz(scen, device, launches, smi, times)
    scenario_broadcast_256x1024(scen, device, launches, smi, times)
    scenario_looped_phases((scenario, fuzz, kernels), device, launches,
                           smi)
    frontier_rows = serving_batch_frontier(
        (scenario, serving, frontier, kernels), device, launches, smi)
    checkpoint_tree_1m((broadcast, structured, topology, faults, checkpoint),
                       device, launches, smi)
    resize_broadcast_full((membership, faults), device, launches, smi)
    resize_counter_1m((membership, faults, membership_ops, kvstore, traffic,
                       counter), device, launches, smi)
    resize_kafka_4k((membership, faults), device, launches, smi)
    frontier_grid_256((frontier, observe, checkers), device, launches, smi,
                      frontier_rows)
    fuzz_campaigns((fuzz, observe), device, launches, smi)
    mesh_provenance_batches_phase((htxn, observe, faults), launches, device,
                                  smi)
    finish_pending()
    finish_serving_twins(kernels, serving_pending)

    for name, count in launches.total.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 "main path")
    print(smi, flush=True)
    entries = []
    for name, (source, replaces, _) in KERNELS.items():
        shapes = times[name]
        big = max(shapes, key=lambda s: s[0] * s[1])
        entry = {"name": name, "route": "cuda", "source": CSRC + source,
                 "replaces": replaces, "launches": launches.total[name],
                 "launches_timed_trips": TRIP_LAUNCHES.get(name, 0),
                 "max_abs_err": errs[name], **shapes[big],
                 "library_ms": shapes[big].get("library_ms"),
                 "at": list(big)}
        if MAIN_SHAPES[0] in shapes and big != MAIN_SHAPES[0] \
                and not name.startswith("counter_"):
            entry["w1"] = shapes[MAIN_SHAPES[0]]
        elif len(shapes) > 1:   # wm_fault_coins (D, N), the counter
            # (1, N), Kafka (N, K)
            entry["also"] = {f"{w}x{n}": v for (w, n), v in shapes.items()
                             if (w, n) != big}
        if name == "counter_select":
            entry["partial"] = {f"{w}x{n}": v for (w, n), v in
                                times["counter_select_partial"].items()}
        if f"{name}_block" in times:
            entry["block"] = {f"{w}x{n}": v for (w, n), v in
                              times[f"{name}_block"].items()}
        if name.startswith("shift_") or name in MESH_PATH_KERNELS \
                or name in MESH_TXN_KERNELS:
            entry["launches_by_path"] = launches.split(name)
        entries.append(entry)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
