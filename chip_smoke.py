#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (gossip_glomers_tpu_torch) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and the CUDA toolkit (``nvcc``); it builds the port's kernels
from ``gossip_glomers_tpu_torch/csrc/`` into ``build/`` and drives the main
path, the words-major broadcast flood on a 1,048,576-node 4-ary tree:

1. ``build``: nvcc build of the kernels, with its seconds.
2. ``kernel_check``: each kernel against its plain PyTorch version on the
   card, bit for bit (tolerance 0: bitsets and counts), at small shapes
   and at the main path's shapes, and each one's median time there.
3. ``w1_tree``: 32 values (W = 1 word per node), the fixed-trip flood to
   ``discover_rounds`` timed with CUDA events, then the accounted
   while-converge run with the server ledger on; both held against the
   port's plain CPU path at the same size.
4. ``w128_tree``: 4,096 values (W = 128), the fixed-trip flood timed the
   same way; its unwrapped closed-form ledger ``msgs64``; a CPU
   cross-check of the same path at 65,536 nodes.

Each phase prints one JSON line.  Kernel launch counts are zeroed just
before each main-path phase and read just after.  Then come the card's
name and power limit (``nvidia-smi``), one ``{"kernels": [...]}`` line and
last ``{"ok": true, "device": {...}}``.  Any failure raises: the script
then exits non-zero and prints no result.  Without a CUDA card it exits
with status 2.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

N_NODES = 1 << 20
BRANCHING = 4
W1_VALUES = 32
W128_VALUES = 4096
CHECK_NODES = 1 << 16        # the W = 128 CPU cross-check size
CHECK_SHAPES = [(w, n) for w in (1, 8, 32, 128)
                for n in (1, 5, 4097, (1 << 16) + 3)]
MAIN_SHAPES = [(1, N_NODES), (W128_VALUES // 32, N_NODES)]
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
OPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
SOURCE = "gossip_glomers_tpu_torch/csrc/tree_flood.cu"
# the fused 4-ary tree inbox Pallas kernel (never lowered by Mosaic)
PALLAS_KERNEL = "benchmarks/pallas_tree_probe.py:74"


def emit(obj: dict) -> None:
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


def device_ms(fn, calls: int = 1) -> float:
    """Mean device time (ms) of one kernel launch during ``calls`` calls
    of ``fn``, from torch.profiler's CUDA activity.  Raises if the
    profiler saw no device work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        raise AssertionError("the profiler recorded no device time")
    return sum(spans) / len(spans) / 1e3


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def bound(w: int, n: int, bitsets: float, extra_bytes: int,
          ops_per_word: int) -> tuple[float, str]:
    """(least ms, "bytes" | "operations") for work that moves ``bitsets``
    (W, N) int32 bitsets plus ``extra_bytes`` and does ``ops_per_word``
    integer operations per word."""
    by = (bitsets * w * n * 4 + extra_bytes) / HBM_BYTES_PER_S * 1e3
    op = ops_per_word * w * n / OPS_PER_S * 1e3
    return (by, "bytes") if by >= op else (op, "operations")


def check_kernels(kernels, device) -> dict:
    """Every kernel against its plain version on the card; returns the
    per-kernel max |kernel - plain| over all shapes (must be 0)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(0)

    def bits(w, n):
        return torch.randint(-(1 << 31), 1 << 31, (w, n), dtype=torch.int32,
                             device=device, generator=gen)

    err = {"tree_exchange": 0, "tree_flood_round": 0, "col_popcount": 0}
    for w, n in CHECK_SHAPES + MAIN_SHAPES:
        rec, fr = bits(w, n), bits(w, n)
        err["tree_exchange"] = max(err["tree_exchange"], max_abs_err(
            kernels.tree_exchange(fr, BRANCHING),
            kernels.tree_exchange_plain(fr, BRANCHING)))
        rk, nk = rec.clone(), torch.empty_like(fr)
        kernels.tree_flood_round(rk, fr, nk, BRANCHING)
        rp, np_ = rec.clone(), torch.empty_like(fr)
        kernels.tree_flood_round_plain(rp, fr, np_, BRANCHING)
        err["tree_flood_round"] = max(err["tree_flood_round"],
                                      max_abs_err(rk, rp),
                                      max_abs_err(nk, np_))
        err["col_popcount"] = max(err["col_popcount"], max_abs_err(
            kernels.col_popcount(rec), kernels.col_popcount_plain(rec)))
        torch.cuda.synchronize()
    bad = {k: v for k, v in err.items() if v != 0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"(tolerance 0): {bad}")
    return err


def time_kernels(kernels, device) -> dict:
    """{kernel: {(w, n): {ms, device_ms, plain_ms, bound_ms, bound_by}}}
    at the main path's shapes.  ``ms`` is the CUDA-event time of
    back-to-back calls (the host's launch path included), ``device_ms``
    the profiler's device time of one launch."""
    import torch

    gen = torch.Generator(device=device).manual_seed(1)
    k = BRANCHING
    out = {"tree_exchange": {}, "tree_flood_round": {}, "col_popcount": {}}
    for w, n in MAIN_SHAPES:
        rec = torch.randint(-(1 << 31), 1 << 31, (w, n), dtype=torch.int32,
                            device=device, generator=gen)
        fr = torch.randint(-(1 << 31), 1 << 31, (w, n), dtype=torch.int32,
                           device=device, generator=gen)
        nxt = torch.empty_like(fr)
        runs = {
            "tree_exchange": (
                lambda: kernels.tree_exchange(fr, k),
                lambda: kernels.tree_exchange_plain(fr, k),
                bound(w, n, 2, 0, k)),
            # received is updated in place: every call does the same work
            "tree_flood_round": (
                lambda: kernels.tree_flood_round(rec, fr, nxt, k),
                lambda: kernels.tree_flood_round_plain(rec, fr, nxt, k),
                bound(w, n, 4, 0, k + 3)),
            "col_popcount": (
                lambda: kernels.col_popcount(fr),
                lambda: kernels.col_popcount_plain(fr),
                bound(w, n, 1, 4 * n, 2)),
        }
        for name, (kern, plain, (b_ms, b_by)) in runs.items():
            out[name][(w, n)] = {"ms": cuda_ms(kern),
                                 "device_ms": device_ms(kern, calls=10),
                                 "plain_ms": cuda_ms(plain, inner=3),
                                 "bound_ms": b_ms, "bound_by": b_by}
        del rec, fr, nxt
        torch.cuda.empty_cache()
    return out


def same_state(a, b) -> bool:
    return (a.t == b.t and int(a.msgs) == int(b.msgs)
            and bool((a.received.cpu() == b.received.cpu()).all())
            and (a.srv_msgs is None) == (b.srv_msgs is None)
            and (a.srv_msgs is None or int(a.srv_msgs) == int(b.srv_msgs)))


def fixed_run(timing, broadcast, n: int, n_values: int, device: str):
    sim = timing.structured_sim("tree", n, n_values, branching=BRANCHING,
                                device=device)
    rounds = timing.discover_rounds("tree", n, n_values, branching=BRANCHING)
    state0, target = sim.stage(broadcast.make_inject(n, n_values))
    final = sim.run_staged_fixed(state0, rounds)
    if not sim.converged(final, target):
        raise AssertionError(f"{device} fixed run at n={n} did not converge")
    return final


def timed_phase(name: str, n_values: int, want_rounds: int, timing,
                broadcast, device) -> tuple[dict, object]:
    """The timed fixed-trip flood of one main-path entry; returns its
    JSON record and final state."""
    import torch

    res = timing.bench_structured(
        N_NODES, [(name, "tree", n_values, {"branching": BRANCHING},
                   BRANCHING + 1)], device=device)[name]
    state = res["_state"]
    if res["rounds"] != want_rounds:
        raise AssertionError(f"{name}: {res['rounds']} rounds, expected "
                             f"{want_rounds}")
    if state.t != res["rounds"]:
        raise AssertionError(f"{name}: t = {state.t}")
    if int(state.msgs) != res["msgs64"] % (1 << 32):
        raise AssertionError(f"{name}: msgs {int(state.msgs)} is not the "
                             f"closed form {res['msgs64']} mod 2^32")
    # one more run of the loop under the profiler: the device's busy time
    # against the timed wall gives its idle share
    sim = timing.structured_sim("tree", N_NODES, n_values,
                                branching=BRANCHING, device=device)
    loop_fn, _ = sim.build_fixed(res["rounds"], donate=True)
    state0, _ = sim.stage(broadcast.make_inject(N_NODES, n_values))
    busy_ms = device_ms(lambda: loop_fn(state0.received,
                                        state0.frontier)) * res["rounds"]
    del sim, state0
    torch.cuda.synchronize()
    record = {"phase": name, "n": N_NODES, "n_values": n_values,
              "rounds": res["rounds"], "wall_ms": res["wall_s"] * 1e3,
              "samples_ms": [s * 1e3 for s in res["samples_s"]],
              "ms_per_round": res["ms_per_round"],
              "gbytes_per_s_lb": res["gbytes_per_s_lb"],
              "device_busy_ms": busy_ms,
              "device_idle_share": 1 - busy_ms / (res["wall_s"] * 1e3),
              "msgs": int(state.msgs), "msgs64": res["msgs64"]}
    return record, state


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from gossip_glomers_tpu_torch.tpu_sim import broadcast, kernels, timing

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()

    t0 = time.perf_counter()
    lib = kernels.build()
    kernels._lib()
    log = lib.with_suffix(".log").read_text().splitlines()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.relative_to(lib.parents[2])),
          "ptxas": [ln.strip() for ln in log if "registers" in ln
                    or "Compiling entry" in ln]})

    errs = check_kernels(kernels, device)
    times = time_kernels(kernels, device)
    emit({"phase": "kernel_check", "tolerance": 0, "max_abs_err": errs,
          "shapes": [list(s) for s in CHECK_SHAPES + MAIN_SHAPES],
          "times": {k: {f"{w}x{n}": v for (w, n), v in t.items()}
                    for k, t in times.items()}})

    # -- w1_tree: timed flood, then the accounted run ------------------
    launches = {k: 0 for k in kernels.LAUNCHES}
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    rec, state = timed_phase("w1_tree", W1_VALUES, 13, timing, broadcast,
                             device)
    acct = timing.structured_sim("tree", N_NODES, W1_VALUES,
                                 branching=BRANCHING, srv_ledger=True,
                                 device=device)
    inject = broadcast.make_inject(N_NODES, W1_VALUES)
    state_a, rounds_a = acct.run_fused(inject)
    srv_msgs = acct.server_msgs(state_a)
    torch.cuda.synchronize()
    rec["launches"] = dict(kernels.LAUNCHES)
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    for k, v in kernels.LAUNCHES.items():
        launches[k] += v
    if rounds_a != rec["rounds"] or int(state_a.msgs) != rec["msgs"]:
        raise AssertionError(f"accounted run: {rounds_a} rounds, msgs "
                             f"{int(state_a.msgs)}; fixed run: "
                             f"{rec['rounds']}, {rec['msgs']}")
    # the port's plain CPU path at the same size, bit for bit
    cpu_fixed = fixed_run(timing, broadcast, N_NODES, W1_VALUES, "cpu")
    cpu_acct = timing.structured_sim("tree", N_NODES, W1_VALUES,
                                     branching=BRANCHING, srv_ledger=True,
                                     device="cpu")
    cpu_state_a, cpu_rounds_a = cpu_acct.run_fused(inject)
    if not (same_state(state, cpu_fixed) and cpu_rounds_a == rounds_a
            and same_state(state_a, cpu_state_a)):
        raise AssertionError("w1_tree: GPU run differs from the CPU path")
    rec.update({"srv_msgs": srv_msgs, "accounted_rounds": rounds_a,
                "cpu_match": True})
    emit(rec)
    del state, state_a, acct, cpu_fixed, cpu_state_a
    torch.cuda.empty_cache()

    # -- w128_tree: timed flood at 4,096 values ------------------------
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    rec, state = timed_phase("w128_tree", W128_VALUES, 16, timing,
                             broadcast, device)
    torch.cuda.synchronize()
    rec["launches"] = dict(kernels.LAUNCHES)
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    for k, v in kernels.LAUNCHES.items():
        launches[k] += v
    del state
    torch.cuda.empty_cache()
    gpu_small = fixed_run(timing, broadcast, CHECK_NODES, W128_VALUES,
                          "cuda")
    cpu_small = fixed_run(timing, broadcast, CHECK_NODES, W128_VALUES, "cpu")
    if not same_state(gpu_small, cpu_small):
        raise AssertionError("w128_tree: GPU run differs from the CPU path "
                             f"at n={CHECK_NODES}")
    rec.update({"cpu_check_n": CHECK_NODES, "cpu_match": True})
    emit(rec)

    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 "main path")
    print(smi, flush=True)
    big = MAIN_SHAPES[1]
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": (PALLAS_KERNEL if name != "col_popcount" else
                      "gossip_glomers_tpu/tpu_sim/broadcast.py:305"),
         "launches": launches[name], "max_abs_err": errs[name],
         **times[name][big], "library_ms": None, "at": list(big),
         "w1": times[name][MAIN_SHAPES[0]]}
        for name in kernels.LAUNCHES]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
