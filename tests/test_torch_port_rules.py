"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
it never drops quietly to the CPU, and its kernel wrappers import (and
run their plain versions) on a machine without a CUDA toolkit."""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from gossip_glomers_tpu_torch.parallel.topology import (to_padded_neighbors,
                                                        tree)
from gossip_glomers_tpu_torch.tpu_sim import broadcast, kernels, structured
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


def test_unported_modes_raise():
    nbrs = to_padded_neighbors(tree(8))
    ex = structured.make_exchange("tree", 8)
    with pytest.raises(NotImplementedError, match="gather"):
        broadcast.BroadcastSim(nbrs, n_values=4, device="cpu")
    for mode in ("mesh", "parts", "faulted", "delays", "delayed",
                 "edge_delayed", "fault_plan", "nemesis", "union_block",
                 "dcn_mode"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            broadcast.BroadcastSim(nbrs, n_values=4, exchange=ex,
                                   device="cpu", **{mode: object()})
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


def test_wrappers_import_and_run_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", "")
    mod = importlib.reload(kernels)
    assert mod._lib_handle is None          # nothing built at import
    x = torch.from_numpy(np.arange(12, dtype=np.int32).reshape(3, 4))
    assert torch.equal(mod.col_popcount(x), mod.col_popcount_plain(x))
    # a CUDA call would build first; without a toolkit that raises
    monkeypatch.setattr(mod, "_find_nvcc", lambda: None)
    monkeypatch.setattr(mod, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        mod.build()
