"""Runners and checkers over the port's simulators (the harness of
gossip_glomers_tpu, in part): the nemesis, serving and txn runners
(:mod:`.nemesis`, :mod:`.serving`, :mod:`.txn`), their checkers
(:mod:`.checkers`), run observation and the flight recorder
(:mod:`.observe`), elastic-resize campaigns (:mod:`.membership`), the
serving frontier and its coverage map (:mod:`.frontier`) and the
fault-space fuzzer (:mod:`.fuzz`).  Import them by name (``from
gossip_glomers_tpu_torch.harness import fuzz``); ``import *`` loads
them all."""

__all__ = ["checkers", "frontier", "fuzz", "membership", "nemesis",
           "observe", "serving", "txn"]
