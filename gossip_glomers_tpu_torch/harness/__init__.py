"""Runners and checkers over the port's simulators (the harness of
gossip_glomers_tpu, in part: the serving runner and its checkers)."""
