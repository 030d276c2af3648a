"""Runners and checkers over the port's simulators (the harness of
gossip_glomers_tpu, in part: the serving and nemesis runners, their
checkers and the host side of run observation)."""
