"""PyTorch / CUDA port of gossip_glomers_tpu's broadcast simulator.

The words-major tree flood (``tpu_sim.broadcast.BroadcastSim`` with the
tree exchange of ``tpu_sim.structured``) runs on an NVIDIA GPU through
the hand-written kernels of ``tpu_sim.kernels``.  The JAX package
``gossip_glomers_tpu`` is the reference this port is held against; the
port imports nothing of it.
"""
