"""PyTorch/CUDA port of the Compass mapping-space exploration system.

A second package beside the JAX reference package: the same mapping search
(BO over hardware, GA over mappings, the analytical evaluation engine),
with the population evaluator in torch and its timing recurrence in
hand-written CUDA kernels for Hopper (``kernels/csrc``). Host-side control
logic (GA operators, BO, graph building, cost tables, scheduler rollouts)
is numpy, copied from the reference so that its seeded random streams and
results carry over. Entry points run on a CUDA device unless the caller
passes ``device="cpu"``.
"""
