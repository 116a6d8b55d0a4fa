"""Distributed-execution utilities of the port: gradient compression with
error feedback (:mod:`.compression`). The sharding rules and the elastic
mesh helpers of the JAX package's ``dist`` come with the launch slice."""
