"""Distributed-execution utilities of the port: gradient compression with
error feedback (:mod:`.compression`), the sharding rules of the production
meshes (:mod:`.sharding`) and the elastic-mesh helpers (:mod:`.elastic`),
as in the JAX package's ``dist``. Importing it touches no device."""
