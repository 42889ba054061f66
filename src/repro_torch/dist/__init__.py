"""Distributed pieces of the port: the mesh (``ctx``, ``collectives``,
``sharding``, ``tp``), the hash-prefix sharded table, the train loop's
fault-tolerance policies and gradient compression."""
