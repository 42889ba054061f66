"""Distributed pieces of the port: the hash-prefix sharded table."""
