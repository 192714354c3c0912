"""Sharding: the port's mesh and rules, sharded tensors, collectives."""
