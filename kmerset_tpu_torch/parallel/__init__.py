"""The mesh of shards: the port's multi-device engine (mesh.py holds the
Mesh, its collectives and the shard programs; driver.py the host-layout
entry points and the routing gates)."""
