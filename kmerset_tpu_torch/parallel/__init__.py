"""The mesh of shards: the port's multi-device engine, in one process or
over a torch.distributed process group (mesh.py holds the Mesh, its
collectives and the shard programs; driver.py the host-layout entry
points, the routing gates and the group bring-up)."""
