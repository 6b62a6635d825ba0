"""The sharded pipeline over a mesh of devices (port of
``dynamicfusion_tpu.parallel``).

What is distributed: the TSDF volume, split on x into n slabs of D/n
planes, each shard fusing and raycasting its own slab (the slab raycast
with a halo of neighbour planes exchanged once a raycast, the slab brick
fusion with no exchange at all); and the warp solve's surface points,
split into n parts whose data terms each shard assembles (summed once a
relinearization for the dense solves, or kept per shard in the
distributed PCG, whose every matvec is one (6N,) psum). What stays
replicated: the depth frame and its preprocessing, ICP, the warp field
(nodes, their transforms and edge graph), the pose and the model maps;
replicated work runs once a process on its first shard's device.

Modules: ``mesh`` (the shards, their devices and collectives),
``sharded`` (the sharded state and step), ``sharded_raycast``,
``sharded_fusion``, ``distributed_gn`` (the sharded assembly and the
distributed PCG solve) and ``multihost`` (several processes over one
mesh through ``torch.distributed``).
"""
