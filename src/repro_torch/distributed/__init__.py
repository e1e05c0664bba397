"""Distributed substrate of the port: logical-axis sharding rules and
DTensor layouts (``sharding``), explicit collectives and the tensor-parallel
autograd Functions (``collectives``), GPipe pipelining over a process
group (``pipeline``), and fault tolerance (the supervisor and elastic
restore). Meshes, cell specs, the dry run and the data x tensor-parallel
train step live in ``repro_torch.launch`` (``mesh``, ``specs``,
``dryrun``, ``steps``)."""
