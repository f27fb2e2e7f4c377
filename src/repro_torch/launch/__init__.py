"""Entry points of the port: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.dryrun_rtac``, ``torchrun ... -m
repro_torch.launch.distributed_ac``; `mesh` builds the sharded path's
meshes and process world."""
