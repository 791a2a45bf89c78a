"""Partitioned execution over a halo partition (port of
``thetis_tpu/parallel/``): ``partition`` / ``submesh`` (the tables),
``shard`` (the halo refresh and the reductions), ``sharded`` (serial
equations over a partition), ``assembled_sharded`` (the partitioned
assembled CN) and ``sharded3d`` (the partitioned 3D step)."""
