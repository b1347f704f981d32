"""Distribution (port of ``repro.dist``): the mesh context, the sharding
rules, the collectives the sharded serving and training paths run, the
dry run's stand-in mesh, and the cost accounting of a recorded step
(``op_analysis``, the counterpart of ``hlo_analysis.analyze_hlo``).

The reference's ``dist/compat.py`` (a ``shard_map`` version shim) has no
counterpart: eager torch runs one process per rank and needs no shim."""
from . import collectives, context, op_analysis, sharding, standin  # noqa: F401
