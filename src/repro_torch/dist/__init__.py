"""Distribution (port of ``repro.dist``): the mesh context, the sharding
rules and the collectives the sharded serving path runs.

The reference's ``dist/compat.py`` (a ``shard_map`` version shim) has no
counterpart: eager torch runs one process per rank and needs no shim.
Its ``hlo_analysis.py`` (HLO cost accounting for the dry run) is queued
with the dry run."""
from . import collectives, context, sharding  # noqa: F401
