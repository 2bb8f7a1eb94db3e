"""Multi-device execution (the port's copy of the JAX package's
``distributed``): ``sharding`` (partition specs, DTensor placements,
``constrain``), ``collectives`` (compressed all-reduce),
``fault_tolerance`` (watchdog, heartbeat, elastic re-mesh),
``pipeline_parallel`` (the circular pipeline over a mesh's stage axis)
and ``device_pipeline`` (a placed stage pipeline with the GPipe schedule,
one CUDA stream per stage)."""
