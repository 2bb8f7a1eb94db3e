"""Multi-device execution (the port's copy of the JAX package's
``distributed``): ``device_pipeline`` drives a placed stage pipeline with
the GPipe schedule, one CUDA stream per stage; ``pipeline_parallel``
holds the schedule's utilization bound."""
