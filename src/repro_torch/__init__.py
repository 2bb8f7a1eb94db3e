"""PyTorch / CUDA port of the rate-matched CNN inference system.

A package of its own beside the JAX reference (``repro``): it imports
torch and numpy, never jax and nothing of ``repro``.  Layout follows the
reference: ``core`` (rate calculus, DSE, DAG planner, Hopper tiles),
``kernels`` (hand-written CUDA kernels for the paper's KPU, FCU and
depthwise units, each beside its plain PyTorch version) and ``models``
(graph builders, the graph executor and ``get_cnn_api``).
"""
