"""PyTorch / CUDA port of the rate-matched CNN inference system.

A package of its own beside the JAX reference (``repro``): it imports
torch and numpy, never jax and nothing of ``repro``.  Layout follows the
reference: ``core`` (rate calculus, DSE, DAG planner, Hopper tiles),
``kernels`` (hand-written CUDA kernels for the paper's KPU, FCU and
depthwise units and for blockwise attention, each beside its plain
PyTorch version), ``configs`` (the LM architectures), ``nn`` (the LM
layers), ``models`` (the CNN graphs and their executor, the LM, and
the front doors ``get_cnn_api`` / ``get_api``) and ``serving`` (the
token engine).
"""
